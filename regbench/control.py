"""The readings that set the limits of `correct`: the control and the faults.

    python3 regbench/control.py --workload <name> --seeds 11,12,13 --seconds <s> --what <what>

`--what` is one of:
  sound           the program as the benchmark runs it (the lower readings);
  control         the reference in the program's place, computed in TF32
                  (regbench/reference/<reference>.py::control_answer);
  state_unchanged the program with every ICP returning its starting pose;
  half_batch      register_many registering the first half of each batch
                  only, each left-out pair answered by the mean of the kept
                  pairs' transforms and metrics (batch cells);
  one_lane        register_many returning the first pair of each batch at
                  its starting pose (the identity), measured there by the
                  program's own metric (batch cells);
  half_mean       the program's metric taking its mean over the first half
                  of each aligned source's valid points;
  answer_altered  the program's metric scaled by 1 + 1e-3 where it is made.

Each seed is one run of the cell (regbench/harness.py::run, its window of
--seconds and the reference's check) in this process; one JSON line a seed
gives its compared numbers, `correct`, `failed` and `over_bar_pairs`. The
benchmark's own runs run none of this. regbench/tests/test_regbench_control.py
drives the same at a small size on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from regbench import harness  # noqa: E402
from regbench.entries import Answer  # noqa: E402

WHATS = ("sound", "control", "state_unchanged", "half_batch", "one_lane", "half_mean", "answer_altered")


def control_call(spec, device):
    """The control as the cell's call: each pair's answer from the reference
    in TF32."""
    ref = importlib.import_module(f"regbench.reference.{spec['config']['reference']}")
    ingest = spec["config"]["ingest"]
    return lambda pairs, timer: [Answer(*ref.control_answer(p, ingest, device)) for p in pairs]


@contextlib.contextmanager
def _patched(module, name, make):
    old = getattr(module, name)
    setattr(module, name, make(old))
    try:
        yield
    finally:
        setattr(module, name, old)


def _metric_modules():
    return [importlib.import_module("kss_icp_torch.metrics"), importlib.import_module("kss_icp_torch.parallel.batch")]


@contextlib.contextmanager
def fault(what: str):
    """The program broken underneath, for the length of the block."""
    if what == "state_unchanged":
        kss = importlib.import_module("kss_icp_torch.models.kss_icp")

        def make(icp):
            def unchanged(*args, **kwargs):
                if "params" in kwargs:
                    kwargs["params"] = kwargs["params"]._replace(max_iterations=0)
                else:
                    args = args[:4] + (args[4]._replace(max_iterations=0),) + args[5:]
                return icp(*args, **kwargs)
            return unchanged

        with _patched(kss, "icp", make):
            yield
        return
    if what in ("half_batch", "one_lane"):
        batch = importlib.import_module("kss_icp_torch.parallel.batch")
        with _patched(batch, "register_many", _half_batch if what == "half_batch" else _one_lane):
            yield
        return
    if what in ("half_mean", "answer_altered"):
        def make(measure):
            def broken(aligned, aligned_mask, target, target_mask):
                if what == "half_mean":
                    rank = aligned_mask.long().cumsum(dim=-1)
                    aligned_mask = aligned_mask & (rank <= (aligned_mask.sum(dim=-1, keepdim=True) + 1) // 2)
                    return measure(aligned, aligned_mask, target, target_mask)
                out = measure(aligned, aligned_mask, target, target_mask)
                return {k: v * (1 + 1e-3) ** (2 if k == "mse" else 1) for k, v in out.items()}
            return broken

        with contextlib.ExitStack() as stack:
            for m in _metric_modules():
                stack.enter_context(_patched(m, "registration_measure_padded", make))
            yield
        return
    if what not in ("sound", "control"):
        raise ValueError(f"unknown fault {what!r}")
    yield


def _half_batch(register_many):
    def broken(pairs, *args, **kwargs):
        n, h = len(pairs), (len(pairs) + 1) // 2
        res, m = register_many(pairs[:h], *args, **kwargs)

        def fill(x):
            rest = x.mean(axis=0, keepdims=True) if isinstance(x, np.ndarray) else x.mean(dim=0, keepdim=True)
            reps = (n - h,) + (1,) * (x.ndim - 1)
            return np.concatenate([x, np.tile(rest, reps)]) if isinstance(x, np.ndarray) else \
                torch.cat([x, rest.repeat(*reps)])

        tr = res.transform
        return (res._replace(transform=tr._replace(scale=fill(tr.scale), rotation=fill(tr.rotation),
                                                   translation=fill(tr.translation))),
                {k: fill(v) for k, v in m.items()})
    return broken


def _one_lane(register_many):
    def broken(pairs, cfg, *args, full_pad=8192, device="cuda", **kwargs):
        res, m = register_many(pairs, cfg, *args, full_pad=full_pad, device=device, **kwargs)
        metrics = importlib.import_module("kss_icp_torch.metrics")

        def padded(x):
            x = torch.as_tensor(np.asarray(x, np.float32)[:full_pad])
            pts = torch.zeros((1, full_pad, 3)).index_copy(1, torch.arange(len(x)), x[None])
            return pts.to(device), (torch.arange(full_pad) < len(x))[None].to(device)

        (sp, sm), (tp, tm) = padded(pairs[0][0]), padded(pairs[0][1])
        at_start = metrics.registration_measure_padded(sp, sm, tp, tm)
        tr = res.transform
        scale, rot, trans = tr.scale.clone(), tr.rotation.clone(), tr.translation.clone()
        scale[0], rot[0], trans[0] = 1.0, torch.eye(3, device=rot.device, dtype=rot.dtype), 0.0
        m = {k: v.copy() for k, v in m.items()}
        for k in m:
            m[k][0] = float(at_start[k][0])
        return res._replace(transform=tr._replace(scale=scale, rotation=rot, translation=trans)), m
    return broken


def reading(workload, seed, seconds, what, device=None, spec=None) -> dict:
    """One run of the cell with `what` in the program's place: its compared
    numbers, `correct`, `failed` and `over_bar_pairs`."""
    with fault(what):
        r = harness.run(workload, seed, seconds, False, device=device, spec=spec,
                        call_of=control_call if what == "control" else None)
    return {"workload": workload, "seed": seed, "what": what, "correct": r["correct"], "failed": r["failed"],
            "over_bar_pairs": r["over_bar_pairs"],
            "attempted": r["attempted"], "compared": r["compared"], "device": r["device"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--what", choices=WHATS, required=True)
    args = p.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(reading(args.workload, seed, args.seconds, args.what)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
