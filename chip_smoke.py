#!/usr/bin/env python3
"""Smoke run of the PyTorch port (kss_icp_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):
  1. device: require CUDA; print the card's name and power limit
     (nvidia-smi) and the torch / CUDA versions;
  2. build: compile kss_icp_torch/csrc/*.cu with nvcc and print the time
     and the ptxas register / shared-memory report;
  3. kernels: run each kernel and its plain PyTorch version on the card on
     the same inputs at the main path's shapes, compare them (indices
     identical, d² within rtol 1e-6, the field within rtol 2e-5) and time
     both with CUDA events;
  4. end to end: the 25 remesh fixture pairs through register_pair ->
     apply_similarity -> registration_measure at DEFAULT_CONFIG and at the
     bench config, both with auto_escalate=False; every kernel's launch count
     must be above 0 and every pair's RMSE within the JAX CPU value + 0.006
     (fixtures/torch_port_expected.json);
  5. one JSON line with each kernel's numbers, then the result line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Imports nothing of JAX and nothing of kss_icp_tpu.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
FIXTURES = REPO / "fixtures"
RMSE_BAND = 0.006
# bench.py:110-112 (bench_config), restated because bench.py needs jax.
BENCH_KNOBS = dict(max_candidates=6, coarse_points=512, coarse_target_points=512,
                   refine_candidates=2, refine_tier_iterations=12, refine_max_iterations=16)


class SmokeError(RuntimeError):
    pass


def log(*a) -> None:
    print(*a, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cloud(rng: np.random.Generator, n: int) -> np.ndarray:
    """Points on a wavy surface (tests/helpers.py::random_cloud)."""
    u = rng.uniform(-1, 1, size=(n,))
    v = rng.uniform(-1, 1, size=(n,))
    return np.stack([u, v, 0.3 * np.sin(3 * u) * np.cos(2 * v)], axis=-1).astype(np.float32)


def time_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernels(torch, dev) -> dict:
    from kss_icp_torch.core.transforms import euler_xyz_matrix
    from kss_icp_torch.models.coarse import rotation_grid
    from kss_icp_torch.ops.coarse_cuda import field_ave, field_ave_plain
    from kss_icp_torch.ops.nn_cuda import nn1, nn1_plain
    from kss_icp_torch.ops.resample import farthest_point_sampling
    from kss_icp_torch.ops.resample_cuda import fps

    rng = np.random.default_rng(0)
    out = {}

    def t(x):
        return torch.as_tensor(x, device=dev)

    cases = []
    for lanes, q_n, r_n, label in ((32, 512, 2048, "screen ICP"), (4, 2048, 2048, "refine ICP"),
                                   (1, 65536, 65536, "K4 metric regime")):
        query = t(np.stack([cloud(rng, q_n) for _ in range(lanes)]))
        ref = t(cloud(rng, r_n)[None])
        mask = torch.ones((1, r_n), dtype=torch.bool, device=dev)
        mask[0, r_n - r_n // 40:] = False  # a padded tail, as 2000 of 2048
        d2k, ik = nn1(query, ref, mask)
        d2p, ip = nn1_plain(query, ref, mask)
        torch.cuda.synchronize()
        require(torch.equal(ik, ip), f"nn1 {label}: indices differ at {int((ik != ip).sum())} queries")
        require(torch.allclose(d2k, d2p, rtol=1e-6, atol=0.0), f"nn1 {label}: d2 differs beyond rtol 1e-6")
        err = float((d2k - d2p).abs().max())
        reps = 3 if q_n * r_n > 1e9 else 20
        ms = time_ms(torch, lambda: nn1(query, ref, mask), reps)
        plain_ms = time_ms(torch, lambda: nn1_plain(query, ref, mask), reps)
        cases.append({"shape": f"{lanes}x{q_n}x{r_n}", "label": label, "ms": ms, "plain_ms": plain_ms,
                      "max_abs_err": err})
        log(f"  nn1 {lanes}x{q_n}x{r_n} ({label}): indices identical, max|d2 err| {err:.3g}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    out["nn1"] = dict(cases[0], cases=cases, source="kss_icp_torch/csrc/nn.cu",
                      replaces="kss_icp_tpu/ops/nn_pallas.py:118",
                      also_replaces="kss_icp_tpu/ops/nn_pallas.py:183")

    b, p_n, s = 2, 8192, 2048
    pts = t(np.stack([cloud(rng, p_n) for _ in range(b)]))
    pmask = torch.ones((b, p_n), dtype=torch.bool, device=dev)
    pmask[0, 8000:] = False
    pmask[1, 6201:] = False
    ik, smk = fps(pts, pmask, s)
    ip, smp = farthest_point_sampling(pts, pmask, s)
    torch.cuda.synchronize()
    require(torch.equal(ik, ip) and torch.equal(smk, smp),
            f"fps: indices differ at {int((ik != ip).sum())} of {b * s} picks")
    ms = time_ms(torch, lambda: fps(pts, pmask, s), 5)
    plain_ms = time_ms(torch, lambda: farthest_point_sampling(pts, pmask, s), 2)
    log(f"  fps B={b} P={p_n} S={s}: indices identical; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    out["fps"] = {"shape": f"{b}x{p_n}->{s}", "ms": ms, "plain_ms": plain_ms, "max_abs_err": 0.0,
                  "source": "kss_icp_torch/csrc/fps.cu", "replaces": "kss_icp_tpu/ops/resample_pallas.py:102"}

    c_steps, p_n = 8, 2048
    src, tgt = t(cloud(rng, p_n)), t(cloud(rng, p_n))
    smask = torch.arange(p_n, device=dev) < 2000
    tmask = torch.arange(p_n, device=dev) < 1900
    rots = euler_xyz_matrix(rotation_grid(c_steps, 6.3, dev))
    fk = field_ave(src, smask, tgt, tmask, rots)
    fp = field_ave_plain(src, smask, tgt, tmask, rots)
    torch.cuda.synchronize()
    require(torch.allclose(fk, fp, rtol=2e-5, atol=0.0), "field_ave: differs beyond rtol 2e-5")
    err = float((fk - fp).abs().max())
    ms = time_ms(torch, lambda: field_ave(src, smask, tgt, tmask, rots), 10)
    plain_ms = time_ms(torch, lambda: field_ave_plain(src, smask, tgt, tmask, rots), 3)
    log(f"  field_ave C={rots.shape[0]} P={p_n} T={p_n}: max|err| {err:.3g}; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    out["field_ave"] = {"shape": f"{rots.shape[0]}x{p_n}x{p_n}", "ms": ms, "plain_ms": plain_ms,
                        "max_abs_err": err, "source": "kss_icp_torch/csrc/field.cu",
                        "replaces": "kss_icp_tpu/ops/coarse_pallas.py:201"}
    return out


def load_pairs():
    meta = json.loads((FIXTURES / "remesh_transfer.json").read_text())
    with np.load(FIXTURES / "remesh_transfer.npz") as z:
        return [(r["name"], np.asarray(z[r["name"] + "_src"], np.float32),
                 np.asarray(z[r["name"] + "_tgt"], np.float32)) for r in meta]


def phase_end_to_end(torch, dev, cfg, expected: dict, label: str, pairs, counters: dict) -> dict:
    import kss_icp_torch as kt

    stages = defaultdict(float)

    @contextlib.contextmanager
    def stage(name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        stages[name] += time.perf_counter() - t0

    def one(src, tgt, timer=None):
        res = kt.register_pair(src, tgt, cfg, device=dev, timer=timer)
        with (timer or (lambda _: contextlib.nullcontext()))("metric"):
            aligned = kt.apply_similarity(res.transform, torch.as_tensor(src, device=dev))
            m = kt.registration_measure(aligned, tgt, device=dev)
        return res, m, aligned

    one(pairs[0][1], pairs[0][2])  # warm-up: library handles, cuSOLVER, allocator
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    rows, failures, total = [], [], 0.0
    for name, src, tgt in pairs:
        t0 = time.perf_counter()
        res, m, aligned = one(src, tgt, stage)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        total += dt
        exp = expected[name]
        ok = (np.isfinite(m["rmse"]) and tuple(aligned.shape) == src.shape
              and bool(torch.isfinite(aligned).all()) and m["rmse"] <= exp["rmse"] + RMSE_BAND)
        rows.append({"name": name, "rmse": m["rmse"], "jax_rmse": exp["rmse"],
                     "cand": int(res.chosen_candidate), "jax_cand": exp["chosen_candidate"],
                     "iters": int(res.icp_iterations), "jax_iters": exp["icp_iterations"],
                     "hit_cap": bool(res.refine_hit_cap), "s": dt})
        log(f"  [{label}] {name}: rmse {m['rmse']:.6f} (jax {exp['rmse']:.6f}) cand {rows[-1]['cand']} "
            f"(jax {rows[-1]['jax_cand']}) iters {rows[-1]['iters']} (jax {rows[-1]['jax_iters']}) "
            f"{dt * 1e3:.1f} ms {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(name)
    require(not failures, f"{label}: pairs outside JAX RMSE + {RMSE_BAND}: {failures}")
    same_cand = sum(r["cand"] == r["jax_cand"] for r in rows)
    log(f"  [{label}] {len(pairs)} pairs in {total:.3f} s: {len(pairs) / total:.3f} pairs/s "
        f"(host clock, stage syncs included); same candidate as JAX on {same_cand}/{len(pairs)}")
    log(f"  [{label}] stage seconds over all pairs: " +
        ", ".join(f"{k} {v:.4f}" for k, v in stages.items()))
    return {"pairs_per_s": len(pairs) / total, "seconds": total, "stages": dict(stages), "rows": rows}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SmokeError("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    import kss_icp_torch  # noqa: F401  (fails where the repository is absent)
    from kss_icp_torch import _build
    from kss_icp_torch.config import DEFAULT_CONFIG
    from kss_icp_torch.ops.coarse_cuda import field_ave
    from kss_icp_torch.ops.nn_cuda import nn1
    from kss_icp_torch.ops.resample_cuda import fps

    dev = torch.device("cuda", 0)
    log("== 1. device")
    card = nvidia_smi()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    log("== 2. build")
    lib_path, nvcc_out, seconds = _build.build()
    _build.library()
    log(f"built {lib_path.name} in {seconds:.2f} s")
    for line in nvcc_out.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log("  " + line.strip())

    log("== 3. kernels against their plain versions")
    kernels = phase_kernels(torch, dev)

    log("== 4. end to end: remesh 25")
    expected = json.loads((FIXTURES / "torch_port_expected.json").read_text())
    pairs = load_pairs()
    counters = {"nn1": nn1, "fps": fps, "field_ave": field_ave}
    results = {}
    for label, cfg, exp in (
        ("default", dataclasses.replace(DEFAULT_CONFIG, auto_escalate=False), expected["pairs"]),
        ("bench", dataclasses.replace(DEFAULT_CONFIG, auto_escalate=False, **BENCH_KNOBS),
         expected["bench_config"]["pairs"]),
    ):
        results[label] = phase_end_to_end(torch, dev, cfg, {p["name"]: p for p in exp}, label, pairs, counters)
        launches = {k: fn.launches for k, fn in counters.items()}
        log(f"  [{label}] kernel launches: {launches}")
        require(all(n > 0 for n in launches.values()), f"{label}: a kernel of the main path never launched: {launches}")
        if label == "default":
            for k, n in launches.items():
                kernels[k]["launches"] = n
    log(f"pairs/s on the remesh 25, escalation off: default {results['default']['pairs_per_s']:.3f}, "
        f"bench {results['bench']['pairs_per_s']:.3f} ({card})")

    keys = ("name", "route", "source", "replaces", "also_replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "shape", "cases")
    line = {"kernels": [{k: v for k, v in dict(kernels[n], name=n, route="cuda").items() if k in keys}
                        for n in ("nn1", "fps", "field_ave")]}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
