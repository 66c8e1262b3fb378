#!/usr/bin/env python3
"""Smoke run of the PyTorch port (kss_icp_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):
  1. device: require CUDA; print the card's name and power limit
     (nvidia-smi) and the torch / CUDA versions;
  2. build: compile kss_icp_torch/csrc/*.cu with nvcc (one process per
     source, in parallel) and print the time and the ptxas register /
     shared-memory report;
  3. kernels: run each kernel and its plain PyTorch version on the card on
     the same inputs at the main path's shapes, compare them (indices
     identical, d² within rtol 1e-6, the fields within rtol 2e-5; field_dot
     at "highest" and "default" on the base grid C=512, P=T=2048 and the
     escalation grid C=4096, P=T=512) and time both with CUDA events, with
     each kernel's bound and a PyTorch composition as a yardstick;
  4. end to end on the 25 remesh pairs through register_pair ->
     apply_similarity -> registration_measure, every pair's RMSE within the
     JAX CPU value + 0.006:
       a. escalation off at DEFAULT_CONFIG and the bench config
          (fixtures/torch_port_expected.json);
       b. escalation on, overlap_escalate=False, at DEFAULT_CONFIG, the bench
          config and DEFAULT_CONFIG with coarse_method="dot"
          (fixtures/torch_port_expected_escalation.json): pairs/s from a pass
          without stage syncs, stage seconds from a second pass with them,
          and how many pairs escalated, won and were finished, beside JAX;
       c. the category, deform and scale boards (48 pairs) at DEFAULT_CONFIG,
          escalation on: the pass/fail set by pose error must equal JAX's on
          the CPU, se/7 (the recorded cross-platform knife edge) excepted;
     every pass zeroes the kernels' launch counts before it and checks them
     after: nn1 and fps on every pass, field_ave on the "vpu" passes only,
     field_dot on the dot pass only and on both of its grids;
  5. a measurement that gates nothing: on each remesh pair's 8³ field, does
     field_dot at "default" (one bf16 pass) keep candidate 0 and the top-6
     set of "highest" and of field_ave?
  6. one JSON line with each kernel's numbers, then the result line
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
# The pair whose CPU and TPU boards disagree (BASELINE.md:694-719): printed, not gated.
KNIFE_EDGE = "se/7"
# The card's peaks for the bounds (NVIDIA's H100 SXM data sheet, dense, at
# 700 W): HBM bytes/s, float32 operations/s outside the tensor cores (an FMA
# counts as two, a min or compare as one) and bf16 tensor-core operations/s.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12


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


def bound(ops: float, nbytes: float, bf16_ops: float = 0.0) -> dict:
    """The least time for the work: the largest of its float32 operations
    and its bf16 tensor-core operations, each over its peak, and its bytes
    (inputs once, outputs once) over HBM. The operations are those the
    function needs on this run's valid rows, not those a kernel spends."""
    t_ops = max(ops / FP32_OPS_PER_S, bf16_ops / BF16_OPS_PER_S) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def phase_kernels(torch, dev) -> dict:
    from kss_icp_torch.core.transforms import euler_xyz_matrix
    from kss_icp_torch.models.coarse import rotation_grid
    from kss_icp_torch.ops.coarse_cuda import (dot_operands, field_ave, field_ave_plain, field_dot,
                                               field_dot_plain, rotate_sources)
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
        valid = ref[0, mask[0]][None]
        # 4096 queries a call keeps cdist's (Q, R) output at 1 GiB in the K4 regime.
        yard_ms = time_ms(torch, lambda: [torch.cdist(query[:, a:a + 4096], valid).min(-1)
                                          for a in range(0, q_n, 4096)], reps)
        # 3 sub + 3 mul + 2 add + 1 compare per query and valid reference row.
        b = bound(9.0 * lanes * q_n * int(mask.sum()), 4 * (lanes * q_n * 3 + r_n * 3) + r_n + 8 * lanes * q_n)
        cases.append(dict({"shape": f"{lanes}x{q_n}x{r_n}", "label": label, "ms": ms, "plain_ms": plain_ms,
                           "max_abs_err": err, "yardstick_ms": yard_ms}, **b))
        log(f"  nn1 {lanes}x{q_n}x{r_n} ({label}): indices identical, max|d2 err| {err:.3g}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, cdist+min {yard_ms:.4f} ms, "
            f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    out["nn1"] = dict(cases[0], cases=cases, source="kss_icp_torch/csrc/nn.cu",
                      replaces="kss_icp_tpu/ops/nn_pallas.py:118",
                      also_replaces="kss_icp_tpu/ops/nn_pallas.py:183",
                      yardstick="torch.cdist(query, valid_ref).min(-1), 4096 queries a call")

    b_n, p_n, s = 2, 8192, 2048
    pts = t(np.stack([cloud(rng, p_n) for _ in range(b_n)]))
    pmask = torch.ones((b_n, p_n), dtype=torch.bool, device=dev)
    pmask[0, 8000:] = False
    pmask[1, 6201:] = False
    ik, smk = fps(pts, pmask, s)
    ip, smp = farthest_point_sampling(pts, pmask, s)
    torch.cuda.synchronize()
    require(torch.equal(ik, ip) and torch.equal(smk, smp),
            f"fps: indices differ at {int((ik != ip).sum())} of {b_n * s} picks")
    ms = time_ms(torch, lambda: fps(pts, pmask, s), 5)
    plain_ms = time_ms(torch, lambda: farthest_point_sampling(pts, pmask, s), 2)
    # Per step and valid point: 3 sub + 3 mul + 2 add + 1 min + 1 compare. The
    # S steps are a dependency chain the bound does not see (PERF.md).
    b = bound(10.0 * s * int(pmask.sum()), 4 * b_n * p_n * 3 + b_n * p_n + b_n * s * 5)
    log(f"  fps B={b_n} P={p_n} S={s}: indices identical; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}; {s} dependent steps)")
    out["fps"] = dict({"shape": f"{b_n}x{p_n}->{s}", "ms": ms, "plain_ms": plain_ms, "max_abs_err": 0.0,
                       "yardstick_ms": None, "source": "kss_icp_torch/csrc/fps.cu",
                       "replaces": "kss_icp_tpu/ops/resample_pallas.py:102"}, **b)

    def field_inputs(steps, n):
        src, tgt = t(cloud(rng, n)), t(cloud(rng, n))
        smask = torch.arange(n, device=dev) < n - n // 40
        tmask = torch.arange(n, device=dev) < n - n // 20  # masked target rows
        return src, smask, tgt, tmask, euler_xyz_matrix(rotation_grid(steps, 6.3, dev))

    def field_bytes(c_n, n):
        return 4 * (n * 3 * 2 + c_n * 9 + c_n) + 2 * n

    def chunked(fn, c_n, step=64):
        return lambda: [fn(c0, min(c0 + step, c_n)) for c0 in range(0, c_n, step)]

    # Operations per evaluation (rotation, valid source point, valid target
    # row), as (float32, bf16): field_ave 3 sub + 3 mul + 2 add + 1 min;
    # field_dot at "highest" 3 mul + 3 add (the bias included) + 1 min; at
    # "default" the K=4 bf16 product, 2 x 4 on a tensor core, and the float32
    # min. The kernels spend more (PERF.md).
    per_eval = {None: (9.0, 0.0), "highest": (7.0, 0.0), "default": (1.0, 8.0)}
    for name, kernel, plain, src_file, line, precisions in (
            ("field_ave", field_ave, field_ave_plain, "field.cu", 201, (None,)),
            ("field_dot", field_dot, field_dot_plain, "field_dot.cu", 218, ("highest", "default"))):
        cases = []
        for steps, n, grid in ((8, 2048, "base grid"), (16, 512, "escalation grid")):
            args = field_inputs(steps, n)
            c_n = args[4].shape[0]
            src, smask, tgt, tmask, rots = args
            if name == "field_ave":
                rotated, valid = rotate_sources(rots, src), tgt[tmask]
                yard = chunked(lambda a, z: torch.cdist(rotated[a:z], valid[None]).amin(-1), c_n)
                yard_label = "torch.cdist(rotated, valid_target).amin(-1), 64 rotations a call"
            else:
                rotated, _, _, ra = dot_operands(*args)
                qa = torch.cat([rotated, torch.ones_like(rotated[..., :1])], dim=-1)
                yard = chunked(lambda a, z: torch.matmul(qa[a:z], ra.T).amin(-1), c_n)
                yard_label = "torch.matmul([Rq, 1], ra.T).amin(-1) in float32, 64 rotations a call"
            for prec in precisions:
                kw = {} if prec is None else {"precision": prec}
                fk = kernel(*args, **kw)
                fp = plain(*args, **kw)
                torch.cuda.synchronize()
                label = f"{name}{'' if prec is None else ' ' + prec} C={c_n} P=T={n}"
                require(torch.allclose(fk, fp, rtol=2e-5, atol=0.0), f"{label}: differs beyond rtol 2e-5")
                require(torch.equal(fk, kernel(*args, **kw)), f"{label}: repeated runs differ")
                err = float((fk - fp).abs().max())
                ms = time_ms(torch, lambda: kernel(*args, **kw), 10)
                plain_ms = time_ms(torch, lambda: plain(*args, **kw), 3)
                yard_ms = time_ms(torch, yard, 3)
                evals = c_n * int(smask.sum()) * int(tmask.sum())
                b = bound(per_eval[prec][0] * evals, field_bytes(c_n, n), per_eval[prec][1] * evals)
                cases.append(dict({"shape": f"{c_n}x{n}x{n}", "label": grid, "precision": prec, "ms": ms,
                                   "plain_ms": plain_ms, "max_abs_err": err, "yardstick_ms": yard_ms}, **b))
                log(f"  {label} ({grid}): max|err| {err:.3g}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"yardstick {yard_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
        out[name] = dict(cases[0], cases=cases, yardstick=yard_label, source=f"kss_icp_torch/csrc/{src_file}",
                         replaces=f"kss_icp_tpu/ops/coarse_pallas.py:{line}")
    return out


def load_pairs():
    meta = json.loads((FIXTURES / "remesh_transfer.json").read_text())
    with np.load(FIXTURES / "remesh_transfer.npz") as z:
        return [(r["name"], np.asarray(z[r["name"] + "_src"], np.float32),
                 np.asarray(z[r["name"] + "_tgt"], np.float32)) for r in meta]


class StageTimer:
    """The register_pair `timer` hook: records which stages ran for the
    current pair and, with sync=True, their seconds (a sync at each border)."""

    def __init__(self, torch, sync: bool):
        self.torch, self.sync = torch, sync
        self.seconds = defaultdict(float)
        self.ran = set()

    @contextlib.contextmanager
    def __call__(self, name):
        self.ran.add(name)
        if self.sync:
            self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        if self.sync:
            self.torch.cuda.synchronize()
            self.seconds[name] += time.perf_counter() - t0


def drive(torch, dev, cfg, pairs, counters, timer, label, judge):
    """One pass of `pairs` through register_pair -> apply_similarity ->
    registration_measure, the launch counts zeroed just before it. Returns
    (rows, seconds, launches); judge(name, src, metrics, aligned) -> row."""
    import kss_icp_torch as kt

    rows, total = [], 0.0
    for fn in counters.values():
        fn.launches = 0
    for name, src, tgt in pairs:
        timer.ran.clear()
        t0 = time.perf_counter()
        res = kt.register_pair(src, tgt, cfg, device=dev, timer=timer)
        with timer("metric"):
            aligned = kt.apply_similarity(res.transform, torch.as_tensor(src, device=dev))
            m = kt.registration_measure(aligned, tgt, device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        total += dt
        rows.append(dict(judge(name, src, m, aligned), name=name, s=dt, cand=int(res.chosen_candidate),
                         iters=int(res.icp_iterations), escalated="escalate" in timer.ran,
                         won=res.coarse.field.shape[0] == cfg.escalate_rotation_steps and cfg.auto_escalate,
                         finisher="finish" in timer.ran))
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"  [{label}] kernel launches: {launches}")
    return rows, total, launches


def remesh_judge(torch, expected):
    def judge(name, src, m, aligned):
        exp = expected[name]
        ok = (np.isfinite(m["rmse"]) and tuple(aligned.shape) == src.shape
              and bool(torch.isfinite(aligned).all()) and m["rmse"] <= exp["rmse"] + RMSE_BAND)
        return {"ok": ok, "rmse": m["rmse"], "jax_rmse": exp["rmse"], "jax_cand": exp["chosen_candidate"]}
    return judge


def report_remesh(label, rows, total, expected, escalation: bool) -> None:
    for r in rows:
        esc = (f" esc {int(r['escalated'])}/{int(expected[r['name']].get('escalated', False))} "
               f"won {int(r['won'])} fin {int(r['finisher'])}") if escalation else ""
        log(f"  [{label}] {r['name']}: rmse {r['rmse']:.6f} (jax {r['jax_rmse']:.6f}) cand {r['cand']} "
            f"(jax {r['jax_cand']}) iters {r['iters']}{esc} {r['s'] * 1e3:.1f} ms {'ok' if r['ok'] else 'FAIL'}")
    failures = [r["name"] for r in rows if not r["ok"]]
    require(not failures, f"{label}: pairs outside JAX RMSE + {RMSE_BAND}: {failures}")
    same = sum(r["cand"] == r["jax_cand"] for r in rows)
    log(f"  [{label}] {len(rows)} pairs in {total:.3f} s: {len(rows) / total:.3f} pairs/s; "
        f"same candidate as JAX on {same}/{len(rows)}")


def escalation_counts(label, rows, exp_rows) -> dict:
    counts = {k: sum(bool(r[k]) for r in rows) for k in ("escalated", "won", "finisher")}
    jax = {"escalated": sum(p["escalated"] for p in exp_rows), "won": sum(p["escalation_won"] for p in exp_rows),
           "finisher": sum(p["finisher"] for p in exp_rows)}
    log(f"  [{label}] escalated {counts['escalated']} (jax {jax['escalated']}), won {counts['won']} "
        f"(jax {jax['won']}), finisher {counts['finisher']} (jax {jax['finisher']})")
    return {"port": counts, "jax": jax}


def check_launches(label, launches, method: str) -> None:
    require(launches["nn1"] > 0 and launches["fps"] > 0, f"{label}: nn1 or fps never launched: {launches}")
    if method == "dot":
        require(launches["field_dot"] > 0 and launches["field_ave"] == 0,
                f"{label}: the dot pass must launch field_dot and not field_ave: {launches}")
    else:
        require(launches["field_ave"] > 0 and launches["field_dot"] == 0,
                f"{label}: a vpu pass must launch field_ave and not field_dot: {launches}")


def phase_end_to_end(torch, dev, kernels: dict) -> dict:
    from kss_icp_torch.challenge import BOARDS, transform_rmse
    from kss_icp_torch.config import DEFAULT_CONFIG
    from kss_icp_torch.ops.coarse_cuda import field_ave, field_dot
    from kss_icp_torch.ops.nn_cuda import nn1
    from kss_icp_torch.ops.resample_cuda import fps

    counters = {"nn1": nn1, "fps": fps, "field_ave": field_ave, "field_dot": field_dot}
    pairs = load_pairs()
    plain_exp = json.loads((FIXTURES / "torch_port_expected.json").read_text())
    esc_exp = json.loads((FIXTURES / "torch_port_expected_escalation.json").read_text())
    import kss_icp_torch as kt

    # Warm-up: library handles, cuSOLVER, the allocator, both grids and both fields.
    warm = dataclasses.replace(DEFAULT_CONFIG, overlap_escalate=False, escalate_threshold=0.0)
    for method in ("vpu", "dot"):
        kt.register_pair(pairs[0][1], pairs[0][2], dataclasses.replace(warm, coarse_method=method), device=dev)
    torch.cuda.synchronize()
    out = {"passes": {}}

    log("== 4a. escalation off: remesh 25")
    for label, cfg, exp in (
            ("default", dataclasses.replace(DEFAULT_CONFIG, auto_escalate=False), plain_exp["pairs"]),
            ("bench", dataclasses.replace(DEFAULT_CONFIG, auto_escalate=False, **BENCH_KNOBS),
             plain_exp["bench_config"]["pairs"])):
        expected = {p["name"]: p for p in exp}
        rows, total, launches = drive(torch, dev, cfg, pairs, counters, StageTimer(torch, False), label,
                                      remesh_judge(torch, expected))
        report_remesh(label, rows, total, expected, escalation=False)
        check_launches(label, launches, "vpu")
        out["passes"][label] = {"pairs_per_s": len(rows) / total, "seconds": total, "launches": launches}

    log("== 4b. escalation on (overlap_escalate=False): remesh 25")
    esc = dict(overlap_escalate=False)
    for label, cfg, exp in (
            ("esc-default", dataclasses.replace(DEFAULT_CONFIG, **esc), esc_exp["pairs"]),
            ("esc-bench", dataclasses.replace(DEFAULT_CONFIG, **esc, **BENCH_KNOBS), esc_exp["bench_config"]["pairs"]),
            ("esc-dot", dataclasses.replace(DEFAULT_CONFIG, coarse_method="dot", **esc), esc_exp["pairs"])):
        expected = {p["name"]: p for p in exp}
        judge = remesh_judge(torch, expected)
        rows, total, launches = drive(torch, dev, cfg, pairs, counters, StageTimer(torch, False), label, judge)
        report_remesh(label, rows, total, expected, escalation=True)
        method = cfg.coarse_method
        check_launches(label, launches, method)
        counts = escalation_counts(label, rows, exp)
        if counts["jax"]["escalated"]:
            require(counts["port"]["escalated"] > 0, f"{label}: JAX escalates pairs here and the port none")
        if method == "dot":
            # One field per pair on the 8³ grid and one per escalated pair on the 16³ grid.
            require(counts["port"]["escalated"] > 0 and
                    launches["field_dot"] == len(rows) + counts["port"]["escalated"],
                    f"{label}: field_dot did not run on both grids: {launches}, {counts}")
        timer = StageTimer(torch, True)
        _, staged, _ = drive(torch, dev, cfg, pairs, counters, timer, label + " staged", judge)
        log(f"  [{label}] stage seconds over all pairs (synced pass, {staged:.3f} s): " +
            ", ".join(f"{k} {v:.4f}" for k, v in timer.seconds.items()))
        out["passes"][label] = {"pairs_per_s": len(rows) / total, "seconds": total, "launches": launches,
                                "escalation": counts, "stage_seconds": dict(timer.seconds),
                                "staged_seconds": staged}

    log("== 4c. escalation on: category, deform and scale boards")
    cfg = dataclasses.replace(DEFAULT_CONFIG, **esc)
    board_pairs, gt, threshold, jax_pass = [], {}, {}, {}
    for board, corpus, thr in BOARDS:
        for name, src, tgt, g in corpus():
            board_pairs.append((name, src, tgt))
            gt[name], threshold[name] = g, thr
        for p in esc_exp["boards"][board]["pairs"]:
            jax_pass[p["name"]] = p["passed"]
    exp_rows = [p for b in esc_exp["boards"].values() for p in b["pairs"]]

    def board_judge(name, src, m, aligned):
        pose = transform_rmse(aligned.cpu().numpy(), src, gt[name])
        return {"pose": pose, "passed": bool(pose <= threshold[name]), "rmse": m["rmse"]}

    rows, total, launches = drive(torch, dev, cfg, board_pairs, counters, StageTimer(torch, False), "boards",
                                  board_judge)
    check_launches("boards", launches, "vpu")
    mismatched = []
    for r in rows:
        agree = r["passed"] == jax_pass[r["name"]]
        log(f"  [boards] {r['name']}: pose {r['pose']:.4f} {'pass' if r['passed'] else 'FAIL'} "
            f"(jax {'pass' if jax_pass[r['name']] else 'FAIL'}) esc {int(r['escalated'])} won {int(r['won'])} "
            f"fin {int(r['finisher'])} {r['s'] * 1e3:.1f} ms{'' if agree else ' DIFFERS'}")
        if not agree and r["name"] != KNIFE_EDGE:
            mismatched.append(r["name"])
    require(not mismatched, f"boards: pass/fail differs from JAX on the CPU: {mismatched}")
    counts = escalation_counts("boards", rows, exp_rows)
    passed = sum(r["passed"] for r in rows)
    poses = sorted(r["pose"] for r in rows)
    log(f"  [boards] {passed}/{len(rows)} pass (jax {sum(jax_pass.values())}/{len(rows)}); median pose "
        f"{float(np.median(poses)):.4f}; {len(rows) / total:.3f} pairs/s")
    out["passes"]["boards"] = {"pairs_per_s": len(rows) / total, "seconds": total, "launches": launches,
                               "escalation": counts, "passed": passed, "median_pose": float(np.median(poses))}

    for name in ("nn1", "fps", "field_ave"):
        kernels[name]["launches"] = out["passes"]["esc-default"]["launches"][name]
    kernels["field_dot"]["launches"] = out["passes"]["esc-dot"]["launches"]["field_dot"]
    return out


def phase_bf16_ranking(torch, dev) -> None:
    """Does the bf16 dot field keep the 8³ ranking? Gates nothing."""
    from kss_icp_torch.config import DEFAULT_CONFIG as cfg
    from kss_icp_torch.core.preshape import middle_align
    from kss_icp_torch.core.transforms import apply_similarity
    from kss_icp_torch.models.coarse import coarse_align
    from kss_icp_torch.models.kss_icp import resample_batch

    def padded(points):
        return (torch.as_tensor(points, device=dev)[None],
                torch.ones((1, len(points)), dtype=torch.bool, device=dev))

    same0 = {"highest": 0, "vpu": 0}
    same6 = {"highest": 0, "vpu": 0}
    pairs = load_pairs()
    for name, src, tgt in pairs:
        pn = torch.tensor([cfg.resample_count(len(src), len(tgt))], device=dev)
        sp, sm = resample_batch(*padded(src), pn, cfg)
        tp, tm = resample_batch(*padded(tgt), pn, cfg)
        sim0, _, _ = middle_align(sp[0], sm[0], tp[0], tm[0])
        aligned = apply_similarity(sim0, sp[0]).contiguous()
        fields = {}
        for key, method, prec in (("default", "dot", "default"), ("highest", "dot", "highest"),
                                  ("vpu", "vpu", "highest")):
            c = coarse_align(aligned, sm[0], tp[0], tm[0], steps=cfg.rotation_steps, radius=cfg.kernel_radius,
                             max_candidates=cfg.max_candidates, method=method, precision=prec)
            fields[key] = (tuple(c.candidate_angles[0].tolist()), {tuple(a) for a in c.candidate_angles[:6].tolist()})
        line = []
        for ref in ("highest", "vpu"):
            s0 = fields["default"][0] == fields[ref][0]
            s6 = fields["default"][1] == fields[ref][1]
            same0[ref] += s0
            same6[ref] += s6
            line.append(f"vs {ref}: candidate 0 {'same' if s0 else 'DIFFERS'}, top-6 set {'same' if s6 else 'differs'}")
        log(f"  [bf16 field] {name}: " + "; ".join(line))
    n = len(pairs)
    log(f"  [bf16 field] the bf16 8³ field keeps candidate 0 of 'highest' on {same0['highest']}/{n} pairs and of "
        f"field_ave on {same0['vpu']}/{n}; the top-6 set on {same6['highest']}/{n} and {same6['vpu']}/{n}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SmokeError("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    import kss_icp_torch  # noqa: F401  (fails where the repository is absent)
    from kss_icp_torch import _build

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
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

    log("== 4. end to end")
    e2e = phase_end_to_end(torch, dev, kernels)
    p = e2e["passes"]
    log(f"pairs/s on the remesh 25 (no stage syncs): escalation off default {p['default']['pairs_per_s']:.3f}, "
        f"bench {p['bench']['pairs_per_s']:.3f}; escalation on default {p['esc-default']['pairs_per_s']:.3f}, "
        f"bench {p['esc-bench']['pairs_per_s']:.3f}, dot {p['esc-dot']['pairs_per_s']:.3f}; boards "
        f"{p['boards']['pairs_per_s']:.3f} ({card})")

    log("== 5. bf16 dot field against the float32 fields (gates nothing)")
    phase_bf16_ranking(torch, dev)
    log(f"smoke run {time.perf_counter() - t_start:.1f} s ({card})")

    keys = ("name", "route", "source", "replaces", "also_replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "yardstick", "yardstick_ms", "shape", "precision", "cases")
    line = {"kernels": [{k: v for k, v in dict(kernels[n], name=n, route="cuda", library_ms=None).items() if k in keys}
                        for n in ("nn1", "fps", "field_ave", "field_dot")]}
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
