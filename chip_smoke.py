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
     the same inputs at the main path's shapes, compare them (nn1 and fps
     bit-identical: indices and d² equal; the fields within rtol 2e-5;
     nn1 at the screen, escalation screen, refine, metric and K4 shapes
     and at the overlap screen rung's: 512 lanes x 512 x 2048, the forward
     fitness 512 x 2048 x 2048 and the reverse one against 512 per-lane
     references (lane_ref = arange); and at register_many's shapes, a cloud
     a pair (lane_ref = the lane's pair): on the remesh batch the screen
     (25 x 32) x 512 x 2048, the refine (25 x 4) x 2048 x 2048 and the
     metric 25 x 8192 x 8192; on the board batch the screen (64 x 32) x 512
     x 2048, the refine (64 x 4) x 2048 x 2048, the screen rung's ICP over
     16 pairs (16 x 512) x 512 x 2048, its forward fitness (16 x 512) x 2048
     x 2048 against 16 clouds and its reverse one against 8192, and the
     metric 64 x 8192 x 8192; each batch case reports its launches from the
     4e pass that runs it; precision mode's polish, 12 lanes x 2048 x 2048
     (one pair) and (25 x 12) x 2048 x 2048 against 25 clouds (the remesh
     batch), with launches from the 4g passes; every case prints its launch
     plan (nn1_plan); and the large-scan metric, 1 x 200704 x 200704,
     the normalized source of the Room seed with the widest compacted pad
     moved by JAX's recorded transform against its target, with its
     launches from the 4f pass;
     fps at B=2 x 8192 -> 2048, at the largest remesh pair's padded
     source and target with steps = pnumber, over the remesh 25's 50
     and the boards' 128 clouds at full_pad 8192 with steps = the largest
     pnumber, and at the large-scan resample: both compacted octree
     survivor clouds of that seed (B=2 x 151552 -> 2048, 2000 steps),
     with its launches from the 4f pass, and at WLOP's start in 4j, one
     40960-point tools original to 8000 samples (B=1, 8000 steps), with
     its launches from the 4j pass; field_ave, and field_dot at
     "highest" and "default", on the base grid C=512, P=T=2048 and the
     escalation grid C=4096, P=T=512, mostly valid, and on the base grid
     with both clouds suffix-masked to the largest and smallest remesh
     pair's pnumber, 1534 and 378, where the field must also equal its
     valid prefix's bit for bit, and on the base grid at the bench
     config's 512-point prefixes, C=512, P=T=512) and time both with CUDA
     events, calls back to back (`ms`, as the ICP loop pays them), and
     each kernel also by
     CUDA-graph replay (`device_ms`, the device's time of a call); each
     with its bound on the valid rows and a PyTorch composition as a
     yardstick; field_trim (the per-point mode of the field kernel, the
     overlap tier's trimmed field) bit for bit, per-point distances and
     trimmed field, at 512 x 2048 x 2048 with ~70% scattered inlier masks on
     both clouds, 4096 x 2048 x 2048 and a fully masked target; field_sq
     (the squared per-point mode, the "max" and "diff" fields) bit for bit
     at 512 x 2048 x 2048 (~70% masks), 4096 x 512 x 512 and a fully masked
     target, its numbers under field_trim's row as `squared` with its
     launches from 4i; plain PyTorch timings, gating nothing, of the AIVS
     resample (a remesh pair's two clouds; the remesh batch's 50 clouds at
     full_pad 8192, twice: the same picks both times, or the run fails) and
     of the PCA normals (1 and 25 resampled targets);
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
       c. the category, deform and scale boards (48 pairs) as in b: the
          pass/fail set by pose error must equal JAX's on
          the CPU, se/7 (the recorded cross-platform knife edge) excepted;
       d. the unmodified DEFAULT_CONFIG, escalation and its overlap tier on
          (fixtures/torch_port_expected_overlap.json): the remesh 25 within
          JAX + 0.006, pairs/s unsynced and stage seconds synced (the rungs'
          stages overlap8, overlap16, overlap_screen among them); then the
          five boards (64 pairs, partial and partial_hard included): the
          pass/fail set equal to JAX's, se/7 excepted, each pair's overlap
          rungs (skipped, run, adopted) printed beside JAX's;
       e. register_many at the unmodified DEFAULT_CONFIG
          (fixtures/torch_port_expected_batch.json, JAX's register_many on
          the CPU): the remesh 25 as one batch after a warm-up batch, every
          pair within JAX + 0.006 and escalated as in JAX, pairs/s unsynced
          beside 4d's single-pair figure, stage seconds and lockstep ICP
          iterations from a synced pass beside 4d's sums over the pairs;
          then the five boards' 64 pairs as one batch: the pass/fail set
          equal to JAX's, se/7 excepted, every pair escalated and its
          overlap rungs run and adopted as in JAX; each pair's difference
          from register_pair (4d) printed;
       f. large scans: kss_icp_torch.largescan.run_largescan(200_000,
          80_000, DEFAULT_CONFIG, seed) for seeds 0, 1 and 2 (seed 0 with
          repeats=2, as bench.py runs it) against
          fixtures/torch_port_expected_largescan.json (JAX's run_largescan
          pieces on the CPU): the octree survivor counts n_s and n_t and the
          pnumber equal to JAX's, escalated as JAX, the unit-scale RMSE
          within JAX's + 0.006 and the pose error under 0.1 m (JAX's printed
          beside it); per seed the stage seconds, the kernels' launches (one
          fps launch and one 1 x 200704 x 200704 nn1 launch a run), the peak
          device memory and the card;
       g. precision mode, DEFAULT_CONFIG with neighborhood_fracs=(0.25,
          0.5) as the CLI's --precise builds it
          (fixtures/torch_port_expected_precise.json, JAX's register_pair on
          the CPU): the remesh 25 one pair at a time within JAX + 0.006 and
          the category board (32 pairs) with JAX's pass/fail set, se/7
          excepted; every pair's fitness at most its fitness in 4d (the same
          config without the polish, this run), the pairs where a restart
          won printed beside JAX's, tube/1's pose, pairs/s with and without
          the polish, the polish stage's seconds and lockstep iterations;
          then the remesh 25 as one register_many batch, within JAX + 0.006,
          each pair's difference from the single-pair run printed;
       h. the command line on the card: the remesh 25 written as
          <name>.gird / <name>.wlop with transfer.txt (the port's io and
          transfer modules), then `python -m kss_icp_torch` subprocesses at
          their default device: bench-dir --json (RMSE within JAX's batch
          record + 0.006, the pose pass set of 4e's transforms), batch with
          and without --batched (JAX's register_pair and register_many
          records + 0.006), register -o then measure (the printed RMSEs
          within 1e-6 relative), register --precise on tube/1 (JAX + 0.006,
          pose under 0.2), resample and simplify -m octree on Room seed 0's
          source (points of the input), largescan --seed 0 (gated as 4f),
          serve with three good requests and one bad (three ok, one not,
          exit 0 at EOF) and register --profile, whose torch.profiler trace
          must name nn1_kernel, fps_kernel and field_partial_kernel and
          gives the device busy share of one register pass, its process's
          first (printed beside the same trace of a warm pass in this
          process); each subprocess's wall seconds beside nvidia-smi's line;
          then register, register --precise, register --overlap and
          bench-dir once more through kss_icp_torch.cli.main in this
          process, the launch counts zeroed just before each and read just
          after: nn1 and fps launched by each (one fps launch for
          bench-dir's batch), field_ave by the two plain registers and by
          bench-dir (a launch a pair), field_trim by --overlap, the polish's 12 x 2048 x 2048 nn1 shape by --precise,
          field_dot by none; the kernels line's `cli_launches` sums them;
     every pass zeroes the kernels' launch counts before it and checks them
     after: nn1 and fps on every pass, field_ave on the "vpu" passes only,
     field_dot on the dot pass only and on both of its grids, field_trim on
     4d and 4e only (4g's may), where an overlap rung must have run on the partial
     boards and nn1 launched the screen rung's 512-lane solve; in 4e one
     fps launch a batch, one field_ave launch a pair and grid and one
     field_trim launch a pair, overlap solve and field rung; each pass
     prints its histogram of nn1 launch shapes (L, Q, R);
       i. the knobs, each alone on DEFAULT_CONFIG
          (fixtures/torch_port_expected_variants.json, JAX on the CPU):
          register_pair on the remesh 25 at icp_variant="point_to_plane",
          coarse_error_metric "max" and "diff" and resampler="aivs", every
          pair within JAX + 0.006 and the escalated set JAX's (pairs/s
          unsynced, stage seconds and lockstep iterations synced); then
          register_many on the remesh 25 at "aivs" and "point_to_plane"
          (within JAX's register_many + 0.006, escalated as JAX); the
          category board at "point_to_plane" (the pass/fail set JAX's, se/7
          excepted); how many of register_pair's AIVS picks on each remesh
          cloud are JAX's, each cloud that differs printed with its cause;
          and `python -m kss_icp_torch simplify <largest remesh source> -m
          aivs -n 2000` as a subprocess: as many points as JAX's, each
          shared pick's point JAX's (rtol 1e-6); launches: fps on none of
          the aivs passes, field_sq on the "max" and "diff" passes only;
       j. the tools at the CLI's defaults (fixtures/torch_port_expected_tools.json
          and .npz, JAX on the CPU): four 40960-point originals
          (challenge._instance, one a family) written as .xyz, `python -m
          kss_icp_torch make-pairs` on them (--wlop-points 8000, each with its
          own recorded axis, angle, scale and translation) and `batch` on its
          output as subprocesses, each pair's RMSE within JAX's on JAX's own
          pair + 0.006; the same two commands through cli.main in this
          process with their launches (fps a cloud, nn1 and field_ave a
          pair); then per original in this process: wlop_resample to 8000
          (one fps launch, its start JAX's indices; the samples at the WLOP
          bar against JAX's: median |Δ| 5e-5 and max 2e-3 bounding-box
          diagonals, or where JAX's float32 samples are themselves farther
          from the float64 solution (the record's), the port's median
          within a tenth and max within JAX's distance to it; the spacing
          CV within 2%, the on-surface distance at most JAX's + 1e-3
          diagonals; ms and peak MiB),
          hierarchy_simplify at cluster size 10 (JAX's kept set),
          simplification_measure of JAX's WLOP with JAX's normals (rtol 1e-4,
          or where JAX's float32 is farther from the float64 projection,
          within a tenth of its distance; with the card's own normals
          printed beside it), the `.gird` source
          at JAX's radius (JAX's bits) and the card's radius (within 1e-6 of
          float64); pipeline_from_file on the first original (radius within
          1e-6 of float64, JAX's border and count, build_voxel_grid's grid,
          estimate_oriented_normals' unit normals, the .normal sidecar read
          back); and `simplify -m wlop -n 2000` and `-m hierarchy` on
          handg's remesh source as subprocesses (JAX's printed lines; the
          hierarchy's points JAX's, the WLOP at its bar);
       k. the last modules (fixtures/torch_port_expected_two_stage.json and
          torch_port_expected_analysis.{json,npz}, JAX on the CPU): the
          two-stage converge, DEFAULT_CONFIG with refine_max_iterations=8 and
          refine_polish_iterations=1000, on the remesh 25 one pair at a time
          and as one register_many batch (within JAX + 0.006, JAX's
          escalated set; pairs/s unsynced, stage seconds with "two_stage"
          and lockstep iterations synced, continued pairs, each beside the
          shipped pass of 4d / 4e) and on the boards' 64 pairs as one batch
          (the pass/fail set of JAX's shipped register_many, se/7 excepted);
          vcm_edges at the record's 4096 points on JAX's samples (owners
          float64's but near-ties, matrices and ratios within 1e-5 of
          float64, JAX's flags away from the threshold), then on each of the
          four 40960-point tools originals at 32 samples a point, nn1 at 1 x
          1310720 x 40960, against the plain version on the card (nn1_plain
          in place of nn1: owners bit for bit, matrices within rtol 1e-5,
          flags equal; ms to a sync, peak MiB); lloyd_relax at the record's
          1024 sites, 512², 10 steps (no farther from float64 than JAX's),
          then 4096 sites at 1024², nn1 at 1 x 1048576 x 4096 a step, the
          plain version's bits; mesh_angle_report on a seeded torus grid of
          199712 faces against float64 (angles within 1e-5 rad, histogram
          counts but angles within 1e-6 of an edge); `python -m
          kss_icp_torch view --spin 0.3` as subprocesses on remesh pair 0
          and Room seed 0's 200k target, each PNG's sha256 JAX's; the native
          reader on Room seed 0's source as .xyz, binary .ply and .off
          (arrays equal to the Python readers', save_xyz bytes equal, load
          ms, files refused) and load_points_batch over the 50 remesh clouds;
          phase 3 holds nn1 at both new shapes on the same inputs, with
          launches from 4k;
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
import functools
import json
import re
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
FIXTURES = REPO / "fixtures"
RMSE_BAND = 0.006
BATCH_PAD = 8192  # register_many's full_pad
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


def bound(ops: float, nbytes: float, bf16_ops: float = 0.0) -> dict:
    """The least time for the work: the largest of its float32 operations
    and its bf16 tensor-core operations, each over its peak, and its bytes
    (inputs once, outputs once) over HBM. The operations are those the
    function needs on this run's valid rows, not those a kernel spends."""
    t_ops = max(ops / FP32_OPS_PER_S, bf16_ops / BF16_OPS_PER_S) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def shape_key(lanes: int, q_n: int, r_n: int, groups: int) -> str:
    """An nn1 launch shape as printed and as the `kernels` line's cases name it."""
    return f"{lanes}x{q_n}x{r_n}" + (f" G={groups}" if groups > 1 else "")


def phase_kernels(torch, dev) -> dict:
    from kss_icp_torch.config import DEFAULT_CONFIG
    from kss_icp_torch.core.cloud import PointCloud
    from kss_icp_torch.core.transforms import euler_xyz_matrix
    from kss_icp_torch.models.coarse import rotation_grid
    from kss_icp_torch.ops.coarse_cuda import (dot_operands, field_ave, field_ave_plain, field_dot,
                                               field_dot_plain, rotate_sources)
    from kss_icp_torch.ops.nn_cuda import nn1, nn1_plain, nn1_plan, sm_count
    from kss_icp_torch.ops.resample import farthest_point_sampling
    from kss_icp_torch.ops.resample_cuda import fps
    from kss_icp_torch.timing import graph_ms, time_ms

    rng = np.random.default_rng(0)
    out = {}

    def t(x):
        return torch.as_tensor(x, device=dev)

    scan = largescan_inputs(torch, dev)
    n_tools = load_tools()[0]["originals"][0]["n"]
    cases = []
    # register_many's valid rows: the resampled clouds' pnumber of 2048 and
    # the full clouds padded to 8192, on the remesh 25 and on the five boards.
    boards = load_boards()
    board_pn = [DEFAULT_CONFIG.resample_count(len(a), len(b)) for _, a, b, *_ in boards]
    board_n = [len(c) for _, a, b, *_ in boards for c in (a, b)]
    board_valid, board_full = (min(board_pn), max(board_pn) + 1), (min(board_n), max(board_n) + 1)
    # (lanes, queries, reference rows, reference clouds, label, valid rows,
    # the phase 4e pass whose launches at this shape the case reports):
    # G = lanes gives each lane its own cloud through lane_ref = arange, as the
    # overlap screen's reverse fitness does; 1 < G < lanes gives each of G
    # pairs lanes / G lanes against its own cloud, as register_many's ICP
    # stages and metric do, each cloud with a valid prefix drawn from the
    # corpus's range (remesh pnumber 378-1534 of 2048, targets 3951-8000 of
    # 8192; board pnumber and cloud sizes from the boards themselves).
    for lanes, q_n, r_n, groups, label, valid, batch in (
            (32, 512, 2048, 1, "screen ICP", None, None), (16, 512, 2048, 1, "escalation screen ICP", None, None),
            (4, 2048, 2048, 1, "refine ICP", None, None), (1, 3072, 8192, 1, "metric, largest remesh pair", None, None),
            (1, 65536, 65536, 1, "K4 metric regime", None, None), (512, 512, 2048, 1, "overlap screen ICP", None, None),
            (512, 2048, 2048, 1, "overlap screen fitness, forward", None, None),
            (512, 2048, 2048, 512, "overlap screen fitness, reverse: per-lane references", None, None),
            (25 * 32, 512, 2048, 25, "batch screen ICP: 25 pairs x 32 lanes, a cloud a pair", (378, 1534), "many"),
            (25 * 4, 2048, 2048, 25, "batch refine ICP: 25 pairs x 4 lanes, a cloud a pair", (378, 1534), "many"),
            (25, 8192, 8192, 25, "batch metric: lane b against cloud b", (3951, 8000), "many"),
            (64 * 32, 512, 2048, 64, "boards batch screen ICP: 64 pairs x 32 lanes", board_valid, "many boards"),
            (64 * 4, 2048, 2048, 64, "boards batch refine ICP: 64 pairs x 4 lanes", board_valid, "many boards"),
            (16 * 512, 512, 2048, 16, "boards batch overlap screen ICP: 16 pairs x 512 lanes", board_valid,
             "many boards"),
            (16 * 512, 2048, 2048, 16, "boards batch overlap screen fitness, forward", board_valid, "many boards"),
            (16 * 512, 2048, 2048, 16 * 512, "boards batch overlap screen fitness, reverse: per-lane references",
             board_valid, "many boards"),
            (64, 8192, 8192, 64, "boards batch metric: lane b against cloud b", board_full, "many boards"),
            (12, 2048, 2048, 1, "precision polish ICP: one pair's 12 lanes", (378, 1534), "precise"),
            (25 * 12, 2048, 2048, 25, "batch precision polish ICP: 25 pairs x 12 lanes, a cloud a pair", (378, 1534),
             "precise many"),
            (1, scan["metric"][0].shape[1], scan["metric"][1].shape[1], 1,
             f"large-scan metric: Room seed {scan['seed']}, aligned source against target", None, "largescan"),
            (1, VCM_SAMPLES * n_tools, n_tools, 1, f"VCM sample owners: a {n_tools}-point tools original x "
             f"{VCM_SAMPLES} ball samples", None, "vcm"),
            (1, LLOYD["resolution"] ** 2, LLOYD["sites"], 1, f"Voronoi labels: {LLOYD['resolution']}² pixels "
             f"against {LLOYD['sites']} sites, 2D padded to z = 0", None, "voronoi")):
        if batch == "vcm":  # the first tools original and its samples, as phase 4k draws them
            pts, msk, samples = vcm_inputs(torch, dev, 0)
            query, ref, mask = samples[None], pts[None], msk[None]
        elif batch == "voronoi":  # Lloyd's first step in phase 4k
            sites = t(lloyd_start(r_n))
            query = voronoi_query(torch, dev, LLOYD["resolution"])[None]
            ref = torch.cat([sites, torch.zeros_like(sites[:, :1])], dim=-1)[None]
            mask = torch.ones((1, r_n), dtype=torch.bool, device=dev)
        else:
            query = t(np.stack([cloud(rng, q_n) for _ in range(lanes)]))
            ref = t(np.stack([cloud(rng, r_n) for _ in range(groups)]))
            mask = torch.ones((groups, r_n), dtype=torch.bool, device=dev)
            if batch == "largescan":  # the scan itself: 200000 valid target rows of 200704
                query, ref, mask = scan["metric"]
            elif valid is not None:  # each pair's cloud its own valid prefix
                mask &= torch.arange(r_n, device=dev)[None] < t(rng.integers(*valid, size=(groups, 1)))
            else:
                mask[:, r_n - r_n // 40:] = False  # a padded tail, as 2000 of 2048
        if groups == lanes > 1:
            mask &= t(rng.uniform(size=(groups, r_n)) < 0.7)  # each lane its own inlier mask
        lane_ref = torch.arange(groups, dtype=torch.int32, device=dev).repeat_interleave(lanes // groups)
        d2k, ik = nn1(query, ref, mask, lane_ref)
        d2p, ip = nn1_plain(query, ref, mask, lane_ref)
        torch.cuda.synchronize()
        require(torch.equal(ik, ip), f"nn1 {label}: indices differ at {int((ik != ip).sum())} queries")
        require(torch.equal(d2k, d2p), f"nn1 {label}: d2 differs from the plain version's bits")
        err = float((d2k - d2p).abs().max())
        reps = 3 if lanes * q_n * r_n > 1e9 else 20
        slow_reps = 1 if lanes * q_n * r_n > 1e9 else reps  # the plain version and the yardstick: 0.1-1.7 s a call
        call = (lambda: nn1(query, ref, mask)) if groups == 1 else (lambda: nn1(query, ref, mask, lane_ref))
        ms = time_ms(call, reps)  # as the ICP loop calls it
        device_ms = graph_ms(lambda: nn1(query, ref, mask, lane_ref), reps)  # the kernel alone
        plain_ms = time_ms(lambda: nn1_plain(query, ref, mask, lane_ref), slow_reps)
        if groups == 1:
            valid = ref[0, mask[0]][None]
            # 4096 queries a call keeps cdist's (Q, R) output at 1 GiB in the K4 regime.
            yard_ms = time_ms(lambda: [torch.cdist(query[:, a:a + 4096], valid).min(-1)
                                       for a in range(0, q_n, 4096)], slow_reps)
        else:  # each lane's cloud, masked rows at +inf, (Q, R) outputs of 1 GiB at the most a call
            far = torch.where(mask[..., None], ref, torch.full_like(ref, float("inf")))[lane_ref.long()]
            step = max(1, min(64, 2 ** 28 // (q_n * r_n)))
            yard_ms = time_ms(lambda: [torch.cdist(query[a:a + step], far[a:a + step]).min(-1)
                                       for a in range(0, lanes, step)], slow_reps)
        # 3 sub + 3 mul + 2 add + 1 compare per query and valid reference row.
        evals = q_n * int(mask.sum()) * (lanes // groups)
        b = bound(9.0 * evals, 4 * (lanes * q_n * 3 + groups * r_n * 3) + groups * r_n + 8 * lanes * q_n)
        plan = nn1_plan(lanes, q_n, r_n, sm_count(dev.index or 0))
        cases.append(dict({"shape": shape_key(lanes, q_n, r_n, groups), "label": label, "batch_pass": batch,
                           "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, "max_abs_err": err,
                           "yardstick_ms": yard_ms, "plan": {"cluster": plan.cluster, "slice": plan.slice}}, **b))
        log(f"  nn1 {lanes}x{q_n}x{r_n} G={groups} ({label}): indices and d2 identical; kernel {ms:.4f} ms a wrapper "
            f"call back to back, {device_ms:.4f} ms on the device (graph replay), plain {plain_ms:.4f} ms, "
            f"cdist+min {yard_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}); plan: a cluster of "
            f"{plan.cluster} splits R into slices of {plan.slice} rows")
    out["nn1"] = dict(cases[0], cases=cases, source="kss_icp_torch/csrc/nn.cu",
                      replaces="kss_icp_tpu/ops/nn_pallas.py:118",
                      also_replaces="kss_icp_tpu/ops/nn_pallas.py:183",
                      yardstick="torch.cdist(query, valid_ref).min(-1), 4096 queries a call")

    b_n, p_n, s = 2, 8192, 2048
    pts = t(np.stack([cloud(rng, p_n) for _ in range(b_n)]))
    pmask = torch.ones((b_n, p_n), dtype=torch.bool, device=dev)
    pmask[0, 8000:] = False
    pmask[1, 6201:] = False
    fps_cases = [(pts, pmask, s, s, "table shape", None)]
    # register_pair's two launches on the remesh pair with the most picks,
    # padded as PointCloud.from_points pads them.
    remesh = load_pairs()
    _, src, tgt = max(remesh, key=lambda r: DEFAULT_CONFIG.resample_count(len(r[1]), len(r[2])))
    steps = DEFAULT_CONFIG.resample_count(len(src), len(tgt))
    for points, label in ((src, "remesh source"), (tgt, "remesh target")):
        c = PointCloud.from_points(points, device=dev)
        fps_cases.append((c.points[None].contiguous(), c.mask[None].contiguous(), DEFAULT_CONFIG.resample_pad,
                          steps, label, None))
    # register_many's one launch a batch: each corpus's sources and targets
    # padded to full_pad 8192, steps = the largest pnumber; pair b needs
    # pnumber_b picks.
    for corpus, label, batch in ((remesh, "batch resample: the remesh 25's 50 clouds at full_pad 8192", "many"),
                                 ([(n, a, b) for n, a, b, *_ in boards],
                                  "batch resample: the boards' 128 clouds at full_pad 8192", "many boards")):
        counts = [DEFAULT_CONFIG.resample_count(len(a), len(b)) for _, a, b in corpus]
        clouds = [a for _, a, _ in corpus] + [b for _, _, b in corpus]
        pts = np.zeros((len(clouds), BATCH_PAD, 3), np.float32)
        for i, c in enumerate(clouds):
            pts[i, :len(c)] = c
        bmask = t(np.arange(BATCH_PAD)[None] < np.array([len(c) for c in clouds])[:, None])
        fps_cases.append((t(pts), bmask, DEFAULT_CONFIG.resample_pad, max(counts), label, batch, counts + counts))
    # run_largescan's one launch a run: both compacted survivor clouds, steps = pnumber.
    s_pts, s_mask, s_steps = scan["fps"]
    fps_cases.append((s_pts, s_mask, DEFAULT_CONFIG.resample_pad, s_steps,
                      f"large-scan resample: Room seed {scan['seed']}'s compacted octree survivors", "largescan"))
    # WLOP's start in 4j: one launch a 40960-point tools original, every step of 8000.
    from kss_icp_torch.challenge import _instance

    tools = load_tools()[0]["config"]
    fps_cases.append((t(_instance(0, 0, tools["n_points"], sample=0))[None].contiguous(),
                      torch.ones((1, tools["n_points"]), dtype=torch.bool, device=dev), tools["wlop_points"],
                      tools["wlop_points"], "WLOP start: a 40960-point tools original (4j)", "tools"))
    cases = []
    for pts, pmask, s, steps, label, batch, *picks in fps_cases:
        b_n, p_n = pmask.shape
        picks = np.array(picks[0] if picks else [steps] * b_n)
        ik, smk = fps(pts, pmask, s, steps)
        ip, smp = farthest_point_sampling(pts, pmask, s, steps)
        torch.cuda.synchronize()
        require(torch.equal(ik, ip) and torch.equal(smk, smp),
                f"fps {label}: indices differ at {int((ik != ip).sum())} of {b_n * s} picks")
        ms = time_ms(lambda: fps(pts, pmask, s, steps), 5)
        device_ms = graph_ms(lambda: fps(pts, pmask, s, steps), 5)
        plain_ms = time_ms(lambda: farthest_point_sampling(pts, pmask, s, steps), 1)
        # Per step and valid point: 3 sub + 3 mul + 2 add + 1 min + 1 compare. The
        # steps are a dependency chain the bound does not see (PERF.md).
        b = bound(10.0 * float((picks * pmask.sum(dim=1).cpu().numpy()).sum()),
                  4 * b_n * p_n * 3 + b_n * p_n + b_n * s * 5)
        cases.append(dict({"shape": f"{b_n}x{p_n}->{s}", "steps": steps, "label": label, "batch_pass": batch, "ms": ms,
                           "device_ms": device_ms, "plain_ms": plain_ms, "max_abs_err": 0.0}, **b))
        log(f"  fps B={b_n} P={p_n} S={s} steps={steps} ({label}): indices identical; {ms:.4f} ms a wrapper call "
            f"back to back, {device_ms:.4f} ms on the device (graph replay; centroid and mask ops included), "
            f"plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}; {steps} dependent steps)")
    out["fps"] = dict(cases[0], cases=cases, yardstick_ms=None, source="kss_icp_torch/csrc/fps.cu",
                      replaces="kss_icp_tpu/ops/resample_pallas.py:102")

    def field_inputs(steps, n, valid):
        """None: n - n/40 source and n - n/20 target rows valid; an int: both
        clouds suffix-masked to that many rows, as register_pair pads them."""
        src, tgt = t(cloud(rng, n)), t(cloud(rng, n))
        rows = torch.arange(n, device=dev)
        smask, tmask = (rows < n - n // 40, rows < n - n // 20) if valid is None else (rows < valid, rows < valid)
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
    # (grid steps, padded n, valid rows, label): the mostly valid cases; the
    # largest and smallest remesh pair's pnumber in register_pair's 2048 slots;
    # the bench config's 512-point prefixes, all valid from pnumber 512 on (23
    # of the 25 pairs).
    field_shapes = ((8, 2048, None, "base grid"), (16, 512, None, "escalation grid"),
                    (8, 2048, 1534, "base grid, largest remesh pair"), (8, 2048, 378, "base grid, smallest remesh pair"),
                    (8, 512, 512, "base grid, bench prefixes"))
    for name, kernel, plain, src_file, line, precisions in (
            ("field_ave", field_ave, field_ave_plain, "field.cu", 201, (None,)),
            ("field_dot", field_dot, field_dot_plain, "field_dot.cu", 218, ("highest", "default"))):
        cases = []
        for steps, n, valid, grid in field_shapes:
            args = field_inputs(steps, n, valid)
            c_n = args[4].shape[0]
            src, smask, tgt, tmask, rots = args
            if name == "field_ave":
                rotated, valid_tgt = rotate_sources(rots, src), tgt[tmask]
                yard = chunked(lambda a, z: torch.cdist(rotated[a:z], valid_tgt[None]).amin(-1), c_n)
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
                if valid is not None:  # masked rows skipped exactly: the padded clouds give their prefix's bits
                    require(torch.equal(fk, kernel(src[:valid], smask[:valid], tgt[:valid], tmask[:valid], rots, **kw)),
                            f"{label}: the padded clouds' field differs from their valid prefix's")
                err = float((fk - fp).abs().max())
                ms = time_ms(lambda: kernel(*args, **kw), 10)
                device_ms = graph_ms(lambda: kernel(*args, **kw), 10)  # rotation, kernels and division
                plain_ms = time_ms(lambda: plain(*args, **kw), 3)
                yard_ms = time_ms(yard, 3)
                evals = c_n * int(smask.sum()) * int(tmask.sum())
                b = bound(per_eval[prec][0] * evals, field_bytes(c_n, n), per_eval[prec][1] * evals)
                cases.append(dict({"shape": f"{c_n}x{n}x{n}", "label": grid, "precision": prec, "valid": valid,
                                   "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, "max_abs_err": err,
                                   "yardstick_ms": yard_ms}, **b))
                log(f"  {label} ({grid}): max|err| {err:.3g}; kernel {ms:.4f} ms a wrapper call back to back, "
                    f"{device_ms:.4f} ms on the device (graph replay), plain {plain_ms:.4f} ms, yardstick "
                    f"{yard_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}; valid rows only)")
        out[name] = dict(cases[0], cases=cases, yardstick=yard_label, source=f"kss_icp_torch/csrc/{src_file}",
                         replaces=f"kss_icp_tpu/ops/coarse_pallas.py:{line}")
    out["field_trim"] = phase_field_trim(torch, dev, rng)
    out["field_trim"]["squared"] = phase_field_sq(torch, dev, rng)
    phase_plain_knobs(torch, dev)
    return out


def phase_field_sq(torch, dev, rng) -> dict:
    """The field kernel's squared per-point mode (`field_sq`, the "max" and
    "diff" fields) against its plain version, bit for bit, at the 8^3 grid's
    padded clouds with ~70% scattered masks, the 16^3 grid's 512-point
    prefixes and a fully masked target (the biased path)."""
    from kss_icp_torch.core.transforms import euler_xyz_matrix
    from kss_icp_torch.models.coarse import rotation_grid
    from kss_icp_torch.ops.coarse_cuda import SQ_PLAIN, field_plan, field_sq, field_sq_distances, rotate_sources
    from kss_icp_torch.ops.nn import nn_sqdistances
    from kss_icp_torch.timing import graph_ms, time_ms

    def t(x):
        return torch.as_tensor(x, device=dev)

    cases = []
    for steps, n, t_kind, label in ((8, 2048, "inliers", "8^3 field, ~70% scattered masks"),
                                    (16, 512, "padded", "16^3 field at 512-point prefixes"),
                                    (8, 2048, "none", "8^3, target fully masked")):
        src, tgt = t(cloud(rng, n)), t(cloud(rng, n))
        rows = torch.arange(n, device=dev)
        smask = (rows < n - n // 40) & t(rng.uniform(size=n) < 0.7)
        tmask = {"inliers": (rows < n - n // 20) & t(rng.uniform(size=n) < 0.7), "padded": rows < n - n // 20,
                 "none": torch.zeros(n, dtype=torch.bool, device=dev)}[t_kind]
        rots = euler_xyz_matrix(rotation_grid(steps, 6.3, dev))
        c_n = rots.shape[0]
        rotated, weight = rotate_sources(rots, src), smask.to(torch.float32)
        dk = field_sq_distances(rotated, weight, tgt, tmask, field_plan(n))
        dp = nn_sqdistances(rotated, smask, tgt, tmask)
        torch.cuda.synchronize()
        require(torch.equal(dk, dp), f"field_sq {label}: squared distances differ from the plain version's bits at "
                                     f"{int((dk != dp).sum())} of {dk.numel()}")
        for metric, plain in SQ_PLAIN.items():
            require(torch.equal(field_sq(src, smask, tgt, tmask, rots, metric), plain(src, smask, tgt, tmask, rots)),
                    f"field_sq {label}: the {metric} field differs from the plain version's bits")
        args = (src, smask, tgt, tmask, rots, "max")
        ms = time_ms(lambda: field_sq(*args), 10)
        device_ms = graph_ms(lambda: field_sq(*args), 10)  # rotation, kernel and the row reduction
        kernel_ms = graph_ms(lambda: field_sq_distances(rotated, weight, tgt, tmask, field_plan(n)), 10)
        plain_ms = time_ms(lambda: SQ_PLAIN["max"](*args[:5]), 2)
        valid_tgt = tgt[tmask] if bool(tmask.any()) else tgt
        yard_ms = time_ms(lambda: [torch.cdist(rotated[a:a + 64], valid_tgt[None]).amin(-1)
                                   for a in range(0, c_n, 64)], 3)
        evals = c_n * int(smask.sum()) * (int(tmask.sum()) or n)
        b = bound(9.0 * evals, 4 * (n * 3 * 2 + c_n * 9 + c_n * n) + 2 * n)
        cases.append(dict({"shape": f"{c_n}x{n}x{n}", "label": label, "ms": ms, "device_ms": device_ms,
                           "kernel_device_ms": kernel_ms, "plain_ms": plain_ms, "max_abs_err": 0.0,
                           "yardstick_ms": yard_ms}, **b))
        log(f"  field_sq C={c_n} P=T={n} ({label}): squared distances and both fields identical; {ms:.4f} ms a "
            f"wrapper call back to back, {device_ms:.4f} ms on the device (graph replay; the kernel alone "
            f"{kernel_ms:.4f} ms), plain {plain_ms:.4f} ms, cdist+min {yard_ms:.4f} ms, bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
    return dict(cases[0], cases=cases, source="kss_icp_torch/csrc/field_trim.cu (kss_field_sq)",
                replaces="kss_icp_tpu/ops/nn.py:183-194 (the XLA max and diff fields, not a TPU kernel)",
                yardstick="torch.cdist(rotated, valid_target).amin(-1), 64 rotations a call")


def phase_plain_knobs(torch, dev) -> None:
    """Plain PyTorch timings that gate nothing: the AIVS resample at a remesh
    pair's two clouds and at the remesh batch's 50 clouds (full_pad 8192),
    PCA normals of one and of 25 resampled targets; and the AIVS determinism
    check: two runs of the 50-cloud batch pick the same points."""
    from kss_icp_torch.config import DEFAULT_CONFIG as cfg
    from kss_icp_torch.ops.aivs import aivs_resample_packed
    from kss_icp_torch.ops.normals import estimate_normals
    from kss_icp_torch.ops.spatial import estimate_box_scale
    from kss_icp_torch.timing import time_ms

    pairs = load_pairs()
    _, src, tgt = max(pairs, key=lambda r: cfg.resample_count(len(r[1]), len(r[2])))
    pn = cfg.resample_count(len(src), len(tgt))
    nb = estimate_box_scale(max(len(src), len(tgt)))
    pad = -(-max(len(src), len(tgt)) // 256) * 256

    def padded(clouds, rows):
        pts = np.zeros((len(clouds), rows, 3), np.float32)
        for i, c in enumerate(clouds):
            pts[i, :len(c)] = c
        mask = np.arange(rows)[None] < np.array([len(c) for c in clouds])[:, None]
        return torch.as_tensor(pts, device=dev), torch.as_tensor(mask, device=dev)

    pts, mask = padded([src, tgt], pad)
    counts = torch.tensor([pn, pn], device=dev)
    ms = time_ms(lambda: aivs_resample_packed(pts, mask, counts, cfg.resample_pad, nb), 3)
    log(f"  plain aivs_resample_packed, a remesh pair's source and target (B=2 x {pad}, {pn} picks, {nb}^3 boxes): "
        f"{ms:.3f} ms")
    counts = [cfg.resample_count(len(a), len(b)) for _, a, b in pairs]
    pts, mask = padded([a for _, a, _ in pairs] + [b for _, _, b in pairs], BATCH_PAD)
    pn = torch.tensor(counts + counts, device=dev)
    first = aivs_resample_packed(pts, mask, pn, cfg.resample_pad, 10)
    second = aivs_resample_packed(pts, mask, pn, cfg.resample_pad, 10)
    torch.cuda.synchronize()
    require(torch.equal(first[0], second[0]) and torch.equal(first[1], second[1]),
            "AIVS: two runs of the 50-cloud batch picked different points")
    ms = time_ms(lambda: aivs_resample_packed(pts, mask, pn, cfg.resample_pad, 10), 2)
    log(f"  plain aivs_resample_packed, the remesh batch (B=50 x {BATCH_PAD}, 10^3 boxes): {ms:.3f} ms; two runs "
        f"picked the same points")
    tpts = torch.as_tensor(np.stack([cloud(np.random.default_rng(i), cfg.resample_pad) for i in range(25)]),
                           device=dev)
    tmask = torch.arange(cfg.resample_pad, device=dev)[None] < torch.as_tensor(counts, device=dev)[:, None]
    for b in (1, 25):
        ms = time_ms(lambda: estimate_normals(tpts[:b], tmask[:b]), 5)
        log(f"  plain estimate_normals, {b} x {cfg.resample_pad} (k = 20): {ms:.3f} ms")


def phase_field_trim(torch, dev, rng) -> dict:
    """field_trim's per-point distances and trimmed field against the plain
    version, bit for bit, at the overlap rungs' full-resolution shapes."""
    from kss_icp_torch.core.transforms import euler_xyz_matrix
    from kss_icp_torch.models.coarse import rotation_grid
    from kss_icp_torch.ops.coarse_cuda import (field_plan, field_trim, field_trim_distances, field_trim_plain,
                                               rotate_sources)
    from kss_icp_torch.ops.nn import nn_distances
    from kss_icp_torch.timing import graph_ms, time_ms

    def t(x):
        return torch.as_tensor(x, device=dev)

    cases = []
    n = 2048
    # (grid steps, source mask, target mask, label): ~70% scattered inliers on
    # both clouds, as the overlap re-solves' masks are; a fully masked target.
    for steps, s_kind, t_kind, label in ((8, "inliers", "inliers", "8^3 overlap field, inlier masks"),
                                          (16, "padded", "padded", "16^3 overlap field"),
                                          (8, "padded", "none", "8^3, target fully masked")):
        src, tgt = t(cloud(rng, n)), t(cloud(rng, n))
        rows = torch.arange(n, device=dev)
        masks = {"inliers": lambda: (rows < 2000) & t(rng.uniform(size=n) < 0.7), "padded": lambda: rows < 2000,
                 "none": lambda: torch.zeros(n, dtype=torch.bool, device=dev)}
        smask, tmask = masks[s_kind](), masks[t_kind]()
        rots = euler_xyz_matrix(rotation_grid(steps, 6.3, dev))
        c_n = rots.shape[0]
        rotated, weight = rotate_sources(rots, src), smask.to(torch.float32)
        dk = field_trim_distances(rotated, weight, tgt, tmask, field_plan(n))
        dp = nn_distances(rotated, smask, tgt, tmask)
        fk = field_trim(src, smask, tgt, tmask, rots, 0.7)
        fp = field_trim_plain(src, smask, tgt, tmask, rots, 0.7)
        torch.cuda.synchronize()
        require(torch.equal(dk, dp), f"field_trim {label}: per-point distances differ from the plain version's bits "
                                     f"at {int((dk != dp).sum())} of {dk.numel()}")
        require(torch.equal(fk, fp), f"field_trim {label}: the trimmed field differs from the plain version's bits")
        args = (src, smask, tgt, tmask, rots, 0.7)
        ms = time_ms(lambda: field_trim(*args), 10)
        device_ms = graph_ms(lambda: field_trim(*args), 10)  # rotation, kernel and the trimmed mean
        kernel_ms = graph_ms(lambda: field_trim_distances(rotated, weight, tgt, tmask, field_plan(n)), 10)
        plain_ms = time_ms(lambda: field_trim_plain(*args), 2)
        valid_tgt = tgt[tmask] if bool(tmask.any()) else tgt
        yard_ms = time_ms(lambda: [torch.cdist(rotated[a:a + 64], valid_tgt[None]).amin(-1)
                                   for a in range(0, c_n, 64)], 3)
        # Per evaluation (rotation, valid source point, valid target row): 3 sub
        # + 3 mul + 2 add + 1 min; every row where the target has no valid one.
        evals = c_n * int(smask.sum()) * (int(tmask.sum()) or n)
        b = bound(9.0 * evals, 4 * (n * 3 * 2 + c_n * 9 + c_n * n) + 2 * n)
        err = float((fk - fp).abs().max())
        cases.append(dict({"shape": f"{c_n}x{n}x{n}", "label": label, "ms": ms, "device_ms": device_ms,
                           "kernel_device_ms": kernel_ms, "plain_ms": plain_ms, "max_abs_err": err,
                           "yardstick_ms": yard_ms}, **b))
        log(f"  field_trim C={c_n} P=T={n} ({label}): distances and field identical; {ms:.4f} ms a wrapper call back "
            f"to back, {device_ms:.4f} ms on the device (graph replay; the per-point kernel alone {kernel_ms:.4f} ms), "
            f"plain {plain_ms:.4f} ms, yardstick {yard_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    return dict(cases[0], cases=cases, source="kss_icp_torch/csrc/field_trim.cu",
                replaces="kss_icp_tpu/models/coarse.py:121 (the XLA trim path, not a TPU kernel)",
                yardstick="torch.cdist(rotated, valid_target).amin(-1), 64 rotations a call")


@functools.lru_cache(maxsize=None)
def load_boards():
    """The five boards' 64 pairs, [(board:name, source, target, ground truth)]
    (partial and partial_hard share pair names), and each pair's threshold."""
    from kss_icp_torch.challenge import BOARDS

    return tuple((f"{board}:{name}", src, tgt, gt, thr) for board, corpus, thr in BOARDS
                 for name, src, tgt, gt in corpus())


@functools.lru_cache(maxsize=None)
def load_largescan() -> dict:
    """JAX's large-scan record: per Room seed, the survivors, escalation, transform and answers."""
    return json.loads((FIXTURES / "torch_port_expected_largescan.json").read_text())


def largescan_inputs(torch, dev):
    """Phase 3's inputs at the large-scan path's shapes, made as run_largescan
    makes them, from the Room seed with the widest compacted pad: both
    compacted octree survivor clouds and their pnumber (fps), and the
    normalized source moved by JAX's recorded transform with the target (the
    metric's nn1)."""
    from kss_icp_torch import largescan
    from kss_icp_torch.config import DEFAULT_CONFIG
    from kss_icp_torch.core.transforms import Similarity, apply_similarity
    from kss_icp_torch.ops.simplify import octree_simplify

    record = load_largescan()
    rec = max(record["seeds"], key=lambda r: r["ds_pad"])
    scan = largescan.normalized_pair(record["n_points"], rec["seed"], dev)
    clouds = [octree_simplify(p, m, record["pre_downsample"]) for p, m in (scan.source, scan.target)]
    counts = [int(keep.sum()) for _, keep in clouds]
    pad = largescan.compacted_pad(*counts)
    pts, mask = zip(*(largescan.compact(p, keep, pad) for p, keep in clouds))
    pnumber = DEFAULT_CONFIG.resample_count(*counts)
    transform = Similarity(*(torch.tensor(rec[k], dtype=torch.float32, device=dev)
                             for k in ("scale", "rotation", "translation")))
    aligned = apply_similarity(transform, scan.source[0])
    return {"seed": rec["seed"], "fps": (torch.stack(pts), torch.stack(mask), pnumber),
            "metric": (aligned[None].contiguous(), scan.target[0][None].contiguous(),
                       scan.target[1][None].contiguous())}


def load_pairs():
    meta = json.loads((FIXTURES / "remesh_transfer.json").read_text())
    with np.load(FIXTURES / "remesh_transfer.npz") as z:
        return [(r["name"], np.asarray(z[r["name"] + "_src"], np.float32),
                 np.asarray(z[r["name"] + "_tgt"], np.float32)) for r in meta]


class StageTimer:
    """The register_pair / register_many `timer` hook: records which stages
    ran for the current pair, the ICP loops' lockstep iterations in each
    (models/icp.py's counter) and, with sync=True, their seconds (a sync at
    each border)."""

    def __init__(self, torch, sync: bool):
        from kss_icp_torch.models.icp import icp

        self.torch, self.sync, self.icp = torch, sync, icp
        self.seconds = defaultdict(float)
        self.iterations = defaultdict(int)
        self.ran = set()

    @contextlib.contextmanager
    def __call__(self, name):
        self.ran.add(name)
        if self.sync:
            self.torch.cuda.synchronize()
        t0, it0 = time.perf_counter(), self.icp.lockstep_iterations
        yield
        self.iterations[name] += self.icp.lockstep_iterations - it0
        if self.sync:
            self.torch.cuda.synchronize()
            self.seconds[name] += time.perf_counter() - t0


def nn1_histogram(nn1, label: str) -> dict:
    """nn1's launches since its counts were zeroed, by shape_key: logged, and returned."""
    shapes = sorted(nn1.launch_shapes.items(), key=lambda kv: -kv[1])
    log(f"  [{label}] nn1 launches by shape (L x Q x R, G reference clouds): " +
        ", ".join(f"{shape_key(*k)} {n}" for k, n in shapes))
    return {shape_key(*k): n for k, n in shapes}


def drive(torch, dev, cfg, pairs, counters, timer, label, judge, rung_log=None):
    """One pass of `pairs` through register_pair -> apply_similarity ->
    registration_measure, the launch counts zeroed just before it. Returns
    (rows, seconds, launches); judge(name, src, metrics, aligned) -> row.
    With a RungLog, each row carries the overlap rungs of its pair."""
    import kss_icp_torch as kt

    rows, total = [], 0.0
    for fn in counters.values():
        fn.launches = 0
    counters["nn1"].launch_shapes.clear()
    for name, src, tgt in pairs:
        timer.ran.clear()
        if rung_log is not None:
            rung_log.rungs = []
        t0 = time.perf_counter()
        res = kt.register_pair(src, tgt, cfg, device=dev, timer=timer)
        with timer("metric"):
            aligned = kt.apply_similarity(res.transform, torch.as_tensor(src, device=dev))
            m = kt.registration_measure(aligned, tgt, device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        total += dt
        rows.append(dict(judge(name, src, m, aligned), name=name, s=dt, cand=int(res.chosen_candidate),
                         fitness=float(res.fitness),
                         transform=[x.cpu().numpy() for x in res.transform],
                         iters=int(res.icp_iterations), continued="two_stage" in timer.ran,
                         escalated="escalate" in timer.ran,
                         won=res.coarse.field.shape[0] == cfg.escalate_rotation_steps and cfg.auto_escalate,
                         finisher="finish" in timer.ran,
                         rungs=[] if rung_log is None else rung_log.rungs))
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"  [{label}] kernel launches: {launches}")
    launches["nn1_shapes"] = nn1_histogram(counters["nn1"], label)
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


def check_launches(label, launches, method: str, overlap: bool = False) -> None:
    require(launches["nn1"] > 0 and launches["fps"] > 0, f"{label}: nn1 or fps never launched: {launches}")
    if not overlap:
        require(launches["field_trim"] == 0, f"{label}: field_trim launched without the overlap tier: {launches}")
    if method == "dot":
        require(launches["field_dot"] > 0 and launches["field_ave"] == 0,
                f"{label}: the dot pass must launch field_dot and not field_ave: {launches}")
    else:
        require(launches["field_ave"] > 0 and launches["field_dot"] == 0,
                f"{label}: a vpu pass must launch field_ave and not field_dot: {launches}")


def phase_end_to_end(torch, dev, kernels: dict) -> dict:
    from kss_icp_torch.challenge import BOARDS, transform_rmse
    from kss_icp_torch.config import DEFAULT_CONFIG
    from kss_icp_torch.ops.coarse_cuda import field_ave, field_dot, field_trim
    from kss_icp_torch.ops.nn_cuda import nn1
    from kss_icp_torch.ops.resample_cuda import fps

    counters = {"nn1": nn1, "fps": fps, "field_ave": field_ave, "field_dot": field_dot, "field_trim": field_trim}
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

    log("== 4c. escalation on (overlap_escalate=False): category, deform and scale boards")
    cfg = dataclasses.replace(DEFAULT_CONFIG, **esc)
    board_pairs, gt, threshold, jax_pass = [], {}, {}, {}
    for board, corpus, thr in BOARDS:
        if board not in esc_exp["boards"]:  # the partial boards need the overlap tier: 4d
            continue
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
    kernels["nn1"]["launch_shapes"] = out["passes"]["esc-default"]["launches"]["nn1_shapes"]
    kernels["field_dot"]["launches"] = out["passes"]["esc-dot"]["launches"]["field_dot"]
    return out


def phase_default_config(torch, dev, kernels: dict, e2e: dict) -> None:
    """4d: the unmodified DEFAULT_CONFIG, the overlap tier on, against
    fixtures/torch_port_expected_overlap.json."""
    from kss_icp_torch.challenge import BOARDS, transform_rmse
    from kss_icp_torch.config import DEFAULT_CONFIG as cfg
    from kss_icp_torch.ops.coarse_cuda import field_ave, field_dot, field_trim
    from kss_icp_torch.ops.nn_cuda import nn1
    from kss_icp_torch.ops.resample_cuda import fps

    counters = {"nn1": nn1, "fps": fps, "field_ave": field_ave, "field_dot": field_dot, "field_trim": field_trim}
    exp = json.loads((FIXTURES / "torch_port_expected_overlap.json").read_text())
    pairs = load_pairs()
    expected = {p["name"]: p for p in exp["pairs"]}
    judge = remesh_judge(torch, expected)
    label = "shipped"
    from kss_icp_torch.ladder_log import RungLog, rung_outcome
    from kss_icp_torch.models import kss_icp as tk

    with RungLog(tk, cfg.overlap_adopt_margin) as rung_log:
        rows, total, launches = drive(torch, dev, cfg, pairs, counters, StageTimer(torch, False), label, judge,
                                      rung_log)
        report_remesh(label, rows, total, expected, escalation=True)
        check_launches(label, launches, "vpu", overlap=True)
        counts = escalation_counts(label, rows, exp["pairs"])
        for r in rows:
            if r["rungs"] or expected[r["name"]]["rungs"]:
                log(f"  [{label}] {r['name']}: rungs {rung_outcome(r['rungs'])} "
                    f"(jax {rung_outcome(expected[r['name']]['rungs'])})")
        timer = StageTimer(torch, True)
        _, staged, _ = drive(torch, dev, cfg, pairs, counters, timer, label + " staged", judge, rung_log)
        log(f"  [{label}] stage seconds over all pairs (synced pass, {staged:.3f} s): " +
            ", ".join(f"{k} {v:.4f}" for k, v in timer.seconds.items()))
        log(f"  [{label}] lockstep ICP iterations by stage, summed over the pairs: " +
            ", ".join(f"{k} {v}" for k, v in timer.iterations.items() if v))
        e2e["passes"][label] = {"pairs_per_s": len(rows) / total, "seconds": total, "launches": launches,
                                "escalation": counts, "stage_seconds": dict(timer.seconds), "staged_seconds": staged,
                                "stage_iterations": dict(timer.iterations), "rows": rows}

        log("== 4d. DEFAULT_CONFIG: the five boards (64 pairs)")
        # Pairs are named board:pair, since partial and partial_hard share pair names.
        board_pairs, gt, threshold, jax_rows = [], {}, {}, {}
        for board, corpus, thr in BOARDS:
            for name, src, tgt, g in corpus():
                board_pairs.append((f"{board}:{name}", src, tgt))
                gt[f"{board}:{name}"], threshold[f"{board}:{name}"] = g, thr
            for p in exp["boards"][board]["pairs"]:
                jax_rows[f"{board}:{p['name']}"] = p

        def board_judge(name, src, m, aligned):
            pose = transform_rmse(aligned.cpu().numpy(), src, gt[name])
            return {"pose": pose, "passed": bool(pose <= threshold[name]), "rmse": m["rmse"]}

        timer = StageTimer(torch, True)
        rows, total, launches = drive(torch, dev, cfg, board_pairs, counters, timer, "shipped boards", board_judge,
                                      rung_log)
    check_launches("shipped boards", launches, "vpu", overlap=True)
    mismatched, runs, adopted = [], {"port": 0, "jax": 0}, {"port": 0, "jax": 0}
    for r in rows:
        j = jax_rows[r["name"]]
        agree = r["passed"] == j["passed"]
        for who, rungs in (("port", r["rungs"]), ("jax", j["rungs"])):
            runs[who] += sum(x["ran"] for x in rungs)
            adopted[who] += sum(x["adopted"] for x in rungs)
        log(f"  [shipped boards] {r['name']}: pose {r['pose']:.4f} {'pass' if r['passed'] else 'FAIL'} "
            f"(jax {j['pose_rmse']:.4f} {'pass' if j['passed'] else 'FAIL'}) esc {int(r['escalated'])} "
            f"rungs {rung_outcome(r['rungs'])} (jax {rung_outcome(j['rungs'])}) {r['s'] * 1e3:.1f} ms"
            f"{'' if agree else ' DIFFERS'}")
        if not agree and r["name"] != f"category:{KNIFE_EDGE}":
            mismatched.append(r["name"])
    require(not mismatched, f"shipped boards: pass/fail differs from JAX on the CPU: {mismatched}")
    partial = [r for r in rows if r["name"].startswith("partial")]
    require(any(x["ran"] for r in partial for x in r["rungs"]) and launches["field_trim"] > 0,
            f"shipped boards: no overlap rung ran on the partial boards: {launches}")
    screens = launches["nn1_shapes"].get(f"512x512x{cfg.resample_pad}", 0)
    ran_screen = sum(x["ran"] for r in rows for x in r["rungs"] if x["rung"] == "overlap_screen")
    require(screens >= ran_screen > 0,
            f"shipped boards: {ran_screen} screen rungs ran and nn1 saw {screens} 512-lane screen launches")
    passed = {b: [0, 0, 0] for b, _, _ in BOARDS}  # port, jax, pairs
    for r in rows:
        board = r["name"].split(":")[0]
        passed[board][0] += r["passed"]
        passed[board][1] += jax_rows[r["name"]]["passed"]
        passed[board][2] += 1
    log("  [shipped boards] " + ", ".join(f"{b} {p}/{n} (jax {j}/{n})" for b, (p, j, n) in passed.items()) +
        f"; overlap rungs run {runs['port']} (jax {runs['jax']}), adopted {adopted['port']} (jax {adopted['jax']}); "
        f"{len(rows) / total:.3f} pairs/s (synced)")
    log(f"  [shipped boards] stage seconds (synced pass, {total:.3f} s): " +
        ", ".join(f"{k} {v:.4f}" for k, v in timer.seconds.items()))
    log("  [shipped boards] lockstep ICP iterations by stage, summed over the pairs: " +
        ", ".join(f"{k} {v}" for k, v in timer.iterations.items() if v))
    e2e["passes"]["shipped boards"] = {"pairs_per_s": len(rows) / total, "seconds": total, "launches": launches,
                                       "passed": {b: v[0] for b, v in passed.items()}, "rungs_run": runs,
                                       "rungs_adopted": adopted, "stage_seconds": dict(timer.seconds),
                                       "stage_iterations": dict(timer.iterations), "rows": rows}
    kernels["field_trim"]["launches"] = launches["field_trim"]


def check_batch_launches(label, launches, n_pairs: int, ladder, cfg) -> None:
    """register_many's launches: one fps launch for the batch's resample; one
    field_ave launch a pair on the base grid and an escalated pair on the 16^3
    grid; one field_trim launch a pair, overlap solve and field rung run."""
    field_runs = sum(r["ran"] for rows in ladder.rungs for r in rows if r["rung"] != "overlap_screen")
    want = {"fps": 1, "field_ave": n_pairs + int(ladder.escalated.sum()), "field_dot": 0,
            "field_trim": cfg.overlap_iterations * field_runs}
    got = {k: launches[k] for k in want}
    require(got == want and launches["nn1"] > 0, f"{label}: launches {got}, expected {want} (nn1 {launches['nn1']})")


def drive_many(torch, dev, cfg, pairs, counters, timer, label):
    """One register_many call over `pairs` [(name, src, tgt)], the launch
    counts zeroed just before it. Returns (result, metrics, ladder, seconds,
    launches)."""
    import kss_icp_torch as kt
    from kss_icp_torch import escalate
    from kss_icp_torch.ladder_log import LadderLog

    for fn in counters.values():
        fn.launches = 0
    counters["nn1"].launch_shapes.clear()
    with LadderLog(escalate, len(pairs)) as ladder:
        t0 = time.perf_counter()
        res, metrics = kt.register_many([(a, b) for _, a, b in pairs], cfg, full_pad=BATCH_PAD, device=dev,
                                        timer=timer)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"  [{label}] kernel launches: {launches}")
    launches["nn1_shapes"] = nn1_histogram(counters["nn1"], label)
    return res, metrics, ladder, seconds, launches


def report_pair_difference(label, b, name, res, rmse, single) -> str:
    """Pair b of a register_many result against register_pair's row for it."""
    tr = [x[b].cpu().numpy() for x in res.transform]
    pose = max(float(np.abs(a - c).max()) for a, c in zip(tr, single["transform"]))
    return (f"  [{label}] {name}: vs register_pair: rmse {rmse:.6f} ({single['rmse']:.6f}), cand "
            f"{int(res.chosen_candidate[b])} ({single['cand']}), transform max|diff| {pose:.2e}")


def phase_many(torch, dev, kernels: dict, e2e: dict) -> None:
    """4e: register_many at the unmodified DEFAULT_CONFIG against
    fixtures/torch_port_expected_batch.json: the remesh 25 as one batch,
    then the five boards' 64 pairs as another."""
    import kss_icp_torch as kt
    from kss_icp_torch.challenge import transform_rmse
    from kss_icp_torch.config import DEFAULT_CONFIG as cfg
    from kss_icp_torch.ladder_log import rung_outcome
    from kss_icp_torch.ops.coarse_cuda import field_ave, field_dot, field_trim
    from kss_icp_torch.ops.nn_cuda import nn1
    from kss_icp_torch.ops.resample_cuda import fps

    counters = {"nn1": nn1, "fps": fps, "field_ave": field_ave, "field_dot": field_dot, "field_trim": field_trim}
    exp = json.loads((FIXTURES / "torch_port_expected_batch.json").read_text())
    pairs = load_pairs()
    expected = [p for p in exp["pairs"]]
    require([p["name"] for p in expected] == [n for n, _, _ in pairs], "the batch record's remesh pairs differ")
    drive_many(torch, dev, cfg, pairs[:5], counters, None, "warm-up")
    label = "many"
    torch.cuda.reset_peak_memory_stats(dev)
    res, metrics, ladder, seconds, launches = drive_many(torch, dev, cfg, pairs, counters, StageTimer(torch, False),
                                                         label)
    log(f"  [{label}] peak device memory {torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")
    check_batch_launches(label, launches, len(pairs), ladder, cfg)
    single = {r["name"]: r for r in e2e["passes"]["shipped"]["rows"]}
    failures = []
    for b, (name, src, _) in enumerate(pairs):
        j, rmse = expected[b], float(metrics["rmse"][b])
        ok = np.isfinite(rmse) and rmse <= j["rmse"] + RMSE_BAND and bool(ladder.escalated[b]) == j["escalated"]
        log(f"  [{label}] {name}: rmse {rmse:.6f} (jax {j['rmse']:.6f}) cand {int(res.chosen_candidate[b])} "
            f"(jax {j['chosen_candidate']}) esc {int(ladder.escalated[b])}/{int(j['escalated'])} "
            f"won {int(ladder.won[b])} fin {int(ladder.finisher[b])} rungs {rung_outcome(ladder.rungs[b])} "
            f"(jax {rung_outcome(j['rungs'])}) {'ok' if ok else 'FAIL'}")
        log(report_pair_difference(label, b, name, res, rmse, single[name]))
        if not ok:
            failures.append(name)
    require(not failures, f"{label}: pairs outside JAX RMSE + {RMSE_BAND} or escalated unlike JAX: {failures}")
    require(bool(torch.isfinite(res.transform.rotation).all()) and res.transform.rotation.shape == (len(pairs), 3, 3),
            f"{label}: transforms not finite or of the wrong shape")
    timer = StageTimer(torch, True)
    _, _, _, staged, _ = drive_many(torch, dev, cfg, pairs, counters, timer, label + " staged")
    per_pair = e2e["passes"]["shipped"]["stage_iterations"]
    log(f"  [{label}] {len(pairs)} pairs in one batch: {len(pairs) / seconds:.3f} pairs/s (no stage syncs; register_pair one "
        f"pair at a time in this run: {e2e['passes']['shipped']['pairs_per_s']:.3f} pairs/s)")
    log(f"  [{label}] stage seconds (synced pass, {staged:.3f} s): " +
        ", ".join(f"{k} {v:.4f}" for k, v in timer.seconds.items()))
    log(f"  [{label}] lockstep ICP iterations by stage: " +
        ", ".join(f"{k} {v} (one pair at a time: {per_pair.get(k, 0)})" for k, v in timer.iterations.items() if v))
    e2e["passes"][label] = {"pairs_per_s": len(pairs) / seconds, "seconds": seconds, "launches": launches,
                            "stage_seconds": dict(timer.seconds), "staged_seconds": staged,
                            "stage_iterations": dict(timer.iterations),
                            "transforms": [[x[b].cpu().numpy() for x in res.transform] for b in range(len(pairs))]}

    log("== 4e. register_many at DEFAULT_CONFIG: the five boards (64 pairs) as one batch")
    board_pairs = [(name, src, tgt) for name, src, tgt, _, _ in load_boards()]
    gt = {name: g for name, _, _, g, _ in load_boards()}
    threshold = {name: thr for name, _, _, _, thr in load_boards()}
    jax_rows = {f"{board}:{p['name']}": p for board, rec in exp["boards"].items() for p in rec["pairs"]}
    require(sorted(jax_rows) == sorted(gt), "the batch record's board pairs differ")
    label = "many boards"
    timer = StageTimer(torch, True)
    torch.cuda.reset_peak_memory_stats(dev)
    res, metrics, ladder, seconds, launches = drive_many(torch, dev, cfg, board_pairs, counters, timer, label)
    log(f"  [{label}] peak device memory {torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")
    check_batch_launches(label, launches, len(board_pairs), ladder, cfg)
    single = {r["name"]: r for r in e2e["passes"]["shipped boards"]["rows"]}
    mismatched, rungs_differ, runs, adopted = [], [], {"port": 0, "jax": 0}, {"port": 0, "jax": 0}
    for b, (name, src, _) in enumerate(board_pairs):
        j = jax_rows[name]
        row = kt.Similarity(*(x[b] for x in res.transform))
        aligned = kt.apply_similarity(row, torch.as_tensor(src, device=dev)).cpu().numpy()
        pose = transform_rmse(aligned, src, gt[name])
        passed = bool(pose <= threshold[name])
        ours = [(r["rung"], r["ran"], r["adopted"]) for r in ladder.rungs[b]]
        theirs = [(r["rung"], r["ran"], r["adopted"]) for r in j["rungs"]]
        for who, rungs in (("port", ladder.rungs[b]), ("jax", j["rungs"])):
            runs[who] += sum(x["ran"] for x in rungs)
            adopted[who] += sum(x["adopted"] for x in rungs)
        log(f"  [{label}] {name}: pose {pose:.4f} {'pass' if passed else 'FAIL'} (jax {j['pose_rmse']:.4f} "
            f"{'pass' if j['passed'] else 'FAIL'}) esc {int(ladder.escalated[b])}/{int(j['escalated'])} rungs "
            f"{rung_outcome(ladder.rungs[b])} (jax {rung_outcome(j['rungs'])})"
            f"{'' if passed == j['passed'] else ' DIFFERS'}")
        log(report_pair_difference(label, b, name, res, float(metrics["rmse"][b]), single[name]))
        if passed != j["passed"] and name != f"category:{KNIFE_EDGE}":
            mismatched.append(name)
        if ours != theirs or bool(ladder.escalated[b]) != j["escalated"]:
            rungs_differ.append(name)
    require(not mismatched, f"{label}: pass/fail differs from JAX's register_many on the CPU: {mismatched}")
    require(not rungs_differ, f"{label}: escalation or overlap rungs run and adopted unlike JAX: {rungs_differ}")
    require(runs["port"] > 0, f"{label}: no overlap rung ran")
    per_pair = e2e["passes"]["shipped boards"]["stage_iterations"]
    log(f"  [{label}] overlap rungs run {runs['port']} (jax {runs['jax']}), adopted {adopted['port']} "
        f"(jax {adopted['jax']}); {len(board_pairs) / seconds:.3f} pairs/s (synced; register_pair one pair at a "
        f"time, synced: {e2e['passes']['shipped boards']['pairs_per_s']:.3f})")
    log(f"  [{label}] stage seconds (synced pass, {seconds:.3f} s): " +
        ", ".join(f"{k} {v:.4f}" for k, v in timer.seconds.items()))
    log(f"  [{label}] lockstep ICP iterations by stage: " +
        ", ".join(f"{k} {v} (one pair at a time: {per_pair.get(k, 0)})" for k, v in timer.iterations.items() if v))
    e2e["passes"][label] = {"pairs_per_s": len(board_pairs) / seconds, "seconds": seconds, "launches": launches,
                            "stage_seconds": dict(timer.seconds), "stage_iterations": dict(timer.iterations),
                            "rungs_run": runs, "rungs_adopted": adopted}


def attach_pass_launches(kernels: dict, e2e: dict) -> None:
    """Each batch and large-scan shape of phase 3 takes its launches from the
    pass that runs it (`batch_pass`); nn1's `launch_shapes` (the esc-default
    pass's histogram) gains the shapes that only 4f (the large-scan metric)
    and 4k (the VCM owners, the Voronoi labels) launch, and fps's lists its
    cases' launches."""
    for name in ("nn1", "fps"):
        for case in kernels[name]["cases"]:
            if case["batch_pass"]:
                launches = e2e["passes"][case["batch_pass"]]["launches"]
                case["launches"] = launches["nn1_shapes"].get(case["shape"], 0) if name == "nn1" else launches["fps"]
    kernels["nn1"]["launch_shapes"] = dict(kernels["nn1"]["launch_shapes"], **{
        case["shape"]: e2e["passes"][case["batch_pass"]]["launches"]["nn1_shapes"].get(case["shape"], 0)
        for case in kernels["nn1"]["cases"] if case["batch_pass"] in ("largescan", "vcm", "voronoi")})
    kernels["fps"]["launch_shapes"] = {case["shape"]: case["launches"] for case in kernels["fps"]["cases"]
                                       if "launches" in case}


def phase_largescan(torch, dev, e2e: dict, card: str) -> None:
    """4f: run_largescan at 200k points and DEFAULT_CONFIG on Room seeds 0-2
    against fixtures/torch_port_expected_largescan.json."""
    from kss_icp_torch.config import DEFAULT_CONFIG as cfg
    from kss_icp_torch.largescan import run_largescan
    from kss_icp_torch.ops.coarse_cuda import field_ave, field_dot, field_trim
    from kss_icp_torch.ops.nn_cuda import nn1
    from kss_icp_torch.ops.resample_cuda import fps

    counters = {"nn1": nn1, "fps": fps, "field_ave": field_ave, "field_dot": field_dot, "field_trim": field_trim}
    record = load_largescan()
    total, shapes, rows, failures = defaultdict(int), defaultdict(int), [], []
    for rec in record["seeds"]:
        seed = rec["seed"]
        repeats = 2 if seed == 0 else 1  # bench.py:581-595
        label = f"largescan seed {seed}"
        for fn in counters.values():
            fn.launches = 0
        nn1.launch_shapes.clear()
        torch.cuda.reset_peak_memory_stats(dev)
        out = run_largescan(record["n_points"], record["pre_downsample"], cfg, seed, repeats=repeats, device=dev)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        launches = {k: fn.launches for k, fn in counters.items()}
        log(f"  [{label}] kernel launches ({repeats} run{'s' if repeats > 1 else ''}): {launches}")
        hist = nn1_histogram(nn1, label)
        metric = shape_key(1, rec["pad"], rec["pad"], 1)
        require(launches["fps"] == repeats and hist.get(metric, 0) == repeats and launches["nn1"] > repeats
                and launches["field_ave"] >= repeats and launches["field_dot"] == 0 and launches["field_trim"] == 0,
                f"{label}: launches {launches}, nn1 at {metric}: {hist.get(metric, 0)}; expected one fps launch "
                f"and one metric launch a run, the ICP's nn1 and field_ave, no field_dot or field_trim")
        for k, v in launches.items():
            total[k] += v
        for k, v in hist.items():
            shapes[k] += v
        checks = {
            "survivors": (out["n_s"], out["n_t"], out["resample_count"]) == (rec["n_s"], rec["n_t"], rec["pnumber"]),
            "escalation": out["escalated"] == rec["escalated"],
            "rmse": bool(np.isfinite(out["unit_rmse"])) and out["unit_rmse"] <= rec["unit_rmse"] + RMSE_BAND,
            "pose": bool(np.isfinite(out["pose_rmse"])) and out["pose_rmse"] < record["pose_bar"],
        }
        log(f"  [{label}] n_s {out['n_s']} n_t {out['n_t']} pnumber {out['resample_count']} (jax {rec['n_s']} "
            f"{rec['n_t']} {rec['pnumber']}); fitness {out['base_fitness']:.6g} -> {out['fitness']:.6g}, escalated "
            f"{int(out['escalated'])} won {int(out['escalation_won'])} (jax {rec['base_fitness']:.6g} -> "
            f"{rec['fitness']:.6g}, escalated {int(rec['escalated'])} won {int(rec['escalation_won'])}); unit RMSE "
            f"{out['unit_rmse']:.6f} (jax {rec['unit_rmse']:.6f}), RMSE {out['rmse']:.6f} m (jax {rec['rmse']:.6f}); "
            f"pose {out['pose_rmse']:.6f} m (jax on the CPU {rec['pose_rmse']:.6f}, bar {record['pose_bar']}) "
            + " ".join(f"{k} {'ok' if v else 'FAIL'}" for k, v in checks.items()))
        log(f"  [{label}] stage seconds (best of {repeats}): octree {out['octree_s']:.4f}, register "
            f"{out['register_s']:.4f}, metric {out['metric_s']:.4f}, total {out['total_s']:.4f}; first run "
            f"{out['compile_first_total_s']:.2f}; metric {out['metric_tflops']:.3f} TFLOP/s by JAX's count; fps "
            f"{launches['fps']} and nn1 {launches['nn1']} launches; peak device memory {peak:.1f} MiB ({card})")
        if not all(checks.values()):
            failures.append((seed, [k for k, v in checks.items() if not v]))
        rows.append(dict(out, seed=seed, repeats=repeats, launches=launches, peak_mib=peak))
    require(not failures, f"largescan: seeds failing their gates against JAX's record: {failures}")
    e2e["passes"]["largescan"] = {"launches": dict(total, nn1_shapes=dict(shapes)), "seeds": rows}


PRECISE_FRACS = (0.25, 0.5)  # the CLI's --precise (kss_icp_torch/cli.py::_cfg_from_args)


def phase_precise(torch, dev, kernels: dict, e2e: dict, card: str) -> None:
    """4g: precision mode, DEFAULT_CONFIG with neighborhood_fracs=(0.25, 0.5),
    against fixtures/torch_port_expected_precise.json (JAX's register_pair on
    the CPU): the remesh 25 and the category board one pair at a time, then
    the remesh 25 as one register_many batch."""
    from kss_icp_torch.challenge import BOARDS, transform_rmse
    from kss_icp_torch.config import DEFAULT_CONFIG
    from kss_icp_torch.ops.coarse_cuda import field_ave, field_dot, field_trim
    from kss_icp_torch.ops.nn_cuda import nn1
    from kss_icp_torch.ops.resample_cuda import fps

    counters = {"nn1": nn1, "fps": fps, "field_ave": field_ave, "field_dot": field_dot, "field_trim": field_trim}
    cfg = dataclasses.replace(DEFAULT_CONFIG, neighborhood_fracs=PRECISE_FRACS)
    exp = json.loads((FIXTURES / "torch_port_expected_precise.json").read_text())
    lanes = 6 * len(PRECISE_FRACS)
    polish = shape_key(lanes, cfg.resample_pad, cfg.resample_pad, 1)
    pairs = load_pairs()
    expected = {p["name"]: p for p in exp["pairs"]}
    shipped = {r["name"]: r for r in e2e["passes"]["shipped"]["rows"]}
    label = "precise"
    rows, total, launches = drive(torch, dev, cfg, pairs, counters, StageTimer(torch, False), label,
                                  remesh_judge(torch, expected))
    report_remesh(label, rows, total, expected, escalation=True)
    check_launches(label, launches, "vpu", overlap=True)
    require(launches["nn1_shapes"].get(polish, 0) > len(pairs),
            f"{label}: the polish's {polish} nn1 launches: {launches['nn1_shapes'].get(polish, 0)}")

    def restarts(label, rows, unpolished, jax_won, key=lambda n: n):
        """Each pair's fitness against the same pair's unpolished run in this
        call: never above it; a restart won where it is below (JAX: below its
        DEFAULT_CONFIG record)."""
        worse = [r["name"] for r in rows if r["fitness"] > unpolished[key(r["name"])]["fitness"]]
        won = [r["name"] for r in rows if r["fitness"] < unpolished[key(r["name"])]["fitness"]]
        log(f"  [{label}] a restart won on {len(won)}/{len(rows)} pairs (jax {len(jax_won)}): {' '.join(won)}; "
            f"jax: {' '.join(jax_won)}")
        require(not worse, f"{label}: fitness above the unpolished run's on {worse}")
        return won

    won = restarts(label, rows, shipped, [n for n, p in expected.items() if p["restart_won"]])
    counts = escalation_counts(label, rows, exp["pairs"])
    timer = StageTimer(torch, True)
    _, staged, _ = drive(torch, dev, cfg, pairs, counters, timer, label + " staged", remesh_judge(torch, expected))
    log(f"  [{label}] stage seconds over all pairs (synced pass, {staged:.3f} s): " +
        ", ".join(f"{k} {v:.4f}" for k, v in timer.seconds.items()))
    log(f"  [{label}] lockstep ICP iterations by stage, summed over the pairs: " +
        ", ".join(f"{k} {v}" for k, v in timer.iterations.items() if v) +
        f"; the polish {timer.seconds['polish']:.4f} s and {timer.iterations['polish']} iterations over "
        f"{len(pairs)} pairs and {counts['port']['escalated']} re-solves")
    log(f"  [{label}] {len(pairs) / total:.3f} pairs/s with the polish, {e2e['passes']['shipped']['pairs_per_s']:.3f} "
        f"without (4d, this call; no stage syncs) ({card})")
    e2e["passes"][label] = {"pairs_per_s": len(pairs) / total, "seconds": total, "launches": launches,
                            "escalation": counts, "restarts_won": won, "stage_seconds": dict(timer.seconds),
                            "staged_seconds": staged, "stage_iterations": dict(timer.iterations), "rows": rows}

    log("== 4g. precision mode: the category board (32 pairs)")
    corpus, thr = next((c, t) for b, c, t in BOARDS if b == "category")
    board = [(name, src, tgt) for name, src, tgt, _ in corpus()]
    gt = {name: g for name, _, _, g in corpus()}
    jax_rows = {p["name"]: p for p in exp["boards"]["category"]["pairs"]}
    unpolished = {r["name"]: r for r in e2e["passes"]["shipped boards"]["rows"]}
    default = {p["name"]: p for p in json.loads((FIXTURES / "torch_port_expected_overlap.json").read_text())
               ["boards"]["category"]["pairs"]}

    def board_judge(name, src, m, aligned):
        pose = transform_rmse(aligned.cpu().numpy(), src, gt[name])
        return {"pose": pose, "passed": bool(pose <= thr), "rmse": m["rmse"]}

    label = "precise category"
    timer = StageTimer(torch, True)
    rows, total, launches = drive(torch, dev, cfg, board, counters, timer, label, board_judge)
    check_launches(label, launches, "vpu", overlap=True)
    mismatched = []
    for r in rows:
        j, u = jax_rows[r["name"]], unpolished[f"category:{r['name']}"]
        agree = r["passed"] == j["passed"]
        log(f"  [{label}] {r['name']}: pose {r['pose']:.4f} {'pass' if r['passed'] else 'FAIL'} (jax "
            f"{j['pose_rmse']:.4f} {'pass' if j['passed'] else 'FAIL'}; unpolished {u['pose']:.4f}, jax "
            f"{default[r['name']]['pose_rmse']:.4f}) fitness {r['fitness']:.6g} (unpolished {u['fitness']:.6g}) "
            f"esc {int(r['escalated'])} {r['s'] * 1e3:.1f} ms{'' if agree else ' DIFFERS'}")
        if not agree and r["name"] != KNIFE_EDGE:
            mismatched.append(r["name"])
    require(not mismatched, f"{label}: pass/fail differs from JAX on the CPU: {mismatched}")
    won = restarts(label, rows, unpolished, [n for n, p in jax_rows.items() if p["restart_won"]],
                   key=lambda n: f"category:{n}")
    tube = next(r for r in rows if r["name"] == "tube/1")
    log(f"  [{label}] tube/1: pose {tube['pose']:.6f} (jax {jax_rows['tube/1']['pose_rmse']:.6f}); without the polish "
        f"{unpolished['category:tube/1']['pose']:.6f} (jax {default['tube/1']['pose_rmse']:.6f})")
    base_s = sum(unpolished[f"category:{n}"]["s"] for n, _, _ in board)
    passed = sum(r["passed"] for r in rows)
    log(f"  [{label}] {passed}/{len(rows)} pass (jax {sum(p['passed'] for p in jax_rows.values())}/{len(rows)}); "
        f"{len(rows) / total:.3f} pairs/s with the polish, {len(rows) / base_s:.3f} without (4d's rows; both synced) "
        f"({card})")
    log(f"  [{label}] stage seconds (synced pass, {total:.3f} s): " +
        ", ".join(f"{k} {v:.4f}" for k, v in timer.seconds.items()) + "; lockstep ICP iterations: " +
        ", ".join(f"{k} {v}" for k, v in timer.iterations.items() if v))
    e2e["passes"][label] = {"pairs_per_s": len(rows) / total, "seconds": total, "launches": launches,
                            "passed": passed, "restarts_won": won, "stage_seconds": dict(timer.seconds),
                            "stage_iterations": dict(timer.iterations), "tube1_pose": tube["pose"]}

    log("== 4g. precision mode: the remesh 25 as one register_many batch")
    label = "precise many"
    res, metrics, ladder, seconds, launches = drive_many(torch, dev, cfg, pairs, counters, StageTimer(torch, False),
                                                         label)
    check_batch_launches(label, launches, len(pairs), ladder, cfg)
    batch_polish = shape_key(lanes * len(pairs), cfg.resample_pad, cfg.resample_pad, len(pairs))
    require(launches["nn1_shapes"].get(batch_polish, 0) > 0, f"{label}: no {batch_polish} polish launch")
    single = {r["name"]: r for r in e2e["passes"]["precise"]["rows"]}
    failures = []
    for b, (name, _, _) in enumerate(pairs):
        rmse = float(metrics["rmse"][b])
        if not (np.isfinite(rmse) and rmse <= expected[name]["rmse"] + RMSE_BAND):
            failures.append(name)
        log(report_pair_difference(label, b, name, res, rmse, single[name]) +
            f"; fitness {float(res.fitness[b]):.6g} ({single[name]['fitness']:.6g})")
    require(not failures, f"{label}: pairs outside JAX's precise RMSE + {RMSE_BAND}: {failures}")
    log(f"  [{label}] {len(pairs) / seconds:.3f} pairs/s in one batch (no stage syncs; one pair at a time "
        f"{e2e['passes']['precise']['pairs_per_s']:.3f}) ({card})")
    e2e["passes"][label] = {"pairs_per_s": len(pairs) / seconds, "seconds": seconds, "launches": launches}


def device_busy(trace_path: Path) -> dict:
    """The device's busy share in a torch.profiler chrome trace: the union of
    its kernel, memcpy and memset intervals over the trace's span (every
    host and device event), and over the span from the first device event
    to the last; the device time of the six busiest kernels by name, and
    every kernel's name."""
    events = [e for e in json.loads(trace_path.read_text())["traceEvents"] if e.get("ph") == "X" and "ts" in e]
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    if not device:
        return {}
    busy, end = 0.0, -np.inf
    for a, z in device:
        busy += max(0.0, z - max(a, end))
        end = max(end, z)
    first = min(float(e["ts"]) for e in events)
    last = max(float(e["ts"]) + float(e.get("dur", 0)) for e in events)
    by_name = defaultdict(float)
    for e in events:
        if e.get("cat") == "kernel":
            by_name[e["name"][:60]] += float(e.get("dur", 0))
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:6])
    return {"kernel_names": set(by_name), "busy_us": busy, "span_us": last - first, "share": busy / (last - first),
            "device_span_us": device[-1][1] - device[0][0], "share_of_device_span": busy / (device[-1][1] - device[0][0]),
            "device_events": len(device), "top_kernels_us": top}


def phase_cli(torch, dev, e2e: dict, card: str) -> None:
    """4h: the command line on the card, `python -m kss_icp_torch` subprocesses
    at their default device on the remesh 25 written to files with the
    port's io and transfer modules."""
    import io
    import tempfile

    from kss_icp_torch import cli
    from kss_icp_torch.challenge import BOARDS, transform_rmse
    from kss_icp_torch.config import DEFAULT_CONFIG
    from kss_icp_torch.io.formats import load_points, save_xyz
    from kss_icp_torch.largescan import room_pair
    from kss_icp_torch.ops.coarse_cuda import field_ave, field_dot, field_trim
    from kss_icp_torch.ops.nn_cuda import nn1
    from kss_icp_torch.ops.resample_cuda import fps
    from kss_icp_torch.transfer import TransferRecord, save_transfer_log, unapply_record

    counters = {"nn1": nn1, "fps": fps, "field_ave": field_ave, "field_dot": field_dot, "field_trim": field_trim}
    cli_launches = dict.fromkeys(counters, 0)

    meta = json.loads((FIXTURES / "remesh_transfer.json").read_text())
    pairs = load_pairs()
    batch_exp = {p["name"]: p for p in json.loads((FIXTURES / "torch_port_expected_batch.json").read_text())["pairs"]}
    pair_exp = {p["name"]: p for p in json.loads((FIXTURES / "torch_port_expected_overlap.json").read_text())["pairs"]}
    precise_exp = json.loads((FIXTURES / "torch_port_expected_precise.json").read_text())
    walls = {}

    def run(label, *args, stdin=None, timeout=600):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "kss_icp_torch", *map(str, args)], input=stdin, capture_output=True,
                           text=True, timeout=timeout, cwd=REPO)
        walls[label] = time.perf_counter() - t0
        log(f"  [cli] {label}: exit {r.returncode}, {walls[label]:.2f} s wall ({nvidia_smi()})")
        require(r.returncode == 0, f"cli {label}: exit {r.returncode}\n{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
        return r.stdout

    def in_process(label, args, want):
        """One command through kss_icp_torch.cli.main in this process, the
        launch counts zeroed just before it and read just after: the CLI's
        own launches, each kernel's gated by want[kernel](count, nn1 shapes)."""
        for fn in counters.values():
            fn.launches = 0
        counters["nn1"].launch_shapes.clear()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rc = cli.main([str(a) for a in args])
        require(rc == 0, f"cli.main {label}: exit {rc}\n{out.getvalue()[-2000:]}")
        launches = {k: fn.launches for k, fn in counters.items()}
        shapes = nn1_histogram(counters["nn1"], f"cli.main {label}")
        log(f"  [cli.main {label}] kernel launches: {launches}")
        bad = [k for k, ok in want.items() if not ok(launches[k], shapes)]
        require(not bad, f"cli.main {label}: launches of {bad} not as the command's path needs: {launches}")
        for k, n in launches.items():
            cli_launches[k] += n

    def printed(text, key):
        return float(next(ln.split()[-1] for ln in text.splitlines() if ln.startswith(key + ":")))

    def table(text, names):
        """The per-pair lines of batch: {name: RMSE}."""
        out = {}
        for ln in text.splitlines():
            parts = ln.split()
            if parts and parts[0] in names:
                out[parts[0]] = float(next(p for p in parts if p.startswith("RMSE=")).split("=")[1])
        return out

    with tempfile.TemporaryDirectory(prefix="kss_cli_") as tmp:
        d = Path(tmp) / "remesh"
        d.mkdir()
        records = []
        for rec, (name, src, tgt) in zip(meta, pairs):
            save_xyz(d / f"{name}.gird", src)
            save_xyz(d / f"{name}.wlop", tgt)
            records.append(TransferRecord(name, rec["axis"], rec["angle"], rec["scale"], rec["translation"]))
        save_transfer_log(d / "transfer.txt", records)
        names = [n for n, _, _ in pairs]

        # bench-dir: the remesh 25 as one batch, pose-scored from transfer.txt.
        out = Path(tmp) / "bench.json"
        text = run("bench-dir", "bench-dir", d, "--json", out)
        summary = json.loads(out.read_text())
        failures = [r["name"] for r in summary["rows"] if not r["rmse"] <= batch_exp[r["name"]]["rmse"] + RMSE_BAND]
        rec_by = {r.name: r for r in records}
        ours = {}
        for (name, src, _), tr in zip(pairs, e2e["passes"]["many"]["transforms"]):
            aligned = src @ tr[1].T * tr[0] + tr[2]
            diff = aligned - unapply_record(src, rec_by[name])
            ours[name] = float(np.sqrt(np.mean(np.sum(diff * diff, axis=-1))))
        cli_pass = {r["name"] for r in summary["rows"] if r["pose_ok"]}
        many_pass = {n for n, pose in ours.items() if pose <= 0.2}
        for r in summary["rows"]:
            log(f"  [cli bench-dir] {r['name']}: rmse {r['rmse']:.6f} (jax batch {batch_exp[r['name']]['rmse']:.6f}) "
                f"pose {r['pose_rmse']:.5f} (4e {ours[r['name']]:.5f})")
        log(f"  [cli bench-dir] " + ", ".join(f"{k} {v}" for k, v in summary.items() if k != "rows") +
            f"; {text.splitlines()[-2] if len(text.splitlines()) > 1 else ''}")
        require(not failures, f"cli bench-dir: pairs outside JAX's batch RMSE + {RMSE_BAND}: {failures}")
        require(cli_pass == many_pass, f"cli bench-dir: pose pass set {sorted(cli_pass)} differs from 4e's "
                                       f"{sorted(many_pass)}")

        # batch: one pair at a time, then --batched.
        listing = Path(tmp) / "list.txt"
        listing.write_text("".join(n + "\n" for n in names))
        for label, flag, exp in (("batch", (), pair_exp), ("batch --batched", ("--batched",), batch_exp)):
            text = run(label, "batch", listing, d, *flag)
            rmse = table(text, set(names))
            bad = [n for n in names if not rmse.get(n, np.inf) <= exp[n]["rmse"] + RMSE_BAND]
            log(f"  [cli {label}] {len(rmse)} pairs, RMSE within JAX + {RMSE_BAND} on {len(names) - len(bad)}; "
                f"{next(ln for ln in text.splitlines() if ln.startswith('TOTAL'))}")
            require(not bad, f"cli {label}: pairs outside JAX's RMSE + {RMSE_BAND}: {bad}")

        # register -o, then measure the file it wrote.
        name = names[0]
        aligned = Path(tmp) / "aligned.xyz"
        text = run("register", "register", d / f"{name}.gird", d / f"{name}.wlop", "-o", aligned, "--json")
        reg = json.loads(text.splitlines()[-1])
        meas = run("measure", "measure", aligned, d / f"{name}.wlop")
        rel = abs(printed(meas, "RMSE") - printed(text, "RMSE")) / printed(text, "RMSE")
        log(f"  [cli register/measure] {name}: register RMSE {reg['rmse']:.9g} (printed {printed(text, 'RMSE')}), "
            f"measure of the file {printed(meas, 'RMSE')}: relative difference {rel:.2e}; register {reg['time_s']:.3f} s")
        require(rel <= 1e-6 and reg["rmse"] <= pair_exp[name]["rmse"] + RMSE_BAND,
                f"cli register/measure: {reg['rmse']} vs {printed(meas, 'RMSE')} (jax {pair_exp[name]['rmse']})")

        # register --precise on tube/1 of the category board.
        corpus = next(c for b, c, _ in BOARDS if b == "category")
        _, src, tgt, gt = next(p for p in corpus() if p[0] == "tube/1")
        save_xyz(Path(tmp) / "tube1.gird", src)
        save_xyz(Path(tmp) / "tube1.wlop", tgt)
        text = run("register --precise", "register", Path(tmp) / "tube1.gird", Path(tmp) / "tube1.wlop", "-o",
                   aligned, "--precise", "--json")
        reg = json.loads(text.splitlines()[-1])
        src_file = load_points(Path(tmp) / "tube1.gird")
        pose = transform_rmse(load_points(aligned), src_file, gt)
        j = next(p for p in precise_exp["boards"]["category"]["pairs"] if p["name"] == "tube/1")
        log(f"  [cli register --precise] tube/1: rmse {reg['rmse']:.6f} (jax {j['rmse']:.6f}), pose {pose:.6f} "
            f"(jax {j['pose_rmse']:.6f}; 4g {e2e['passes']['precise category']['tube1_pose']:.6f}), "
            f"{reg['time_s']:.3f} s")
        require(reg["rmse"] <= j["rmse"] + RMSE_BAND and pose <= 0.2, f"cli register --precise: tube/1 {reg}, {pose}")

        # resample, simplify -m octree and largescan on Room seed 0.
        record = load_largescan()
        rec0 = next(r for r in record["seeds"] if r["seed"] == 0)
        room_src, _, _ = room_pair(record["n_points"], 0)
        room = Path(tmp) / "room0.xyz"
        save_xyz(room, room_src)
        room_rows = {tuple(p) for p in load_points(room)}
        for label, args, want in (("resample", ("resample", room, Path(tmp) / "rs.xyz", "-n", 2000), 2000),
                                  ("simplify -m octree", ("simplify", room, Path(tmp) / "oct.xyz", "-m", "octree",
                                                          "-n", record["pre_downsample"]), None)):
            text = run(label, *args)
            got = load_points(args[2])
            subset = all(tuple(p) in room_rows for p in got)
            log(f"  [cli {label}] {text.strip()}; every point one of the input's: {subset}"
                + ("" if want else f" (the normalized scan's octree in 4f keeps {rec0['n_s']})"))
            require(subset and (len(got) == want if want else 0 < len(got) < len(room_src)),
                    f"cli {label}: {len(got)} points, subset {subset}")
        text = run("largescan", "largescan", "--seed", 0)
        out = json.loads(text.splitlines()[-1])
        checks = {
            "survivors": (out["n_s"], out["n_t"], out["resample_count"]) == (rec0["n_s"], rec0["n_t"], rec0["pnumber"]),
            "escalation": out["escalated"] == rec0["escalated"],
            "rmse": bool(np.isfinite(out["unit_rmse"])) and out["unit_rmse"] <= rec0["unit_rmse"] + RMSE_BAND,
            "pose": bool(np.isfinite(out["pose_rmse"])) and out["pose_rmse"] < record["pose_bar"],
        }
        log(f"  [cli largescan] seed 0: n_s {out['n_s']} n_t {out['n_t']} unit RMSE {out['unit_rmse']:.6f} (jax "
            f"{rec0['unit_rmse']:.6f}) pose {out['pose_rmse']:.6f} total_s {out['total_s']} (first run "
            f"{out['compile_first_total_s']}) " + " ".join(f"{k} {'ok' if v else 'FAIL'}" for k, v in checks.items()))
        require(all(checks.values()), f"cli largescan: {checks}")

        # serve: three good requests and one bad one.
        reqs = [json.dumps({"source": str(d / f"{n}.gird"), "target": str(d / f"{n}.wlop")}) for n in names[:3]]
        reqs.insert(2, json.dumps({"source": str(d / "missing.gird"), "target": str(d / f"{names[0]}.wlop")}))
        text = run("serve", "serve", stdin="\n".join(reqs) + "\n")
        lines = [json.loads(ln) for ln in text.splitlines() if ln.strip()]
        good = [ln for ln in lines[1:] if ln.get("ok") is True]
        bad = [ln for ln in lines[1:] if ln.get("ok") is False]
        for ln in lines[1:]:
            log(f"  [cli serve] " + (f"{Path(ln['source']).stem}: rmse {ln['rmse']:.6f} (jax batch "
                                     f"{batch_exp[Path(ln['source']).stem]['rmse']:.6f}) {ln['time_s']} s"
                                     if ln["ok"] else f"error: {ln['error']}"))
        require(lines[0].get("event") == "ready" and len(good) == 3 and len(bad) == 1 and
                all(ln["rmse"] <= batch_exp[Path(ln["source"]).stem]["rmse"] + RMSE_BAND for ln in good),
                f"cli serve: {lines}")

        # The same commands in this process: which kernels the CLI's own runs launch.
        launched = lambda n, _: n > 0  # noqa: E731
        silent = lambda n, _: n == 0  # noqa: E731
        pad = DEFAULT_CONFIG.resample_pad
        polish = shape_key(6 * len(PRECISE_FRACS), pad, pad, 1)
        in_process("register", ("register", d / f"{name}.gird", d / f"{name}.wlop"),
                   {"nn1": launched, "fps": launched, "field_ave": launched, "field_dot": silent})
        in_process("register --precise", ("register", Path(tmp) / "tube1.gird", Path(tmp) / "tube1.wlop", "--precise"),
                   {"nn1": lambda n, shapes: shapes.get(polish, 0) > 0, "fps": launched, "field_ave": launched,
                    "field_dot": silent})
        in_process("register --overlap", ("register", d / f"{name}.gird", d / f"{name}.wlop", "--overlap"),
                   {"nn1": launched, "fps": launched, "field_trim": launched, "field_dot": silent})
        in_process("bench-dir", ("bench-dir", d, "--json", Path(tmp) / "bench_in_process.json"),
                   {"nn1": launched, "fps": lambda n, _: n == 1, "field_ave": lambda n, _: n >= len(names),
                    "field_dot": silent})
        log(f"  [cli.main] launches over the four commands: {cli_launches}")

        # register --profile: one register pass's trace.
        prof = Path(tmp) / "profile"
        run("register --profile", "register", d / f"{name}.gird", d / f"{name}.wlop", "--profile", prof)
        trace = prof / "trace.json"
        require(trace.exists(), "cli register --profile wrote no trace.json")
        # The same trace of a warm pass in this process, whose kernels, cuSOLVER
        # and allocator are set up: the CLI's pass is its process's first.
        import kss_icp_torch as kt
        from torch.profiler import ProfilerActivity, profile

        kt.register_pair(pairs[0][1], pairs[0][2], device=dev)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as warm_prof:
            kt.register_pair(pairs[0][1], pairs[0][2], device=dev)
            torch.cuda.synchronize()
        warm_prof.export_chrome_trace(str(Path(tmp) / "warm.json"))
        busy = {"cli": device_busy(trace), "warm": device_busy(Path(tmp) / "warm.json")}
        names_in_trace = busy["cli"].get("kernel_names", set())
        missing = [k for k in ("nn1_kernel", "fps_kernel", "field_partial_kernel")
                   if not any(k in n for n in names_in_trace)]
        require(not missing, f"cli register --profile: the trace holds no {missing} (kernels: {sorted(names_in_trace)})")
        for label, b in busy.items():
            if not b:
                log(f"  [{label} register trace] no device events: device busy share not measured")
                continue
            log(f"  [{label} register trace] {name}: device busy {b['busy_us'] / 1e3:.3f} ms of the trace's "
                f"{b['span_us'] / 1e3:.3f} ms: busy share {b['share']:.4f}; of the span from the first device "
                f"event to the last ({b['device_span_us'] / 1e3:.3f} ms) {b['share_of_device_span']:.4f}; "
                f"{b['device_events']} device events; the busiest kernels' device us: "
                + "; ".join(f"{k} {v:.1f}" for k, v in b["top_kernels_us"].items()) + f" ({card})")
    log(f"  [cli] wall seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in walls.items()) + f" ({card})")
    for b in busy.values():
        b.pop("kernel_names", None)
    e2e["passes"]["cli"] = {"walls": walls, "busy": busy, "launches": cli_launches}


def knob_launches(label, launches, knobs: dict) -> None:
    """A knob pass's launches: nn1 always; fps unless AIVS resamples; field_sq
    for the "max" and "diff" fields and field_ave for the others."""
    require(launches["nn1"] > 0, f"{label}: nn1 never launched: {launches}")
    aivs, sq = knobs.get("resampler") == "aivs", knobs.get("coarse_error_metric") in ("max", "diff")
    require((launches["fps"] == 0) == aivs, f"{label}: fps launches {launches['fps']} with resampler "
                                            f"{'aivs' if aivs else 'fps'}")
    require((launches["field_sq"] > 0) == sq and (launches["field_ave"] > 0) != sq and launches["field_dot"] == 0,
            f"{label}: the field kernels launched unlike the metric's path: {launches}")


def aivs_picks(torch, dev, src, tgt):
    """register_pair's AIVS resample of a remesh pair, as it runs it: each
    cloud padded by PointCloud.from_points, the boxes from max(n_s, n_t).
    Returns ({side: source indices of the packed valid rows}, {side: the
    lockstep FPS's selection before the cut})."""
    from kss_icp_torch.config import DEFAULT_CONFIG
    from kss_icp_torch.core.cloud import PointCloud
    from kss_icp_torch.models import kss_icp as tk
    from kss_icp_torch.ops.aivs import box_quotas, stratified_fps
    from kss_icp_torch.ops.spatial import build_voxel_grid

    cfg = dataclasses.replace(DEFAULT_CONFIG, resampler="aivs")
    pn = cfg.resample_count(len(src), len(tgt))
    cfg = tk._resolve_aivs_boxes(cfg, max(len(src), len(tgt)))
    picks, before_cut = {}, {}
    for side, pts in (("source", src), ("target", tgt)):
        c = PointCloud.from_points(pts, device=dev)
        rp, rm = tk.resample_batch(c.points[None], c.mask[None], torch.tensor([pn], device=dev), cfg)
        rows = rp[0][rm[0]].cpu().numpy()
        first = {}
        for i, q in enumerate(np.asarray(pts, np.float32)):
            first.setdefault(q.tobytes(), i)
        picks[side] = [first[q.tobytes()] for q in rows]
        grid = build_voxel_grid(c.points, c.mask, cfg.aivs_boxes_per_axis)
        sel, _ = stratified_fps(c.points, c.mask, grid.box_id, box_quotas(grid.counts, pn), cfg.aivs_max_rounds)
        before_cut[side] = set(np.nonzero(sel.cpu().numpy())[0].tolist())
    return picks, before_cut


def phase_knobs(torch, dev, kernels: dict, e2e: dict, card: str) -> None:
    """4i: every register_pair knob beside the defaults, at DEFAULT_CONFIG
    with one knob changed, against fixtures/torch_port_expected_variants.json
    (JAX on the CPU, scripts/torch_port_expected.py --variants)."""
    import kss_icp_torch as kt
    from kss_icp_torch.challenge import BOARDS, transform_rmse
    from kss_icp_torch.config import DEFAULT_CONFIG
    from kss_icp_torch.io.formats import load_points, save_xyz
    from kss_icp_torch.ladder_log import RungLog, rung_outcome
    from kss_icp_torch.models import kss_icp as tk
    from kss_icp_torch.ops.coarse_cuda import field_ave, field_dot, field_sq, field_trim
    from kss_icp_torch.ops.nn_cuda import nn1
    from kss_icp_torch.ops.resample_cuda import fps

    counters = {"nn1": nn1, "fps": fps, "field_ave": field_ave, "field_dot": field_dot, "field_trim": field_trim,
                "field_sq": field_sq}
    exp = json.loads((FIXTURES / "torch_port_expected_variants.json").read_text())
    pairs = load_pairs()
    for label in ("point_to_plane", "max", "diff", "aivs"):
        knobs = exp["variants"][label]["knobs"]
        cfg = dataclasses.replace(DEFAULT_CONFIG, **knobs)
        expected = {p["name"]: p for p in exp["variants"][label]["pairs"]}
        judge = remesh_judge(torch, expected)
        kt.register_pair(pairs[0][1], pairs[0][2], cfg, device=dev)  # warm-up
        name = f"knob {label}"
        with RungLog(tk, cfg.overlap_adopt_margin) as rung_log:
            rows, total, launches = drive(torch, dev, cfg, pairs, counters, StageTimer(torch, False), name, judge,
                                          rung_log)
            report_remesh(name, rows, total, expected, escalation=True)
            knob_launches(name, launches, knobs)
            counts = escalation_counts(name, rows, exp["variants"][label]["pairs"])
            ours = sorted(r["name"] for r in rows if r["escalated"])
            jax = sorted(n for n, p in expected.items() if p["escalated"])
            require(ours == jax, f"{name}: escalated {ours}, JAX {jax}")
            for r in rows:
                if r["rungs"] or expected[r["name"]]["rungs"]:
                    log(f"  [{name}] {r['name']}: rungs {rung_outcome(r['rungs'])} "
                        f"(jax {rung_outcome(expected[r['name']]['rungs'])})")
            timer = StageTimer(torch, True)
            _, staged, _ = drive(torch, dev, cfg, pairs, counters, timer, name + " staged", judge, rung_log)
        log(f"  [{name}] {len(rows) / total:.3f} pairs/s (no stage syncs) ({card})")
        log(f"  [{name}] stage seconds over all pairs (synced pass, {staged:.3f} s): " +
            ", ".join(f"{k} {v:.4f}" for k, v in timer.seconds.items()))
        log(f"  [{name}] lockstep ICP iterations by stage, summed over the pairs: " +
            ", ".join(f"{k} {v}" for k, v in timer.iterations.items() if v))
        e2e["passes"][name] = {"pairs_per_s": len(rows) / total, "seconds": total, "launches": launches,
                               "escalation": counts, "stage_seconds": dict(timer.seconds), "staged_seconds": staged,
                               "stage_iterations": dict(timer.iterations)}

    for label in ("aivs", "point_to_plane"):
        knobs = exp["many"][label]["knobs"]
        cfg = dataclasses.replace(DEFAULT_CONFIG, **knobs)
        expected = {p["name"]: p for p in exp["many"][label]["pairs"]}
        name = f"many {label}"
        drive_many(torch, dev, cfg, pairs[:3], counters, None, name + " warm-up")
        res, metrics, ladder, seconds, launches = drive_many(torch, dev, cfg, pairs, counters, StageTimer(torch, False),
                                                             name)
        knob_launches(name, launches, knobs)
        failures = []
        for b, (pair, _, _) in enumerate(pairs):
            j, rmse = expected[pair], float(metrics["rmse"][b])
            ok = np.isfinite(rmse) and rmse <= j["rmse"] + RMSE_BAND and bool(ladder.escalated[b]) == j["escalated"]
            log(f"  [{name}] {pair}: rmse {rmse:.6f} (jax {j['rmse']:.6f}) cand {int(res.chosen_candidate[b])} "
                f"(jax {j['chosen_candidate']}) esc {int(ladder.escalated[b])}/{int(j['escalated'])} rungs "
                f"{rung_outcome(ladder.rungs[b])} (jax {rung_outcome(j['rungs'])}) {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(pair)
        require(not failures, f"{name}: pairs outside JAX RMSE + {RMSE_BAND} or escalated unlike JAX: {failures}")
        timer = StageTimer(torch, True)
        _, _, _, staged, _ = drive_many(torch, dev, cfg, pairs, counters, timer, name + " staged")
        log(f"  [{name}] {len(pairs)} pairs in one batch: {len(pairs) / seconds:.3f} pairs/s (no stage syncs) ({card})")
        log(f"  [{name}] stage seconds (synced pass, {staged:.3f} s): " +
            ", ".join(f"{k} {v:.4f}" for k, v in timer.seconds.items()))
        log(f"  [{name}] lockstep ICP iterations by stage: " +
            ", ".join(f"{k} {v}" for k, v in timer.iterations.items() if v))
        e2e["passes"][name] = {"pairs_per_s": len(pairs) / seconds, "seconds": seconds, "launches": launches,
                               "stage_seconds": dict(timer.seconds), "staged_seconds": staged,
                               "stage_iterations": dict(timer.iterations)}

    label = "knob point_to_plane category"
    board = exp["boards"]["category"]
    cfg = dataclasses.replace(DEFAULT_CONFIG, **board["knobs"])
    corpus = next(corpus for b, corpus, _ in BOARDS if b == "category")()
    gt = {n: g for n, _, _, g in corpus}
    jax_pass = {p["name"]: p["passed"] for p in board["pairs"]}

    def board_judge(name, src, m, aligned):
        pose = transform_rmse(aligned.cpu().numpy(), src, gt[name])
        return {"pose": pose, "passed": bool(pose <= board["threshold"]), "rmse": m["rmse"]}

    timer = StageTimer(torch, True)
    rows, total, launches = drive(torch, dev, cfg, [(n, a, b) for n, a, b, _ in corpus], counters, timer, label,
                                  board_judge)
    knob_launches(label, launches, board["knobs"])
    mismatched = []
    for r in rows:
        agree = r["passed"] == jax_pass[r["name"]]
        log(f"  [{label}] {r['name']}: pose {r['pose']:.4f} {'pass' if r['passed'] else 'FAIL'} "
            f"(jax {'pass' if jax_pass[r['name']] else 'FAIL'}) esc {int(r['escalated'])} {r['s'] * 1e3:.1f} ms"
            f"{'' if agree else ' DIFFERS'}")
        if not agree and r["name"] != KNIFE_EDGE:
            mismatched.append(r["name"])
    require(not mismatched, f"{label}: pass/fail differs from JAX on the CPU: {mismatched}")
    log(f"  [{label}] {sum(r['passed'] for r in rows)}/{len(rows)} pass (jax {sum(jax_pass.values())}/{len(rows)}); "
        f"{len(rows) / total:.3f} pairs/s (synced) ({card}); stage seconds: " +
        ", ".join(f"{k} {v:.4f}" for k, v in timer.seconds.items()))
    e2e["passes"][label] = {"pairs_per_s": len(rows) / total, "seconds": total, "launches": launches,
                            "passed": sum(r["passed"] for r in rows), "stage_seconds": dict(timer.seconds)}

    # How many of register_pair's AIVS picks are JAX's, cloud by cloud.
    same = total_picks = 0
    for rec, (name, src, tgt) in zip(exp["aivs_picks"], pairs):
        require(rec["name"] == name, "the variants record's remesh pairs differ")
        picks, before_cut = aivs_picks(torch, dev, src, tgt)
        for side in ("source", "target"):
            ours, theirs = picks[side], rec[side]
            n_same = len(set(ours) & set(theirs))
            same, total_picks = same + n_same, total_picks + len(theirs)
            if ours != theirs:
                inside = set(ours) | set(theirs) <= before_cut[side]
                why = ("both inside the port's lockstep FPS selection: the accurate cut dropped other members of "
                       "near-tied pairs (its 3-NN distances exact here, the expansion form in JAX)" if inside else
                       "the lockstep FPS selections differ")
                log(f"  [aivs picks] {name} {side}: {n_same}/{len(theirs)} picks JAX's"
                    f"{', in another order' if sorted(ours) == sorted(theirs) else ''}; {why}")
    log(f"  [aivs picks] {same}/{total_picks} of register_pair's AIVS picks on the 50 remesh clouds are JAX's")
    e2e["passes"]["aivs picks"] = {"same": same, "total": total_picks}

    # The CLI's simplify -m aivs, as a subprocess on the card.
    import tempfile

    rec = exp["cli_aivs"]
    src = next(a for n, a, _ in pairs if n == rec["name"])
    with tempfile.TemporaryDirectory(prefix="kss_aivs_") as tmp:
        path, out = Path(tmp) / rec["file"], Path(tmp) / "out.xyz"
        save_xyz(path, src)
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "kss_icp_torch", "simplify", str(path), str(out), "-m", "aivs",
                            "-n", str(rec["count"])], capture_output=True, text=True, timeout=600, cwd=REPO)
        wall = time.perf_counter() - t0
        require(r.returncode == 0, f"cli simplify -m aivs: exit {r.returncode}\n{r.stderr[-3000:]}")
        pts, got = load_points(path).astype(np.float32), load_points(out).astype(np.float32)
    require(len(got) == rec["n_selected"], f"cli simplify -m aivs: {len(got)} points, JAX {rec['n_selected']}")
    index = {q.tobytes(): i for i, q in reversed(list(enumerate(pts)))}
    ours = [index.get(q.tobytes(), -1) for q in got]
    shared = sorted(set(ours) & set(rec["selected"]))
    np.testing.assert_allclose(got[[ours.index(i) for i in shared]], pts[shared], rtol=1e-6)
    log(f"  [cli] simplify -m aivs -n {rec['count']} on {rec['file']}: {len(got)} points (jax {rec['n_selected']}), "
        f"{len(shared)} of them JAX's picks; {wall:.2f} s wall ({nvidia_smi()})")
    kernels["field_trim"]["squared"]["launches"] = sum(e2e["passes"][f"knob {m}"]["launches"]["field_sq"]
                                                       for m in ("max", "diff"))


def sha256(a: np.ndarray) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def load_tools():
    """fixtures/torch_port_expected_tools.{json,npz}: JAX's record of the tools
    (scripts/torch_port_expected.py --tools)."""
    rec = json.loads((FIXTURES / "torch_port_expected_tools.json").read_text())
    with np.load(FIXTURES / "torch_port_expected_tools.npz") as z:
        return rec, {k: z[k] for k in z.files}


def original_cloud(o: dict, path: Path) -> np.ndarray:
    """A tools original, `challenge._instance(family, 0, n, sample=0)`, written
    with save_xyz to `path` and read back as the CLI reads it (float32)."""
    from kss_icp_torch.challenge import _instance
    from kss_icp_torch.io.formats import load_points, save_xyz

    save_xyz(path, _instance(o["family"], 0, o["n"], sample=0))
    pts = load_points(path).astype(np.float32)
    require(sha256(pts) == o["points_sha256"], f"tools original {o['name']}: its points differ from JAX's record")
    return pts


WLOP_BAR = {"median": 5e-5, "max": 2e-3}  # |Δ| to JAX's samples, in bounding-box diagonals
# Where JAX's float32 samples are themselves off the float64 solution by more
# than the bar, the port's |Δ| to it as a share of JAX's: a tenth at the
# median (the drift of every sample; 0.007-0.013 on the CPU at 40960 points),
# no more than JAX's at the max (a few samples that 20 steps amplify from any
# rounding: 0.045-0.56 on the CPU, 0.39 on the card for `se`).
WLOP_FLOAT64_SHARE = {"median": 0.1, "max": 1.0}


def wlop_gaps(got, want, diag: float) -> dict:
    """|Δ| between (M, 3) samples in bounding-box diagonals: median and max."""
    d = (got.double() - want.double()).norm(dim=1) / diag
    return {"median": float(d.median()), "max": float(d.max())}


def wlop_bar(got, want, want_f64, jax_f64_gap: dict, diag: float) -> tuple:
    """The WLOP bar on samples `got`: each statistic of |Δ| to JAX's float32
    samples within WLOP_BAR, or, where JAX's float32 run is itself that far
    from the float64 solution (ROADMAP.md queue 3), the port's |Δ| to it
    within WLOP_FLOAT64_SHARE of JAX's. Returns (ok, figures)."""
    gaps, to_f64 = wlop_gaps(got, want, diag), wlop_gaps(got, want_f64, diag)
    ok = all(gaps[k] <= WLOP_BAR[k] or to_f64[k] <= WLOP_FLOAT64_SHARE[k] * jax_f64_gap[k] for k in WLOP_BAR)
    return ok, {"jax": gaps, "float64": to_f64, "jax_float64": jax_f64_gap}


def wlop_text(fig: dict) -> str:
    return (f"|Δ| to JAX's median {fig['jax']['median']:.3g} max {fig['jax']['max']:.3g} diagonals (bar 5e-5, 2e-3); "
            f"to float64 median {fig['float64']['median']:.3g} max {fig['float64']['max']:.3g} (JAX's float32 "
            f"{fig['jax_float64']['median']:.3g}, {fig['jax_float64']['max']:.3g})")


def min_pair_dists(torch, x, rows: int = 1024):
    """Each sample's distance to its nearest other sample (tests/test_wlop.py)."""
    from kss_icp_torch.ops.nn import exact_sqdist

    out = []
    for r0 in range(0, x.shape[0], rows):
        d2 = exact_sqdist(x[r0:r0 + rows], x)
        d2[torch.arange(d2.shape[0]), torch.arange(r0, r0 + d2.shape[0])] = float("inf")
        out.append(d2.min(dim=1).values)
    return torch.cat(out).sqrt()


def surface_max(torch, samples, points, rows: int = 512) -> float:
    """The largest distance from a sample to the nearest input point."""
    from kss_icp_torch.ops.nn import exact_sqdist

    return max(float(exact_sqdist(samples[r0:r0 + rows], points).min(dim=1).values.max().sqrt())
               for r0 in range(0, samples.shape[0], rows))


def phase_tools(torch, dev, e2e: dict, card: str) -> None:
    """4j: the resampling and fixture tools at the CLI's defaults on four
    40960-point originals against fixtures/torch_port_expected_tools.json
    (JAX on the CPU): make-pairs then batch as subprocesses, then WLOP,
    hierarchy_simplify, simplification_measure, the `.gird` source and
    pipeline_from_file in this process, and simplify -m wlop|hierarchy on
    handg's remesh source."""
    import io
    import tempfile

    from kss_icp_torch import cli
    from kss_icp_torch.io.formats import load_normals, load_points, save_normals, save_xyz
    from kss_icp_torch.measure_resample import simplification_measure
    from kss_icp_torch.ops.coarse_cuda import field_ave, field_dot, field_sq, field_trim
    from kss_icp_torch.ops.nn_cuda import nn1
    from kss_icp_torch.ops.normals import estimate_oriented_normals
    from kss_icp_torch.ops.resample_cuda import fps
    from kss_icp_torch.ops.simplify import grid_simplify, hierarchy_simplify
    from kss_icp_torch.ops.spatial import build_voxel_grid
    from kss_icp_torch.ops.wlop import wlop_resample
    from kss_icp_torch.pipeline import pipeline_from_file
    from kss_icp_torch.transfer import TransferRecord, apply_record, estimate_radius

    counters = {"nn1": nn1, "fps": fps, "field_ave": field_ave, "field_dot": field_dot, "field_trim": field_trim,
                "field_sq": field_sq}
    rec, arrays = load_tools()
    cfg = rec["config"]
    originals = rec["originals"]
    walls, out = {}, {"originals": {}}

    def run(label, *args):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "kss_icp_torch", *map(str, args)], capture_output=True, text=True,
                           timeout=600, cwd=REPO)
        walls[label] = time.perf_counter() - t0
        log(f"  [tools cli] {label}: exit {r.returncode}, {walls[label]:.2f} s wall ({card})")
        require(r.returncode == 0, f"tools cli {label}: exit {r.returncode}\n{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
        return r.stdout

    def quiet_main(argv):
        with contextlib.redirect_stdout(io.StringIO()):
            return cli.main(argv)

    def counted(label, fn):
        """fn() with every launch count zeroed just before it and read just after."""
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        log(f"  [tools] {label}: {seconds:.3f} s, kernel launches {launches}")
        return result, seconds, launches

    with tempfile.TemporaryDirectory(prefix="kss_tools_") as tmp:
        tmp = Path(tmp)
        clouds = {o["name"]: original_cloud(o, tmp / f"{o['name']}.xyz") for o in originals}
        specs = [f"{o['name']}={tmp / (o['name'] + '.xyz')}:{o['record']['axis']}:{o['record']['angle']}:"
                 f"{o['record']['scale']}:{o['record']['translation']}" for o in originals]

        # make-pairs, then batch on its output, as a user runs them.
        printed = run("make-pairs", "make-pairs", *specs, "-o", tmp / "pairs", "--wlop-points", cfg["wlop_points"])
        lines = dict(ln.split(": ", 1) for ln in printed.strip().splitlines())
        for o in originals:
            m = re.fullmatch(r"wlop=(\d+) gird=(\d+) \((.*)\)", lines.get(o["name"], ""))
            require(m is not None and int(m.group(1)) == o["wlop"]["count"] and m.group(3) == o["line"],
                    f"make-pairs {o['name']}: printed {lines.get(o['name'])!r}")
            log(f"  [tools cli] make-pairs {o['name']}: wlop={m.group(1)} gird={m.group(2)} (jax gird="
                f"{o['gird']['count']}) ({o['line']})")
            out["originals"][o["name"]] = {"gird_count": int(m.group(2))}
        (tmp / "list.txt").write_text("".join(o["name"] + "\n" for o in originals))
        printed = run("batch", "batch", tmp / "list.txt", tmp / "pairs")
        failures = []
        for o in originals:
            m = re.search(rf"^{o['name']} +time=\s*\S+s MSE=\S+ RMSE=(\S+) MAE=\S+$", printed, re.M)
            rmse = float(m.group(1)) if m else float("nan")
            ok = np.isfinite(rmse) and rmse <= o["register"]["rmse"] + RMSE_BAND
            log(f"  [tools cli] batch {o['name']}: RMSE {rmse:.6f} (jax {o['register']['rmse']:.6f} on its own pair) "
                f"{'ok' if ok else 'FAIL'}")
            out["originals"][o["name"]]["rmse"] = rmse
            failures += [] if ok else [o["name"]]
        require(not failures, f"batch on make-pairs' output: RMSE above JAX + {RMSE_BAND}: {failures}")

        # The same two commands through cli.main in this process: their launches.
        for label, args in (("make-pairs", ["make-pairs", *specs, "-o", tmp / "pairs2", "--wlop-points",
                                            cfg["wlop_points"]]),
                            ("batch", ["batch", tmp / "list.txt", tmp / "pairs2"])):
            code, _, launches = counted(f"cli.main {label}", lambda: quiet_main([str(a) for a in args]))
            require(code == 0, f"cli.main {label}: exit {code}")
            require(launches["fps"] >= len(originals), f"cli.main {label}: fps launched {launches['fps']} times")
            if label == "batch":
                require(launches["nn1"] > 0 and launches["field_ave"] >= len(originals),
                        f"cli.main batch: launches {launches}")
            out[f"cli.main {label}"] = launches

        wlop_launches = 0
        for o in originals:
            name, pts = o["name"], clouds[o["name"]]
            row = out["originals"][name]
            pt = torch.as_tensor(pts, device=dev)
            mt = torch.ones(len(pts), dtype=torch.bool, device=dev)
            torch.cuda.reset_peak_memory_stats()
            (wl, wm), seconds, launches = counted(f"wlop_resample {name} {len(pts)} -> {cfg['wlop_points']}",
                                                  lambda: wlop_resample(pt, mt, cfg["wlop_points"]))
            require(launches["fps"] == 1, f"wlop {name}: fps launched {launches['fps']} times, not once")
            wlop_launches += launches["fps"]
            row.update(wlop_ms=seconds * 1e3, wlop_peak_mib=torch.cuda.max_memory_allocated() / 2**20)
            idx, _ = fps(pt[None], mt[None], cfg["wlop_points"])
            require(sha256(idx[0].cpu().numpy().astype(np.int32)) == o["fps_start_sha256"],
                    f"wlop {name}: the fps start's indices differ from JAX's farthest_point_sampling")
            jwl = torch.as_tensor(arrays[f"{name}_wlop"], device=dev)
            diag = o["wlop"]["bbox_diag"]
            ok, fig = wlop_bar(wl, jwl, torch.as_tensor(arrays[f"{name}_wlop_f64"], device=dev),
                               o["wlop"]["float64_gap"], diag)
            spacing = min_pair_dists(torch, wl)
            cv = float(spacing.std() / spacing.mean())
            on_surface = surface_max(torch, wl, pt)
            row.update(wlop_gaps=fig, spacing_cv=cv, on_surface=on_surface)
            log(f"  [tools] wlop {name}: {seconds * 1e3:.1f} ms, peak {row['wlop_peak_mib']} MiB; {wlop_text(fig)}; "
                f"spacing CV {cv:.5f} (jax {o['wlop']['spacing_cv']:.5f}); on-surface max {on_surface:.6f} (jax "
                f"{o['wlop']['on_surface_max']:.6f}); fps start = JAX's ({card})")
            require(int(wm.sum()) == o["wlop"]["count"], f"wlop {name}: {int(wm.sum())} samples")
            require(ok, f"wlop {name}: outside the WLOP bar: {fig}")
            require(abs(cv / o["wlop"]["spacing_cv"] - 1.0) <= 0.02, f"wlop {name}: spacing CV {cv}")
            require(on_surface <= o["wlop"]["on_surface_max"] + 1e-3 * diag, f"wlop {name}: off the surface")

            (_, keep), seconds, _ = counted(f"hierarchy_simplify {name}", lambda: hierarchy_simplify(
                pt, mt, cfg["cluster_size"]))
            kept = np.nonzero(keep.cpu().numpy())[0]
            same = np.array_equal(kept, arrays[f"{name}_hierarchy"])
            row.update(hierarchy_ms=seconds * 1e3, hierarchy_count=int(len(kept)), hierarchy_same=same)
            log(f"  [tools] hierarchy {name}: {len(kept)} kept (jax {o['hierarchy']['count']}), "
                f"{'the same set' if same else 'SETS DIFFER'}, {seconds * 1e3:.1f} ms")
            require(same, f"hierarchy {name}: the kept set differs from JAX's")

            jmask = torch.ones(len(jwl), dtype=torch.bool, device=dev)
            given = torch.as_tensor(arrays[f"{name}_wlop_normals"], device=dev)
            (meas, seconds, _) = counted(f"simplification_measure {name}", lambda: simplification_measure(
                pt, mt, jwl, jmask, normals=given))
            meas = {k: float(v) for k, v in meas.items()}
            own = {k: float(v) for k, v in simplification_measure(pt, mt, jwl, jmask).items()}
            row.update(measure_ms=seconds * 1e3, measure=meas, measure_own_normals=own)
            j = o["measure"]
            f64 = o["measure_f64"]
            log(f"  [tools] measure {name} (JAX's WLOP, JAX's normals): avg {meas['avg_displacement']:.6g} max "
                f"{meas['max_displacement']:.6g} rate {meas['sampling_rate']:.6g} (jax {j['avg_displacement']:.6g}, "
                f"{j['max_displacement']:.6g}, {j['sampling_rate']:.6g}; float64 {f64['avg_displacement']:.6g}, "
                f"{f64['max_displacement']:.6g}); with the card's own normals avg {own['avg_displacement']:.6g} max "
                f"{own['max_displacement']:.6g}; {seconds * 1e3:.1f} ms")
            require(meas["sampling_rate"] == j["sampling_rate"], f"measure {name}: sampling rate")
            for k in ("avg_displacement", "max_displacement"):
                # rtol 1e-4 of JAX's, or, where JAX's float32 is farther than that
                # from the float64 projection (ROADMAP.md queue 3), within a
                # tenth of JAX's distance to it.
                f64 = o["measure_f64"][k]
                require(abs(meas[k] / j[k] - 1.0) <= 1e-4 or abs(meas[k] / f64 - 1.0) <= 0.1 * abs(j[k] / f64 - 1.0),
                        f"measure {name}: {k} {meas[k]} against JAX's {j[k]} (float64 {f64})")

            rec_ = TransferRecord(**o["record"])
            gp, gm = grid_simplify(pt, mt, o["radius"] / 1.5)
            source = apply_record(gp[gm].cpu().numpy().astype(np.float64), rec_)
            require(sha256(source) == o["gird"]["sha256"], f"make_pair {name}: the .gird at JAX's radius is not JAX's")
            radius, seconds, _ = counted(f"estimate_radius {name}", lambda: estimate_radius(pts, device=dev))
            row.update(radius=radius, radius_ms=seconds * 1e3)
            log(f"  [tools] .gird {name}: at JAX's radius {len(source)} points, JAX's bit for bit; the card's radius "
                f"{radius:.9g} (float64 {o['radius_f64']:.9g}, jax {o['radius']:.9g}), rel {radius / o['radius_f64'] - 1:.2e}")
            require(abs(radius / o["radius_f64"] - 1.0) <= 1e-6, f"radius {name}: {radius} against {o['radius_f64']}")

        # pipeline_from_file on the first original, twice: the sidecar round trip.
        o = originals[0]
        path = tmp / f"pipe_{o['name']}.xyz"
        save_xyz(path, load_points(tmp / f"{o['name']}.xyz"))
        state, seconds, _ = counted(f"pipeline_from_file {o['name']}", lambda: pipeline_from_file(path, device=dev))
        pipe = o["pipeline"]
        grid = build_voxel_grid(torch.as_tensor(state.points, device=dev), torch.as_tensor(state.mask, device=dev),
                                state.boxes_per_axis)
        nrm = estimate_oriented_normals(torch.as_tensor(state.points, device=dev),
                                        torch.as_tensor(state.mask, device=dev)).cpu().numpy()
        log(f"  [tools] pipeline_from_file {o['name']}: {seconds:.3f} s; radius {state.radius:.9g} (float64 "
            f"{pipe['radius_f64']:.9g}, jax {pipe['radius']:.9g}); border {state.border.tolist()} (jax {pipe['border']})")
        require(abs(state.radius / pipe["radius_f64"] - 1.0) <= 1e-6, f"pipeline radius {state.radius}")
        require(state.border.tolist() == pipe["border"] and state.count == pipe["count"] and
                state.boxes_per_axis == pipe["boxes_per_axis"], "pipeline: border, count or boxes differ from JAX's")
        require(all(torch.equal(a, b) for a, b in zip(state.grid, grid)), "pipeline: grid is not build_voxel_grid's")
        require(np.array_equal(state.normals[:state.count], nrm[:state.count]), "pipeline: normals differ")
        require(np.allclose(np.linalg.norm(state.normals[:state.count], axis=1), 1.0, atol=1e-4), "pipeline: not unit")
        sidecar = path.with_suffix(".normal")
        require(sidecar.exists() and load_normals(sidecar).shape == (state.count, 3), "pipeline: no sidecar")
        marked = np.tile(np.float32([[0.0, 0.0, 1.0]]), (state.count, 1))
        save_normals(sidecar, marked)
        again, seconds2, _ = counted(f"pipeline_from_file {o['name']} (sidecar)", lambda: pipeline_from_file(
            path, device=dev))
        require(np.array_equal(again.normals[:state.count], marked), "pipeline: the sidecar was not read back")
        out["pipeline"] = {"seconds": seconds, "sidecar_seconds": seconds2, "radius": state.radius}

        # simplify -m wlop | hierarchy on handg's remesh source.
        cw, ch = rec["cli_wlop"], rec["cli_hierarchy"]
        src = next(a for n, a, _ in load_pairs() if n == cw["name"])
        save_xyz(tmp / cw["file"], src)
        pts = load_points(tmp / cw["file"])
        printed = run("simplify -m wlop", "simplify", tmp / cw["file"], tmp / "w.xyz", "-m", "wlop", "-n", cw["count"])
        require(printed.strip() == cw["printed"], f"simplify -m wlop printed {printed.strip()!r}")
        got = torch.as_tensor(load_points(tmp / "w.xyz"))
        ok, fig = wlop_bar(got, torch.as_tensor(arrays["cli_wlop"]), torch.as_tensor(arrays["cli_wlop_f64"]),
                           cw["float64_gap"], float(np.linalg.norm(pts.max(0) - pts.min(0))))
        log(f"  [tools cli] simplify -m wlop -n {cw['count']} on {cw['file']}: {printed.strip()}; {wlop_text(fig)}")
        require(ok, f"simplify -m wlop: outside the WLOP bar: {fig}")
        printed = run("simplify -m hierarchy", "simplify", tmp / ch["file"], tmp / "h.xyz", "-m", "hierarchy")
        require(printed.strip() == ch["printed"], f"simplify -m hierarchy printed {printed.strip()!r}")
        require(np.array_equal(load_points(tmp / "h.xyz"), pts[arrays["cli_hierarchy"]]),
                "simplify -m hierarchy: the points differ from JAX's picks")
        log(f"  [tools cli] simplify -m hierarchy on {ch['file']}: {printed.strip()}, JAX's points")
    out["walls"] = walls
    e2e["passes"]["tools"] = dict(out, launches={"fps": wlop_launches})


# Phase 4k: the last modules (scripts/torch_port_expected.py --two-stage and --analysis record JAX's side).
TWO_STAGE_KNOBS = dict(refine_max_iterations=8, refine_polish_iterations=1000)
VCM_RADIUS = 0.1  # offset and convolution radius, the record's (unit-scale tools originals)
VCM_SAMPLES = 32  # samples a point: 1310720 queries against a 40960-point original
LLOYD = dict(sites=4096, resolution=1024, iterations=10)  # nn1 at 1 x 1048576 x 4096 a step
EXACT = "donot_use_mm_for_euclid_dist"  # torch.cdist in differences, not the expansion


def phase_two_stage(torch, dev, e2e: dict, card: str) -> None:
    """4k: the two-stage converge, DEFAULT_CONFIG with refine_max_iterations=8
    and refine_polish_iterations=1000, against
    fixtures/torch_port_expected_two_stage.json: the remesh 25 one pair at a
    time and as one register_many batch (within JAX + 0.006, JAX's escalated
    set), then the boards' 64 pairs as one batch (the pass/fail set of JAX's
    shipped register_many, fixtures/torch_port_expected_batch.json, se/7
    excepted). Pairs/s are timed in turns with the shipped DEFAULT_CONFIG
    (two-stage, shipped, shipped, two-stage; the boards two-stage then
    shipped, synced), so host drift over the run does not decide them."""
    from kss_icp_torch.challenge import transform_rmse
    from kss_icp_torch.config import DEFAULT_CONFIG
    from kss_icp_torch.ops.coarse_cuda import field_ave, field_dot, field_trim
    from kss_icp_torch.ops.nn_cuda import nn1
    from kss_icp_torch.ops.resample_cuda import fps
    import kss_icp_torch as kt

    counters = {"nn1": nn1, "fps": fps, "field_ave": field_ave, "field_dot": field_dot, "field_trim": field_trim}
    exp = json.loads((FIXTURES / "torch_port_expected_two_stage.json").read_text())
    require(exp["knobs"] == TWO_STAGE_KNOBS, f"the two-stage record's knobs {exp['knobs']} are not {TWO_STAGE_KNOBS}")
    cfg = dataclasses.replace(DEFAULT_CONFIG, **TWO_STAGE_KNOBS)
    pairs = load_pairs()

    def ungated(name, src, m, aligned):
        return {}

    def report(label, n, seconds, timer, shipped_timer):
        """pairs/s of each turn, then the synced pass's stages beside shipped's."""
        rate = {k: [n / t for t in v] for k, v in seconds.items()}
        log(f"  [{label}] pairs/s in turns: two-stage " + ", ".join(f"{r:.3f}" for r in rate["two-stage"]) +
            "; shipped " + ", ".join(f"{r:.3f}" for r in rate["shipped"]) + f" ({card})")
        log(f"  [{label}] stage seconds (synced): " + ", ".join(
            f"{k} {v:.4f} (shipped {shipped_timer.seconds.get(k, 0.0):.4f})" for k, v in timer.seconds.items()))
        log(f"  [{label}] lockstep ICP iterations by stage: " + ", ".join(
            f"{k} {v} (shipped {shipped_timer.iterations.get(k, 0)})" for k, v in timer.iterations.items() if v))
        return {"pairs_per_s": float(np.mean(rate["two-stage"])), "shipped_pairs_per_s": float(np.mean(rate["shipped"])),
                "turns": rate, "stage_seconds": dict(timer.seconds), "stage_iterations": dict(timer.iterations),
                "shipped_stage_seconds": dict(shipped_timer.seconds),
                "shipped_stage_iterations": dict(shipped_timer.iterations)}

    label = "two-stage"
    expected = {p["name"]: p for p in exp["pairs"]}
    judge = remesh_judge(torch, expected)
    rows, total, launches = drive(torch, dev, cfg, pairs, counters, StageTimer(torch, False), label, judge)
    report_remesh(label, rows, total, expected, escalation=True)
    check_launches(label, launches, "vpu", overlap=True)
    differ = [r["name"] for r in rows if r["escalated"] != expected[r["name"]]["escalated"]]
    require(not differ, f"{label}: escalated unlike JAX: {differ}")
    continued = [r["name"] for r in rows if r["continued"]]
    log(f"  [{label}] continued {len(continued)} {continued} (jax "
        f"{[p['name'] for p in exp['pairs'] if p['continued']]}); escalated {sum(r['escalated'] for r in rows)} as JAX")
    seconds = {"two-stage": [total], "shipped": []}
    for which in ("shipped", "shipped", "two-stage"):
        _, t, _ = drive(torch, dev, cfg if which == "two-stage" else DEFAULT_CONFIG, pairs, counters,
                        StageTimer(torch, False), f"{label} turn: {which}", ungated)
        seconds[which].append(t)
    timers = [StageTimer(torch, True) for _ in range(2)]
    for c, timer in zip((cfg, DEFAULT_CONFIG), timers):
        drive(torch, dev, c, pairs, counters, timer, f"{label} staged", ungated)
    e2e["passes"][label] = dict(report(label, len(pairs), seconds, *timers), launches=launches,
                                continued=len(continued))

    label = "two-stage many"
    exp_many = exp["many"]["two_stage"]["pairs"]
    require([p["name"] for p in exp_many] == [n for n, _, _ in pairs], f"{label}: the record's pairs differ")
    res, metrics, ladder, total, launches = drive_many(torch, dev, cfg, pairs, counters, None, label)
    check_batch_launches(label, launches, len(pairs), ladder, cfg)
    failures = []
    for b, (name, _, _) in enumerate(pairs):
        j, rmse = exp_many[b], float(metrics["rmse"][b])
        ok = np.isfinite(rmse) and rmse <= j["rmse"] + RMSE_BAND and bool(ladder.escalated[b]) == j["escalated"]
        log(f"  [{label}] {name}: rmse {rmse:.6f} (jax {j['rmse']:.6f}) continued {int(ladder.continued[b])}/"
            f"{int(j['continued'])} esc {int(ladder.escalated[b])}/{int(j['escalated'])} won {int(ladder.won[b])} "
            f"fin {int(ladder.finisher[b])}/{int(j['finisher'])} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(name)
    require(not failures, f"{label}: pairs outside JAX RMSE + {RMSE_BAND} or escalated unlike JAX: {failures}")
    log(f"  [{label}] continued {int(ladder.continued.sum())} (jax {sum(p['continued'] for p in exp_many)})")
    seconds = {"two-stage": [total], "shipped": []}
    for which in ("shipped", "shipped", "two-stage"):
        seconds[which].append(drive_many(torch, dev, cfg if which == "two-stage" else DEFAULT_CONFIG, pairs,
                                         counters, None, f"{label} turn: {which}")[3])
    timers = [StageTimer(torch, True) for _ in range(2)]
    for c, timer in zip((cfg, DEFAULT_CONFIG), timers):
        drive_many(torch, dev, c, pairs, counters, timer, f"{label} staged")
    e2e["passes"][label] = dict(report(label, len(pairs), seconds, *timers), launches=launches,
                                continued=int(ladder.continued.sum()))

    label = "two-stage many boards"
    boards = load_boards()
    jax_rows = {f"{board}:{p['name']}": p for board, rec in
                json.loads((FIXTURES / "torch_port_expected_batch.json").read_text())["boards"].items()
                for p in rec["pairs"]}
    timers = [StageTimer(torch, True) for _ in range(2)]
    res, metrics, ladder, total, launches = drive_many(torch, dev, cfg, [b[:3] for b in boards], counters,
                                                       timers[0], label)
    check_batch_launches(label, launches, len(boards), ladder, cfg)
    mismatched, passed = [], 0
    for b, (name, src, _, gt, thr) in enumerate(boards):
        row = kt.Similarity(*(x[b] for x in res.transform))
        pose = transform_rmse(kt.apply_similarity(row, torch.as_tensor(src, device=dev)).cpu().numpy(), src, gt)
        ok = bool(pose <= thr)
        passed += ok
        if ok != jax_rows[name]["passed"]:
            log(f"  [{label}] {name}: pose {pose:.4f} {'pass' if ok else 'FAIL'} (shipped jax "
                f"{jax_rows[name]['pose_rmse']:.4f}) DIFFERS")
            if name != f"category:{KNIFE_EDGE}":
                mismatched.append(name)
    require(not mismatched, f"{label}: pass/fail differs from JAX's shipped register_many set: {mismatched}")
    log(f"  [{label}] {passed}/{len(boards)} pass (jax shipped {sum(p['passed'] for p in jax_rows.values())}); "
        f"continued {int(ladder.continued.sum())}")
    shipped = drive_many(torch, dev, DEFAULT_CONFIG, [b[:3] for b in boards], counters, timers[1],
                         f"{label} turn: shipped")[3]
    e2e["passes"][label] = dict(report(label + " (synced)", len(boards), {"two-stage": [total], "shipped": [shipped]},
                                       *timers), launches=launches, passed=passed,
                                continued=int(ladder.continued.sum()))


def vcm_inputs(torch, dev, family: int):
    """A 40960-point tools original (challenge._instance(family, 0, n,
    sample=0), fixtures/torch_port_expected_tools.json's size) on the card,
    its mask, and its ball samples from a generator seeded with `family`."""
    from kss_icp_torch.challenge import _instance
    from kss_icp_torch.ops.vcm import ball_samples

    n = load_tools()[0]["originals"][0]["n"]
    pts = torch.as_tensor(np.asarray(_instance(family, 0, n, sample=0), np.float32), device=dev)
    gen = torch.Generator(device=dev).manual_seed(family)
    return pts, torch.ones(n, dtype=torch.bool, device=dev), ball_samples(pts, VCM_RADIUS, VCM_SAMPLES, gen)


def lloyd_start(n_sites: int) -> np.ndarray:
    """Seeded sites in the unit square (the record's rule)."""
    return np.random.default_rng(0).uniform(0.0, 1.0, (n_sites, 2)).astype(np.float32)


def voronoi_query(torch, dev, resolution: int):
    """The raster's pixel centres padded to z = 0: the labels' nn1 queries."""
    from kss_icp_torch.ops.voronoi2d import _grid

    pix, _ = _grid((0.0, 0.0, 1.0, 1.0), resolution, torch.float32, dev)
    return torch.cat([pix, torch.zeros_like(pix[:, :1])], dim=-1)


@contextlib.contextmanager
def plain_nn1(module):
    """`module` calls nn1's plain version where it calls nn1 (unbatched
    inputs one lane, as nn1 takes them): the plain version of the whole op
    on the same inputs."""
    from kss_icp_torch.ops.nn_cuda import nn1_plain

    def plain(query, ref, ref_mask, lane_ref=None):
        if query.dim() == 2:
            d2, idx = nn1_plain(query[None], ref[None], ref_mask[None])
            return d2[0], idx[0]
        return nn1_plain(query, ref, ref_mask, lane_ref)

    orig = module.nn1
    module.nn1 = plain
    try:
        yield
    finally:
        module.nn1 = orig


def vcm_float64(torch, points, samples, mask, radius: float, samples_per_point: int):
    """The VCM in float64 on the card from float32 inputs: exact owners and
    their second-nearest gap, the matrices (P, 9) and the ratios."""
    p64, s64 = points.double(), samples.double()
    owners, d2min, gap = [], [], []
    for a in range(0, len(s64), 8192):
        d2 = torch.cdist(s64[a:a + 8192], p64, compute_mode=EXACT) ** 2
        d2 = torch.where(mask[None], d2, torch.full_like(d2, float("inf")))
        two = d2.topk(2, dim=1, largest=False)
        owners.append(two.indices[:, 0])
        d2min.append(two.values[:, 0])
        gap.append(two.values[:, 1] - two.values[:, 0])
    owners, d2min, gap = torch.cat(owners), torch.cat(d2min), torch.cat(gap)
    diff = (s64 - p64[owners]) * (d2min <= radius ** 2)[:, None]
    mats = torch.zeros((len(p64), 9), dtype=torch.float64, device=points.device)
    mats.index_add_(0, owners, (diff[:, :, None] * diff[:, None, :]).reshape(-1, 9))
    mats *= (4.0 / 3.0) * np.pi * radius ** 3 / samples_per_point
    conv = torch.cat([((torch.cdist(p64[a:a + 4096], p64, compute_mode=EXACT) <= radius) & mask[None] & mask[a:a + 4096, None]).double()
                      @ mats for a in range(0, len(p64), 4096)])
    evals = torch.linalg.eigvalsh(conv.reshape(-1, 3, 3))
    ratio = evals[:, 1] / evals.sum(-1).clamp_min(torch.finfo(torch.float64).tiny)
    return owners, gap, conv, ratio


def phase_analysis(torch, dev, e2e: dict, card: str) -> None:
    """4k: vcm_edges, lloyd_relax and mesh_angle_report on the card, held to
    their plain versions on the card (nn1_plain in place of nn1), to JAX's
    record at the record's size (fixtures/torch_port_expected_analysis.*) and
    to float64."""
    from kss_icp_torch import measure_mesh
    from kss_icp_torch.ops import vcm as tv
    from kss_icp_torch.ops import voronoi2d as tvor
    from kss_icp_torch.ops.nn_cuda import nn1

    rec = json.loads((FIXTURES / "torch_port_expected_analysis.json").read_text())
    with np.load(FIXTURES / "torch_port_expected_analysis.npz") as z:
        arrays = {k: z[k] for k in z.files}
    a = rec["analysis"]
    require(a["offset_radius"] == a["convolve_radius"] == VCM_RADIUS and a["samples_per_point"] == VCM_SAMPLES,
            "the analysis record's VCM radii or samples differ from phase 4k's")

    def counted(fn):
        """fn() to a sync, the nn1 counts zeroed just before and read just
        after: (result, ms, peak MiB, launches, launches by shape)."""
        nn1.launches = 0
        nn1.launch_shapes.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        shapes = {shape_key(*k): v for k, v in nn1.launch_shapes.items()}
        return out, ms, torch.cuda.max_memory_allocated(dev) / 2**20, nn1.launches, shapes

    # VCM at the record's size: JAX's samples, held to float64 and to JAX's flags.
    label = "vcm record"
    pts, samples = (torch.as_tensor(arrays[k], device=dev) for k in ("vcm_points", "vcm_samples"))
    require(sha256(arrays["vcm_points"]) == rec["vcm"]["points_sha256"], f"{label}: the record's points differ")
    mask = torch.ones(len(pts), dtype=torch.bool, device=dev)
    args = (pts, mask, VCM_RADIUS, VCM_RADIUS)
    mats = tv.vcm(*args, samples=samples, samples_per_point=VCM_SAMPLES).reshape(-1, 9)
    edge, ratio = tv.vcm_edges(*args, a["threshold"], samples=samples, samples_per_point=VCM_SAMPLES)
    owner, _ = tv.sample_owners(samples, pts, mask, VCM_RADIUS)
    own64, gap64, mats64, ratio64 = vcm_float64(torch, pts, samples, mask, VCM_RADIUS, VCM_SAMPLES)
    parted = owner.long() != own64
    scale = float(mats64.abs().max())
    mats_gap = float((mats.double() - mats64).abs().max()) / scale
    ratio_gap = float((ratio.double() - ratio64).abs().max())
    firm = ((ratio64 - a["threshold"]).abs() > 1e-4).cpu().numpy()
    edges_differ = int((edge.cpu().numpy() != arrays["vcm_edges"])[firm].sum())
    log(f"  [{label}] {len(pts)} points, {len(samples)} JAX samples: owners not float64's {int(parted.sum())} (jax "
        f"{rec['vcm']['jax_owners_not_float64']}), their float64 gap at most "
        f"{float(gap64[parted].max()) if parted.any() else 0.0:.3g}; matrices {mats_gap:.3g} of the largest from "
        f"float64 (jax {rec['vcm']['jax_mats_max_gap']:.3g}); ratios {ratio_gap:.3g} (jax "
        f"{rec['vcm']['jax_ratio_max_gap']:.3g}); edges {int(edge.sum())} (jax {rec['vcm']['edges']}), "
        f"{edges_differ} differ from JAX's away from the threshold")
    require(not parted.any() or float(gap64[parted].max()) <= 1e-6,
            f"{label}: owners not float64's away from a near-tie")
    require(mats_gap <= 1e-5 and ratio_gap <= 1e-5 and edges_differ == 0,
            f"{label}: matrices {mats_gap:.3g} or ratios {ratio_gap:.3g} off float64, or {edges_differ} edges unlike JAX")

    # VCM at 40960 points on each tools original: the kernel against the plain version.
    vcm_runs, launches, shapes = [], 0, defaultdict(int)
    for family in range(4):
        label = f"vcm {family}"
        pts, mask, samples = vcm_inputs(torch, dev, family)
        args = (pts, mask, VCM_RADIUS, VCM_RADIUS)
        (edge, ratio), ms, peak, n, hist = counted(
            lambda: tv.vcm_edges(*args, samples=samples, samples_per_point=VCM_SAMPLES))
        key = shape_key(1, len(samples), len(pts), 1)
        require(hist.get(key, 0) >= 1, f"{label}: nn1 did not launch at {key}: {hist}")
        launches += n
        for k, v in hist.items():
            shapes[k] += v
        owner, dom = tv.sample_owners(samples, pts, mask, VCM_RADIUS)
        mats = tv.vcm(*args, samples=samples, samples_per_point=VCM_SAMPLES)
        with plain_nn1(tv):
            (pedge, pratio), plain_ms, _, _, _ = counted(
                lambda: tv.vcm_edges(*args, samples=samples, samples_per_point=VCM_SAMPLES))
            powner, pdom = tv.sample_owners(samples, pts, mask, VCM_RADIUS)
            pmats = tv.vcm(*args, samples=samples, samples_per_point=VCM_SAMPLES)
        require(torch.equal(owner, powner) and torch.equal(dom, pdom), f"{label}: owners differ from the plain version")
        require(torch.allclose(mats, pmats, rtol=1e-5, atol=1e-5 * float(pmats.abs().max())) and torch.equal(edge, pedge),
                f"{label}: matrices or flags differ from the plain version")
        log(f"  [{label}] {len(pts)} points x {VCM_SAMPLES} samples: owners bit for bit the plain version's, matrices "
            f"max|diff| {float((mats - pmats).abs().max()):.3g}, flags equal; {int(edge.sum())} edge points; "
            f"{ms:.1f} ms to a sync (plain {plain_ms:.1f} ms), peak {peak:.1f} MiB, nn1 launches {hist} ({card})")
        vcm_runs.append({"family": family, "ms": ms, "plain_ms": plain_ms, "peak_mib": peak, "edges": int(edge.sum())})
        if family == 0:  # where the time and the memory go, step by step (each from the step's inputs)
            site, *site_fig = counted(lambda: tv.site_matrices(samples, pts, mask, VCM_RADIUS, VCM_SAMPLES))
            conv, *conv_fig = counted(lambda: tv.convolve(pts, mask, site, VCM_RADIUS))
            _, *eig_fig = counted(lambda: tv.edge_ratio(conv.reshape(-1, 3, 3)))
            log(f"  [{label}] by step, ms to a sync and peak MiB: owners and site sums {site_fig[0]:.1f} / "
                f"{site_fig[1]:.1f}, convolution {conv_fig[0]:.1f} / {conv_fig[1]:.1f}, eigvalsh {eig_fig[0]:.1f} / "
                f"{eig_fig[1]:.1f} ({card})")
    e2e["passes"]["vcm"] = {"launches": {"nn1": launches, "nn1_shapes": dict(shapes)}, "runs": vcm_runs}

    # Lloyd at the record's size against JAX and float64, then at phase 4k's size against the plain version.
    label = "lloyd record"
    start = torch.as_tensor(arrays["lloyd_start"], device=dev)
    smask = torch.ones(len(start), dtype=torch.bool, device=dev)
    out = tvor.lloyd_relax(start, smask, tuple(a["bbox"]), a["lloyd_resolution"], a["lloyd_iterations"]).cpu().numpy()
    gap = float(np.abs(out - arrays["lloyd_sites_f64"]).max())
    log(f"  [{label}] {len(start)} sites at {a['lloyd_resolution']}² for {a['lloyd_iterations']} steps: max |Δ| to "
        f"float64 {gap:.3g} (jax {rec['lloyd']['jax_max_gap']:.3g}, {rec['lloyd']['jax_labels_not_float64']} of its "
        f"first labels not float64's); to JAX's sites {float(np.abs(out - arrays['lloyd_sites']).max()):.3g}")
    require(gap <= rec["lloyd"]["jax_max_gap"], f"{label}: farther from float64 than JAX ({gap:.3g})")
    label = "lloyd"
    start = torch.as_tensor(lloyd_start(LLOYD["sites"]), device=dev)
    smask = torch.ones(len(start), dtype=torch.bool, device=dev)
    run = (start, smask, (0.0, 0.0, 1.0, 1.0), LLOYD["resolution"], LLOYD["iterations"])
    out, ms, peak, n, hist = counted(lambda: tvor.lloyd_relax(*run))
    key = shape_key(1, LLOYD["resolution"] ** 2, LLOYD["sites"], 1)
    require(hist.get(key, 0) == LLOYD["iterations"], f"{label}: nn1 launches {hist}, one at {key} a step expected")
    with plain_nn1(tvor):
        plain, plain_ms, _, _, _ = counted(lambda: tvor.lloyd_relax(*run))
    require(torch.equal(out, plain), f"{label}: sites differ from the plain version's, max |Δ| "
                                     f"{float((out - plain).abs().max()):.3g}")
    log(f"  [{label}] {LLOYD['sites']} sites at {LLOYD['resolution']}² for {LLOYD['iterations']} steps: the plain "
        f"version's bits; {ms:.1f} ms to a sync (plain {plain_ms:.1f} ms), peak {peak:.1f} MiB, nn1 launches {hist} "
        f"({card})")
    e2e["passes"]["voronoi"] = {"launches": {"nn1": n, "nn1_shapes": hist}, "ms": ms, "plain_ms": plain_ms,
                                "peak_mib": peak}

    # Mesh angles on a seeded, jittered torus grid of about 200k faces, against float64.
    label = "mesh angles"
    rng = np.random.default_rng(0)
    m = 317
    u, v = np.meshgrid(np.linspace(0, 2 * np.pi, m), np.linspace(0, 2 * np.pi, m), indexing="ij")
    verts = np.stack([(1 + 0.4 * np.cos(v)) * np.cos(u), (1 + 0.4 * np.cos(v)) * np.sin(u), 0.4 * np.sin(v)], -1)
    verts = (verts.reshape(-1, 3) + rng.normal(0, 0.0005, (m * m, 3))).astype(np.float32)
    ij = np.arange(m * m).reshape(m, m)[:-1, :-1].ravel()
    faces = np.concatenate([np.stack([ij, ij + 1, ij + m], -1), np.stack([ij + 1, ij + m + 1, ij + m], -1)])
    tv_, tf_ = torch.as_tensor(verts, device=dev), torch.as_tensor(faces, device=dev)
    rep, ms, _, _, _ = counted(lambda: measure_mesh.mesh_angle_report(tv_, tf_))
    ang = measure_mesh.triangle_angles(tv_, tf_).cpu().numpy().astype(np.float64)
    w = verts.astype(np.float64)[faces]

    def corner(p, q, r):
        x, y = q - p, r - p
        c = (x * y).sum(-1) / (np.linalg.norm(x, axis=-1) * np.linalg.norm(y, axis=-1))
        return np.arccos(np.clip(c, -1.0, 1.0))

    ang64 = np.stack([corner(w[:, 0], w[:, 1], w[:, 2]), corner(w[:, 1], w[:, 0], w[:, 2]),
                      corner(w[:, 2], w[:, 0], w[:, 1])], -1)
    edges = rep["bin_edges"].astype(np.float64)
    idx = np.searchsorted(edges, ang64.ravel(), side="right")
    idx = np.where(ang64.ravel() == edges[-1], len(edges) - 1, idx)
    hist64 = np.bincount(idx, minlength=len(edges) + 1)[1:len(edges)]
    near = int((np.abs(ang64.ravel()[:, None] - edges[None]).min(1) < 1e-6).sum())
    moved = int(np.abs(rep["histogram"] - hist64).sum())
    angle_gap = float(np.abs(ang - ang64).max())
    log(f"  [{label}] {len(faces)} faces: angles max |Δ| to float64 {angle_gap:.3g} rad; histogram {moved} counts "
        f"from float64's, {near} angles within 1e-6 of an edge; slivers {int(rep['sliver_count'])}; {ms:.1f} ms to a "
        f"sync ({card})")
    require(angle_gap <= 1e-5 and moved <= 2 * near and int(rep["count"]) == 3 * len(faces),
            f"{label}: angles {angle_gap:.3g} from float64 or histogram {moved} counts off ({near} near an edge)")
    e2e["passes"]["mesh angles"] = {"ms": ms, "faces": len(faces)}


def phase_view_native(torch, dev, e2e: dict, card: str) -> None:
    """4k: `python -m kss_icp_torch view` as subprocesses, their PNGs JAX's by
    sha256 (fixtures/torch_port_expected_analysis.json); the native reader
    against the Python readers on Room seed 0's 200k source as .xyz, binary
    .ply and .off, and load_points_batch over the 50 remesh clouds."""
    import hashlib
    import tempfile

    from kss_icp_torch import native
    from kss_icp_torch.io import formats
    from kss_icp_torch.largescan import room_pair

    rec = json.loads((FIXTURES / "torch_port_expected_analysis.json").read_text())
    src, tgt, _ = room_pair(200_000, 0)
    pairs = load_pairs()
    refused0 = native.load_points_native.refused
    with tempfile.TemporaryDirectory(prefix="kss_view_") as tmp:
        tmp = Path(tmp)
        name, psrc, ptgt = pairs[0]
        formats.save_xyz(tmp / f"{name}.gird", psrc)
        formats.save_xyz(tmp / f"{name}.wlop", ptgt)
        formats.save_xyz(tmp / "room0_target.xyz", tgt)
        # Both views at once: each subprocess is mostly its interpreter's start-up.
        walls, procs = {}, []
        for i, view in enumerate(rec["views"]):
            argv = [str(tmp / f"view_{i}.png") if x == "view.png" else
                    str(tmp / x) if (tmp / x).suffix in (".gird", ".wlop", ".xyz") else x for x in view["argv"]]
            procs.append((view, tmp / f"view_{i}.png", time.perf_counter(),
                          subprocess.Popen([sys.executable, "-m", "kss_icp_torch", *argv], stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True, cwd=REPO)))
        deadline = time.perf_counter() + 300
        while any(proc.poll() is None for *_, proc in procs) and time.perf_counter() < deadline:
            for view, _, t0, proc in procs:
                if proc.poll() is not None and view["label"] not in walls:
                    walls[view["label"]] = time.perf_counter() - t0
            time.sleep(0.01)
        for view, png, t0, proc in procs:
            _, err = proc.communicate(timeout=10)
            walls.setdefault(view["label"], time.perf_counter() - t0)
            require(proc.returncode == 0, f"view {view['label']}: exit {proc.returncode}\n{err[-3000:]}")
            digest = hashlib.sha256(png.read_bytes()).hexdigest()
            log(f"  [view] {view['label']}: {' '.join(view['argv'])}: png sha256 {digest[:16]}… "
                f"({'JAX' if digest == view['png_sha256'] else 'NOT JAX'}'s), {walls[view['label']]:.2f} s wall, "
                f"the two at once ({card})")
            require(digest == view["png_sha256"], f"view {view['label']}: the PNG is not JAX's")

        files = {"xyz": tmp / "room0_source.xyz", "ply": tmp / "room0_source.ply", "off": tmp / "room0_source.off"}
        formats.save_xyz(files["xyz"], src, prefer_native=False)
        formats.save_ply(files["ply"], src)
        formats.save_off(files["off"], src)
        times = {}
        for kind, path in files.items():
            for reader, prefer in (("native", True), ("python", False)):
                t0 = time.perf_counter()
                got = formats.load_points(path, prefer_native=prefer)
                times[f"{kind} {reader}"] = (time.perf_counter() - t0) * 1e3
                if reader == "native":
                    fast = got
            require(np.array_equal(fast, got), f"native {kind}: the native and Python readers' arrays differ")
        native.save_xyz_native(tmp / "native.xyz", src)
        require((tmp / "native.xyz").read_bytes() == files["xyz"].read_bytes(),
                "native save_xyz: bytes differ from the Python writer's")
        clouds = []
        for name, s, t in pairs:
            for ext, c in (("gird", s), ("wlop", t)):
                clouds.append(tmp / f"{name}.{ext}")
                formats.save_xyz(clouds[-1], c)
        t0 = time.perf_counter()
        batch = native.load_points_batch(clouds)
        times["batch of 50 remesh clouds, native"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        each = [formats.load_points(p, prefer_native=False) for p in clouds]
        times["50 remesh clouds one at a time, python"] = (time.perf_counter() - t0) * 1e3
        require(all(b is not None and np.array_equal(b, e) for b, e in zip(batch, each)),
                "load_points_batch: arrays differ from the Python readers'")
    refused = native.load_points_native.refused - refused0
    log("  [native] load ms: " + ", ".join(f"{k} {v:.2f}" for k, v in times.items()) +
        f"; save_xyz bytes equal; files the parser refused {refused} ({card})")
    require(refused == 0, f"native: the parser refused {refused} files it reads")
    e2e["passes"]["view"] = {"walls": walls}
    e2e["passes"]["native"] = {"load_ms": times, "refused": refused}


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

    def lap(phase: str) -> None:
        log(f"   ({phase} done at {time.perf_counter() - t_start:.1f} s)")
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
    lap("3")

    log("== 4. end to end")
    e2e = phase_end_to_end(torch, dev, kernels)
    lap("4a-4c")
    p = e2e["passes"]
    log(f"pairs/s on the remesh 25 (no stage syncs): escalation off default {p['default']['pairs_per_s']:.3f}, "
        f"bench {p['bench']['pairs_per_s']:.3f}; escalation on default {p['esc-default']['pairs_per_s']:.3f}, "
        f"bench {p['esc-bench']['pairs_per_s']:.3f}, dot {p['esc-dot']['pairs_per_s']:.3f}; boards "
        f"{p['boards']['pairs_per_s']:.3f} ({card})")

    log("== 4d. DEFAULT_CONFIG (the overlap tier on): remesh 25")
    phase_default_config(torch, dev, kernels, e2e)
    lap("4d")
    log(f"shipped DEFAULT_CONFIG: remesh 25 {p['shipped']['pairs_per_s']:.3f} pairs/s (no stage syncs), "
        f"boards {p['shipped boards']['pairs_per_s']:.3f} pairs/s (synced) ({card})")

    log("== 4e. register_many at DEFAULT_CONFIG: the remesh 25 as one batch")
    phase_many(torch, dev, kernels, e2e)
    lap("4e")
    log(f"register_many at DEFAULT_CONFIG: remesh 25 in one batch {p['many']['pairs_per_s']:.3f} pairs/s (no stage "
        f"syncs) beside register_pair's {p['shipped']['pairs_per_s']:.3f}; boards {p['many boards']['pairs_per_s']:.3f} "
        f"pairs/s (synced) beside {p['shipped boards']['pairs_per_s']:.3f} ({card})")

    log("== 4f. large scans: run_largescan at 200k points, DEFAULT_CONFIG, Room seeds 0-2")
    phase_largescan(torch, dev, e2e, card)
    lap("4f")
    log("large scans: " + "; ".join(f"seed {r['seed']} total {r['total_s']:.4f} s (octree {r['octree_s']:.4f}, register "
                                    f"{r['register_s']:.4f}, metric {r['metric_s']:.4f})"
                                    for r in p["largescan"]["seeds"]) + f" ({card})")

    log("== 4g. precision mode (--precise): the remesh 25 one pair at a time")
    phase_precise(torch, dev, kernels, e2e, card)
    lap("4g")
    log(f"precision mode: remesh 25 {p['precise']['pairs_per_s']:.3f} pairs/s (without the polish "
        f"{p['shipped']['pairs_per_s']:.3f}), in one batch {p['precise many']['pairs_per_s']:.3f}; category "
        f"{p['precise category']['passed']}/32 pass ({card})")

    log("== 4h. the command line on the card: python -m kss_icp_torch")
    phase_cli(torch, dev, e2e, card)
    lap("4h")
    for n, count in p["cli"]["launches"].items():
        kernels[n]["cli_launches"] = count

    log("== 4i. the knobs: point_to_plane, max, diff and aivs at DEFAULT_CONFIG")
    phase_knobs(torch, dev, kernels, e2e, card)
    lap("4i")
    log("knobs: remesh 25 pairs/s " + ", ".join(f"{k} {p['knob ' + k]['pairs_per_s']:.3f}"
                                                for k in ("point_to_plane", "max", "diff", "aivs")) +
        f"; register_many aivs {p['many aivs']['pairs_per_s']:.3f}, point_to_plane "
        f"{p['many point_to_plane']['pairs_per_s']:.3f}; category at point_to_plane "
        f"{p['knob point_to_plane category']['passed']}/32 pass ({card})")

    log("== 4j. the tools: make-pairs -> batch, WLOP, hierarchy, measure-resample, the pipeline at 40960 points")
    phase_tools(torch, dev, e2e, card)
    lap("4j")
    t = p["tools"]
    log("tools: " + "; ".join(f"{n} wlop {r['wlop_ms']:.1f} ms (peak {r['wlop_peak_mib']:.1f} MiB), hierarchy "
                              f"{r['hierarchy_ms']:.1f} ms, measure {r['measure_ms']:.1f} ms, RMSE {r['rmse']:.6f}"
                              for n, r in t["originals"].items()) +
        "; walls " + ", ".join(f"{k} {v:.2f} s" for k, v in t["walls"].items()) + f" ({card})")

    log("== 4k. the two-stage converge: remesh 25 one pair at a time and in one batch, the boards in one batch")
    phase_two_stage(torch, dev, e2e, card)
    lap("4k two-stage")
    log("== 4k. the analysis ops: vcm_edges, lloyd_relax, mesh_angle_report")
    phase_analysis(torch, dev, e2e, card)
    lap("4k analysis")
    log("== 4k. view and the native reader")
    phase_view_native(torch, dev, e2e, card)
    lap("4k view and native")
    attach_pass_launches(kernels, e2e)
    log(f"two-stage, pairs/s in turns with shipped: remesh 25 {p['two-stage']['pairs_per_s']:.3f} (shipped "
        f"{p['two-stage']['shipped_pairs_per_s']:.3f}), in one batch {p['two-stage many']['pairs_per_s']:.3f} (shipped "
        f"{p['two-stage many']['shipped_pairs_per_s']:.3f}); boards in one batch "
        f"{p['two-stage many boards']['pairs_per_s']:.3f} synced (shipped "
        f"{p['two-stage many boards']['shipped_pairs_per_s']:.3f}); vcm " + ", ".join(f"{r['ms']:.1f}" for r in p["vcm"]["runs"]) +
        f" ms; lloyd {p['voronoi']['ms']:.1f} ms; mesh angles {p['mesh angles']['ms']:.1f} ms ({card})")

    log("== 5. bf16 dot field against the float32 fields (gates nothing)")
    phase_bf16_ranking(torch, dev)
    log(f"smoke run {time.perf_counter() - t_start:.1f} s ({card})")

    keys = ("name", "route", "source", "replaces", "also_replaces", "launches", "cli_launches", "max_abs_err", "ms", "device_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "yardstick", "yardstick_ms", "shape", "precision", "cases",
            "launch_shapes", "squared")
    line = {"kernels": [{k: v for k, v in dict(kernels[n], name=n, route="cuda", library_ms=None).items() if k in keys}
                        for n in ("nn1", "fps", "field_ave", "field_dot", "field_trim")]}
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
