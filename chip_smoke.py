#!/usr/bin/env python3
"""Smoke run of the PyTorch port (kss_icp_torch) on one CUDA card.

    python3 chip_smoke.py                # one card: every phase below
    python3 chip_smoke.py --mesh-cards   # 2+ cards: phases 1, 2 and 4l's NCCL
                                         # world over the cards alone

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
     its launches from the 4j pass; fps's cluster cases: every cluster
     size with the slices in registers and in shared memory, ties across
     the blocks (a cloud tiled 4x) at steps = S, < S and 0, and
     MAX_POINTS, each printing its plan and its empty steps (the plan's
     cluster and threads on one point a block), and a cloud past
     MAX_POINTS and a cluster of 32 blocks, which must raise; field_ave
     (the culling kernel's "ave" statistic) bit for bit and field_dot (the
     tensor-core kernel) at "highest" and "default" within rtol 2e-5,
     on the base grid C=512, P=T=2048 and the
     escalation grid C=4096, P=T=512, mostly valid, and on the base grid
     with both clouds suffix-masked to the largest and smallest remesh
     pair's pnumber, 1534 and 378, where the field must also equal its
     valid prefix's bit for bit, and on the base grid at the bench
     config's 512-point prefixes, C=512, P=T=512 (field_ave also at a mesh
     rank's 1024 x 2048 x 2048) and time both with CUDA
     events, calls back to back (`ms`, as the ICP loop pays them), and
     each kernel also by
     CUDA-graph replay (`device_ms`, the device's time of a call, field_order
     included for field_ave); field_ave with its share of pairs scanned and
     its bound on the pairs scanned and the box tests (the brute-force one
     as `bruteforce_bound_ms`), field_dot with its bound on the valid rows
     (at "highest" the cheaper of the float32 and the tensor-core route),
     its SASS's tensor-core instructions and the kernels one call launches
     (torch.profiler); each with a PyTorch composition as a
     yardstick; field_trim (the overlap tier's trimmed field: one launch
     that rotates, culls target tiles exactly and reduces each row) bit for
     bit, its probe mode's per-point distances and the fused field, at
     512 x 2048 x 2048 and 4096 x 2048 x 2048 with ~70% scattered inlier
     masks on both clouds, 4096 x 2048 x 2048 padded and a fully masked
     target, each with its share of (point, row) pairs scanned and its
     bound on the pairs scanned and the box tests made (`bound_ms`; the
     brute-force pairs' as `bruteforce_bound_ms`); field_sq
     (the same kernel's "max" and "diff" fields) bit for bit at
     512 x 2048 x 2048 and 4096 x 2048 x 2048 (~70% masks), 4096 x 512 x 512,
     a fully masked target and 8 x 40000 x 20000 (the mins past shared
     memory in a device scratch, the target in chunks), its numbers under field_trim's row as
     `squared` with its launches from 4i; field_keys (the sort keys of
     field_trim's preparation) bit for bit at 2048 + 2048, 512 + 512 and
     2048 + 4173 rows, with its launches from 4d (one a field_trim launch);
     icp_update (the update of a lockstep ICP step) against its plain
     version at the cells' step shapes, 2048 x 512 and 256 x 2048 lanes x
     points against 64 clouds, 8192 x 512 against 16 trimmed with scale,
     and 1 x 2000 (R and t within 2e-5, s and the MSE within rtol 2e-5,
     inactive lanes bit for bit), timed against the bound of its bytes,
     with its launches from 4b; plain PyTorch timings, gating nothing, of the AIVS
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
          must name nn1_kernel, fps_kernel and field_cull_kernel and
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
       l. the device mesh (kss_icp_torch.parallel on torch.distributed):
          4 gloo ranks sharing this card, spawned (torch.multiprocessing,
          spawn) after the build and rendezvoused through a FileStore in a
          temporary directory, each with the same global inputs: the 16³
          field sharded over "rot" on the largest remesh pair's resampled
          pre-shapes (the unsharded field's bits), point-sharded ICP of a
          noisy 2048-point copy (pose within 1e-5, fitness rtol 1e-4, ±1
          iteration of the unsharded ICP), the metric sharded over Room
          seed 0's 200704 query rows (rtol 1e-5), and register_many over a
          "pairs" mesh on the remesh 25 at DEFAULT_CONFIG (JAX's batch
          record + 0.006, JAX's escalated set), at coarse_method="dot" and
          at the forced ladder of __graft_entry__.py:140-146 (each of the
          three against the unsharded batch: escalations and rungs run,
          RMSE within 0.006 and pose within 1.75e-2, each pair whose pose
          parts by more than 1e-5 named: a batch's answers are not one
          pair's bits, ROADMAP queue 3); every rank's
          answer must equal rank 0's; pairs/s of the mesh call beside the
          unsharded batch in turns (overhead on one card, not scaling),
          each rank's stage seconds and their max, the ranks' launches
          summed (nn1, fps, field_ave, field_dot and field_trim must all
          launch); then an NCCL group of world size 1 through the same entry
          points, and with 2+ cards NCCL over min(4, count), one rank a
          card; a rank that fails, dies or outlasts the group's timeout
          fails the run; phase 3 holds nn1, fps and field_ave at a rank's
          shapes, with launches from 4l, and every nn1 shape the 4 ranks
          launch must be one phase 3 held;
       m. the reference oracle (kss_icp_torch/oracle.py: numpy + scipy in
          float64 on the host, sharing no code with the port's pipeline):
          register_pair_oracle and pcr_qm on the remesh 25 and the category
          board (57 pairs) in a spawned process pool, a worker a core and one
          BLAS thread each (the workers never touch the card), each pair's
          candidate count and multi-start flag equal to
          fixtures/torch_port_expected_oracle.json (JAX's oracle on the CPU)
          and mse, rmse and mae within 1e-6 of it; the port's full-resolution
          RMSE at DEFAULT_CONFIG (4d's passes) at most the oracle's + 0.006
          on every pair (tests/test_parity_vs_oracle.py's band), both
          printed; the native rotation scan (native/oracle_hot.cpp, float32
          points) within rtol 1e-5 of the numpy field on remesh pair 0, with
          both scans' seconds; the oracle's seconds a pair and a stage
          (median and largest) beside the host CPU's model;
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
import os
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
# float32 operations of one box test of the field_trim kernel (csrc/field_trim.cu::box_bound and
# its compare): 6 subtractions, 6 max, 3 products, 2 sums, 1 compare.
BOX_TEST_OPS = 18.0
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


def mesh_slices(n: int) -> list:
    """Each of phase 4l's MESH_WORLD ranks' pair indices: its contiguous
    slice of n pairs, the last padded by repeating pair n - 1, as
    parallel/batch.py splits the "pairs" axis."""
    per = -(-n // MESH_WORLD)
    return [[min(i, n - 1) for i in range(k * per, (k + 1) * per)] for k in range(MESH_WORLD)]


def mesh_nn1_cases() -> list:
    """Phase 3's nn1 cases at the shapes of phase 4l's register_many ranks
    that no other case holds. Each rank registers its slice of the remesh
    25 (7 pairs), lane_ref = the lane's pair: at DEFAULT_CONFIG and at the
    forced ladder, 32 lanes a pair x 512 (screen), 4 x 2048 (refine), 16 x
    512 (escalation screen), 3 and 1 x 2048 (the re-solves' and the
    finisher's), 512 x 512 and 512 x 2048 forward and reverse (the overlap
    screen), the metric at 8192; and the escalation's shapes over each
    rank's count of JAX's escalated pairs (fixtures/torch_port_expected_batch.json).
    nn1_plan picks a kernel configuration by lanes x tiles, so these shapes
    run cluster sizes the unsharded batch's do not."""
    slices = mesh_slices(len(load_pairs()))
    per = len(slices[0])
    esc = [r["escalated"] for r in json.loads((FIXTURES / "torch_port_expected_batch.json").read_text())["pairs"]]
    counts = sorted({sum(esc[i] for i in rows) for rows in slices} - {0})
    rank = f"a mesh rank's {per} pairs"
    shapes = [(per * 32, 512, 2048, per, f"{rank} x 32 lanes (screen ICP)", (378, 1534)),
              (per * 4, 2048, 2048, per, f"{rank} x 4 lanes (refine ICP)", (378, 1534)),
              (per * 16, 512, 2048, per, f"{rank} x 16 lanes (forced ladder's escalation screen)", (378, 1534)),
              (per * 3, 2048, 2048, per, f"{rank} x 3 lanes (forced ladder)", (378, 1534)),
              (per, 2048, 2048, per, f"{rank} x 1 lane (forced ladder)", (378, 1534)),
              (per * 512, 512, 2048, per, f"{rank} x 512 lanes (overlap screen ICP)", (378, 1534)),
              (per * 512, 2048, 2048, per, f"{rank} x 512 lanes (overlap screen fitness, forward)", (378, 1534)),
              (per * 512, 2048, 2048, per * 512, f"{rank} x 512 lanes (overlap screen fitness, reverse)", (378, 1534)),
              (per, BATCH_PAD, BATCH_PAD, per, f"{rank}' metric: lane b against cloud b", (3951, 8000))]
    for k in counts:
        esc_rank = f"a mesh rank's {k} escalated pair{'s' if k > 1 else ''}"
        shapes += [(k * 16, 512, 2048, k, f"{esc_rank} x 16 lanes (escalation screen)", (378, 1534)),
                   (k * 4, 2048, 2048, k, f"{esc_rank} x 4 lanes (escalation refine)", (378, 1534)),
                   (k, 2048, 2048, k, f"{esc_rank} x 1 lane (escalation)", (378, 1534))]
    # Shapes that another case holds (a rank with one escalated pair runs
    # the single-pair escalation's) take their launches from that case's pass.
    held = {(16, 512, 2048, 1), (4, 2048, 2048, 1)}
    return [(lanes, q_n, r_n, g, label, valid, "mesh") for lanes, q_n, r_n, g, label, valid in shapes
            if (lanes, q_n, r_n, g) not in held]


def phase_kernels(torch, dev) -> dict:
    from kss_icp_torch.config import DEFAULT_CONFIG
    from kss_icp_torch.core.cloud import PointCloud
    from kss_icp_torch.core.transforms import euler_xyz_matrix
    from kss_icp_torch.models.coarse import rotation_grid
    from kss_icp_torch.ops.coarse_cuda import dot_operands, dot_plan, field_dot, field_dot_plain
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
             f"against {LLOYD['sites']} sites, 2D padded to z = 0", None, "voronoi"),
            (1, MESH_ICP_POINTS // MESH_WORLD, MESH_ICP_POINTS, 1,
             f"point-sharded ICP: one of {MESH_WORLD} ranks' rows", None, "mesh"),
            (1, scan["metric"][0].shape[1] // MESH_WORLD, scan["metric"][1].shape[1], 1,
             f"sharded large-scan metric: one of {MESH_WORLD} ranks' rows, Room seed {scan['seed']}", None, "mesh"),
            *mesh_nn1_cases()):
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
            elif batch == "mesh" and q_n * MESH_WORLD == scan["metric"][0].shape[1]:  # rank 0's rows of the scan
                query, ref, mask = scan["metric"][0][:, :q_n].contiguous(), *scan["metric"][1:]
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
                           "yardstick_ms": yard_ms, "plan": plan._asdict()}, **b))
        log(f"  nn1 {lanes}x{q_n}x{r_n} G={groups} ({label}): indices and d2 identical; kernel {ms:.4f} ms a wrapper "
            f"call back to back, {device_ms:.4f} ms on the device (graph replay), plain {plain_ms:.4f} ms, "
            f"cdist+min {yard_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}); plan: a cluster of "
            f"{plan.cluster} splits R into slices of {plan.slice} rows, {plan.queries} queries a thread")
    out["nn1"] = dict(cases[0], cases=cases, source="kss_icp_torch/csrc/nn.cu",
                      replaces="kss_icp_tpu/ops/nn_pallas.py:118",
                      also_replaces="kss_icp_tpu/ops/nn_pallas.py:183",
                      yardstick="torch.cdist(query, valid_ref).min(-1), 4096 queries a call")

    from kss_icp_torch.ops.resample_cuda import MAX_POINTS, block_plan, empty_step_plan, fps_plan

    sms = sm_count(dev.index or 0)
    b_n, p_n, s = 2, 8192, 2048
    pts = t(np.stack([cloud(rng, p_n) for _ in range(b_n)]))
    pmask = torch.ones((b_n, p_n), dtype=torch.bool, device=dev)
    pmask[0, 8000:] = False
    pmask[1, 6201:] = False
    # (points, mask, S, steps, label, the 4x pass whose launches the case
    # reports, each cloud's picks (default: steps), a plan other than the
    # wrapper's)
    fps_cases = [(pts, pmask, s, s, "table shape", None, None, None)]
    # register_pair's two launches on the remesh pair with the most picks,
    # padded as PointCloud.from_points pads them.
    remesh = load_pairs()
    _, src, tgt = max(remesh, key=lambda r: DEFAULT_CONFIG.resample_count(len(r[1]), len(r[2])))
    steps = DEFAULT_CONFIG.resample_count(len(src), len(tgt))
    for points, label in ((src, "remesh source"), (tgt, "remesh target")):
        c = PointCloud.from_points(points, device=dev)
        fps_cases.append((c.points[None].contiguous(), c.mask[None].contiguous(), DEFAULT_CONFIG.resample_pad,
                          steps, label, None, None, None))
    # register_many's one launch a batch: each corpus's sources and targets
    # padded to full_pad 8192, steps = the largest pnumber; pair b needs
    # pnumber_b picks.
    rank0 = [remesh[i] for i in mesh_slices(len(remesh))[0]]
    for corpus, label, batch in ((remesh, "batch resample: the remesh 25's 50 clouds at full_pad 8192", "many"),
                                 ([(n, a, b) for n, a, b, *_ in boards],
                                  "batch resample: the boards' 128 clouds at full_pad 8192", "many boards"),
                                 (rank0, f"a mesh rank's resample: rank 0's {len(rank0)} pairs' {2 * len(rank0)} "
                                  "clouds at full_pad 8192", "mesh")):
        counts = [DEFAULT_CONFIG.resample_count(len(a), len(b)) for _, a, b in corpus]
        clouds = [a for _, a, _ in corpus] + [b for _, _, b in corpus]
        pts = np.zeros((len(clouds), BATCH_PAD, 3), np.float32)
        for i, c in enumerate(clouds):
            pts[i, :len(c)] = c
        bmask = t(np.arange(BATCH_PAD)[None] < np.array([len(c) for c in clouds])[:, None])
        fps_cases.append((t(pts), bmask, DEFAULT_CONFIG.resample_pad, max(counts), label, batch, counts + counts,
                          None))
    # run_largescan's one launch a run: both compacted survivor clouds, steps =
    # pnumber; seed 2's first cloud leaves the cluster's last blocks masked.
    s_pts, s_mask, s_steps = scan["fps"]
    fps_cases.append((s_pts, s_mask, DEFAULT_CONFIG.resample_pad, s_steps,
                      f"large-scan resample: Room seed {scan['seed']}'s compacted octree survivors", "largescan",
                      None, None))
    # WLOP's start in 4j: one launch a 40960-point tools original, every step of 8000.
    from kss_icp_torch.challenge import _instance

    tools = load_tools()[0]["config"]
    fps_cases.append((t(_instance(0, 0, tools["n_points"], sample=0))[None].contiguous(),
                      torch.ones((1, tools["n_points"]), dtype=torch.bool, device=dev), tools["wlop_points"],
                      tools["wlop_points"], "WLOP start: a 40960-point tools original (4j)", "tools", None, None))
    # The cluster's own cases: every cluster size with the slices in registers
    # (3000 points a block, ragged) and in shared memory (9000), with an
    # invalid first point of the last block and a first block wholly masked;
    # ties across the blocks' borders (a cloud tiled 4x) at all picks, at
    # steps < S and at steps = 0; and MAX_POINTS.
    for cluster in (1, 2, 4, 8, 16):
        for per_block in (3000, 9000):
            n = cluster * per_block - 7
            plan = block_plan(n, cluster)
            cmask = torch.ones((2, n), dtype=torch.bool, device=dev)
            cmask[0, plan.slice * (cluster - 1)] = False
            cmask[1, :plan.slice] = False
            cmask[1, n - n // 3:] = False
            fps_cases.append((t(np.stack([cloud(rng, n) for _ in range(2)])), cmask, 2048, 2000,
                              f"cluster of {cluster}, {'registers' if plan.registers else 'shared memory'}", None,
                              None, plan))
    tiled = t(np.tile(cloud(rng, 9001), (4, 1))[None])
    for tie_steps in (2048, 700, 0):
        fps_cases.append((tiled, torch.ones((1, 36004), dtype=torch.bool, device=dev), 2048, tie_steps,
                          f"ties across blocks: 9001 points tiled 4x, {tie_steps} steps", None, None, None))
    fps_cases.append((t(cloud(rng, MAX_POINTS)[None]), torch.ones((1, MAX_POINTS), dtype=torch.bool, device=dev),
                      2048, 2048, "MAX_POINTS", None, None, None))
    cases = []
    for pts, pmask, s, steps, label, batch, picks, plan in fps_cases:
        b_n, p_n = pmask.shape
        picks = np.array(picks if picks else [steps] * b_n)
        plan = plan or fps_plan(b_n, p_n, sms)
        ik, smk = fps(pts, pmask, s, steps, plan=plan)
        ip, smp = farthest_point_sampling(pts, pmask, s, steps)
        torch.cuda.synchronize()
        require(torch.equal(ik, ip) and torch.equal(smk, smp),
                f"fps {label}: indices differ at {int((ik != ip).sum())} of {b_n * s} picks (plan {tuple(plan)})")
        ms = time_ms(lambda: fps(pts, pmask, s, steps, plan=plan), 5)
        device_ms = graph_ms(lambda: fps(pts, pmask, s, steps, plan=plan), 5)
        plain_ms = time_ms(lambda: farthest_point_sampling(pts, pmask, s, steps), 1)
        # The empty step: the plan's cluster and threads on one point a block;
        # steps of it are the floor the run sits on.
        floor_plan = empty_step_plan(plan)
        one = torch.zeros((b_n, plan.cluster, 3), device=dev)
        one_mask = torch.ones((b_n, plan.cluster), dtype=torch.bool, device=dev)
        floor_ms = graph_ms(lambda: fps(one, one_mask, s, steps, plan=floor_plan), 5)
        # Per step and valid point: 3 sub + 3 mul + 2 add + 1 min + 1 compare. The
        # steps are a dependency chain the bound does not see (PERF.md).
        b = bound(10.0 * float((picks * pmask.sum(dim=1).cpu().numpy()).sum()),
                  4 * b_n * p_n * 3 + b_n * p_n + b_n * s * 5)
        cases.append(dict({"shape": f"{b_n}x{p_n}->{s}", "steps": steps, "label": label, "batch_pass": batch, "ms": ms,
                           "device_ms": device_ms, "plain_ms": plain_ms, "step_floor_ms": floor_ms,
                           "max_abs_err": 0.0, "plan": plan._asdict()}, **b))
        log(f"  fps B={b_n} P={p_n} S={s} steps={steps} ({label}): indices identical; {ms:.4f} ms a wrapper call "
            f"back to back, {device_ms:.4f} ms on the device (graph replay; centroid and mask ops included), "
            f"plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}; {steps} dependent steps), "
            f"empty steps {floor_ms:.4f} ms; plan: a cluster of {plan.cluster}, {plan.slice} points a block, "
            f"{plan.k} {'points' if plan.registers else 'scores'} a thread x {plan.threads} threads, x, y, z in "
            f"{'registers' if plan.registers else 'shared memory'}")
    # No fallback: a cloud past MAX_POINTS and a cluster the card cannot
    # schedule raise, launch nothing, and the next launch runs.
    before = fps.launches
    wide = torch.zeros((1, MAX_POINTS + 1, 3), device=dev)
    for label, call, error in (
            ("a cloud of MAX_POINTS + 1", lambda: fps(wide, torch.ones((1, MAX_POINTS + 1), dtype=torch.bool,
                                                                        device=dev), 8), ValueError),
            ("a cluster of 32 blocks", lambda: fps(tiled[:, :3200].contiguous(), torch.ones(
                (1, 3200), dtype=torch.bool, device=dev), 64, plan=block_plan(3200, 32)), RuntimeError)):
        try:
            call()
        except error as e:
            log(f"  fps refuses {label}: {e}")
        else:
            raise SmokeError(f"fps took {label}")
    require(fps.launches == before, f"fps launched {fps.launches - before} times on refused plans")
    ik, _ = fps(tiled, torch.ones((1, 36004), dtype=torch.bool, device=dev), 64)
    require(torch.equal(ik, farthest_point_sampling(tiled, torch.ones((1, 36004), dtype=torch.bool, device=dev),
                                                    64)[0]), "fps after a refused plan: picks differ")
    out["fps"] = dict(cases[0], cases=cases, yardstick_ms=None, source="kss_icp_torch/csrc/fps.cu",
                      replaces="kss_icp_tpu/ops/resample_pallas.py:102")

    def field_inputs(steps, n, valid, parts=1):
        """None: n - n/40 source and n - n/20 target rows valid; an int: both
        clouds suffix-masked to that many rows, as register_pair pads them.
        The grid's first 1/parts of the rotations (a rank's slice)."""
        src, tgt = t(cloud(rng, n)), t(cloud(rng, n))
        rows = torch.arange(n, device=dev)
        smask, tmask = (rows < n - n // 40, rows < n - n // 20) if valid is None else (rows < valid, rows < valid)
        return src, smask, tgt, tmask, euler_xyz_matrix(rotation_grid(steps, 6.3, dev))[:steps ** 3 // parts]

    def field_bytes(c_n, n):
        return 4 * (n * 3 * 2 + c_n * 9 + c_n) + 2 * n

    def chunked(fn, c_n, step=64):
        return lambda: [fn(c0, min(c0 + step, c_n)) for c0 in range(0, c_n, step)]

    # field_dot's operations per evaluation (rotation, valid source point,
    # valid target row), as (float32, bf16): at "highest" the cheaper of the
    # float32 route, 3 mul + 3 add (the bias included) + 1 min, and the
    # tensor-core route, the six bf16 products of the 3 coordinates (36
    # operations), the |t|² bias as one float32 add and one float32 min; at
    # "default" the K=4 bf16 product, 2 x 4 on a tensor core, and the float32
    # min. The kernels spend more (PERF.md).
    dot_routes = {"highest": ((7.0, 0.0), (2.0, 36.0)), "default": ((1.0, 8.0),)}
    # (grid steps, padded n, valid rows, label): the mostly valid cases; the
    # largest and smallest remesh pair's pnumber in register_pair's 2048 slots;
    # the bench config's 512-point prefixes, all valid from pnumber 512 on (23
    # of the 25 pairs).
    # And (4l, field_ave only) one of the mesh's ranks' 1024 rotations of the
    # 16³ grid at the largest remesh pair's pnumber.
    field_shapes = ((8, 2048, None, "base grid", 1), (16, 512, None, "escalation grid", 1),
                    (8, 2048, 1534, "base grid, largest remesh pair", 1),
                    (8, 2048, 378, "base grid, smallest remesh pair", 1), (8, 512, 512, "base grid, bench prefixes", 1),
                    (MESH_STEPS, 2048, 1534, f"mesh: one of {MESH_WORLD} ranks' rotations of the {MESH_STEPS}³ grid, "
                     "largest remesh pair", MESH_WORLD))
    cases = []
    for steps, n, valid, grid, parts in field_shapes:
        cases.append(field_ave_case(torch, dev, field_inputs(steps, n, valid, parts), grid, valid, parts))
    out["field_ave"] = dict(cases[0], cases=cases, yardstick="torch.cdist(rotated, valid_target).amin(-1), 64 "
                            "rotations a call", source="kss_icp_torch/csrc/field_trim.cu",
                            replaces="kss_icp_tpu/ops/coarse_pallas.py:201")
    cases = []
    for steps, n, valid, grid, parts in field_shapes:
        if parts > 1:  # the mesh shards field_ave's grid alone
            continue
        args = field_inputs(steps, n, valid, parts)
        src, smask, tgt, tmask, rots = args
        c_n = rots.shape[0]
        rotated, _, _, ra = dot_operands(*args)
        qa = torch.cat([rotated, torch.ones_like(rotated[..., :1])], dim=-1)
        yard = chunked(lambda a, z: torch.matmul(qa[a:z], ra.T).amin(-1), c_n)
        for prec in ("highest", "default"):
            fk = field_dot(*args, prec)
            fp = field_dot_plain(*args, prec)
            torch.cuda.synchronize()
            label = f"field_dot {prec} C={c_n} P=T={n}"
            require(torch.allclose(fk, fp, rtol=2e-5, atol=0.0), f"{label}: differs beyond rtol 2e-5")
            require(torch.equal(fk, field_dot(*args, prec)), f"{label}: repeated runs differ")
            if valid is not None:  # masked rows skipped exactly: the padded clouds give their prefix's bits
                require(torch.equal(fk, field_dot(src[:valid], smask[:valid], tgt[:valid], tmask[:valid], rots, prec)),
                        f"{label}: the padded clouds' field differs from their valid prefix's")
            err = float((fk - fp).abs().max())
            plan = dot_plan(c_n, n, n, prec, sm_count(dev.index))
            ms = time_ms(lambda: field_dot(*args, prec), 10)
            device_ms = graph_ms(lambda: field_dot(*args, prec), 10)  # the one launch and its allocations
            plain_ms = time_ms(lambda: field_dot_plain(*args, prec), 3)
            yard_ms = time_ms(yard, 3)
            evals = c_n * int(smask.sum()) * int(tmask.sum())
            b = min((bound(f32 * evals, field_bytes(c_n, n), bf16 * evals) for f32, bf16 in dot_routes[prec]),
                    key=lambda x: x["bound_ms"])
            cases.append(dict({"shape": f"{c_n}x{n}x{n}", "label": grid, "precision": prec, "valid": valid,
                               "batch_pass": None, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                               "max_abs_err": err, "yardstick_ms": yard_ms, "plan": plan._asdict()}, **b))
            log(f"  {label} ({grid}): max|err| {err:.3g}; {ms:.4f} ms a wrapper call back to back, {device_ms:.4f} "
                f"ms on the device (graph replay); plain {plain_ms:.4f} ms, yardstick {yard_ms:.4f} ms, bound "
                f"{b['bound_ms']:.4f} ms ({b['bound_by']}; valid rows only); plan {tuple(plan)}")
    out["field_dot"] = dict(cases[0], cases=cases, yardstick="torch.matmul([Rq, 1], ra.T).amin(-1) in float32, 64 "
                            "rotations a call", source="kss_icp_torch/csrc/field_dot.cu",
                            replaces="kss_icp_tpu/ops/coarse_pallas.py:218",
                            tensor_instructions=dot_sass(), launched_kernels=dot_launches(torch, dev, field_inputs))
    out["field_trim"] = phase_field_trim(torch, dev, rng)
    out["field_trim"]["squared"] = phase_field_sq(torch, dev, rng)
    out["field_keys"] = phase_field_keys(torch, dev, rng)
    out["icp_update"] = phase_icp_update(torch, dev, rng)
    phase_plain_knobs(torch, dev)
    return out


def field_ave_case(torch, dev, args, label, valid, parts) -> dict:
    """One shape of field_ave (the culling kernel's "ave" statistic, after
    field_order's sort) against its plain version bit for bit, repeated runs
    and, for suffix masks, the valid prefix's bits; its share of (point,
    row) pairs scanned (the kernel's counter), the wrapper's times (back to
    back, and by graph replay on the device: field_order and the launch),
    the plain version's and the yardstick's, `bound_ms` on the pairs
    scanned and the box tests made and `bruteforce_bound_ms` on every pair."""
    from kss_icp_torch.ops import coarse_cuda as cc
    from kss_icp_torch.timing import graph_ms, time_ms

    src, smask, tgt, tmask, rots = args
    c_n, n = rots.shape[0], src.shape[0]
    counter = torch.zeros(2, dtype=torch.int64, device=dev)
    fk, fp = cc.field_ave(*args, scanned=counter), cc.field_ave_plain(*args)
    torch.cuda.synchronize()
    name = f"field_ave C={c_n} P=T={n}"
    require(torch.equal(fk, fp), f"{name} ({label}): differs from the plain version's bits at "
                                 f"{int((fk != fp).sum())} of {c_n}")
    require(torch.equal(fk, cc.field_ave(*args)), f"{name}: repeated runs differ")
    if valid is not None:
        require(torch.equal(fk, cc.field_ave(src[:valid], smask[:valid], tgt[:valid], tmask[:valid], rots)),
                f"{name}: the padded clouds' field differs from their valid prefix's")
    ns, m = int(smask.sum()), int(tmask.sum())
    pairs = c_n * ns * m
    scanned, tests = (int(x) for x in counter.tolist())
    share = scanned / pairs
    require(0 < share <= 1, f"{name}: {scanned} pairs scanned of {pairs}")
    ms = time_ms(lambda: cc.field_ave(*args), 10)
    device_ms = graph_ms(lambda: cc.field_ave(*args), 10)  # field_order's sort and the launch
    plain_ms = time_ms(lambda: cc.field_ave_plain(*args), 3)
    rotated, valid_tgt = cc.rotate_sources(rots, src), tgt[tmask]
    yard_ms = time_ms(lambda: [torch.cdist(rotated[a:a + 64], valid_tgt[None]).amin(-1) for a in range(0, c_n, 64)],
                      3)
    nbytes = 4 * (n * 3 * 2 + c_n * 9 + c_n) + 2 * n + 8 * 2 * n
    b = bound(9.0 * scanned + BOX_TEST_OPS * tests, nbytes)
    brute = bound(9.0 * pairs, nbytes)["bound_ms"]
    log(f"  {name} ({label}): the plain version's bits; {share:.4f} of {pairs} pairs scanned, {tests} box tests; "
        f"{ms:.4f} ms a wrapper call back to back, {device_ms:.4f} ms on the device (graph replay; field_order "
        f"included), plain {plain_ms:.4f} ms, cdist+min {yard_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']}; the pairs scanned and the box tests), {brute:.4f} ms on every pair")
    return dict({"shape": f"{c_n}x{n}x{n}", "label": label, "precision": None, "valid": valid,
                 "batch_pass": "mesh" if parts > 1 else None, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                 "max_abs_err": 0.0, "yardstick_ms": yard_ms, "pairs": pairs, "scanned_pairs": scanned,
                 "scanned_share": share, "box_tests": tests, "bruteforce_bound_ms": brute}, **b)


def dot_sass() -> dict:
    """{field_dot kernel instantiation: its HMMA instructions} from the built
    library's SASS (cuobjdump beside nvcc); both must run on the tensor cores."""
    from kss_icp_torch import _build

    path, _, _ = _build.build()
    sass = subprocess.run([str(Path(_build.find_nvcc()).parent / "cuobjdump"), "-sass", str(path)],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    counts = {}
    for func in sass.split("Function : ")[1:]:
        name = func.split()[0]
        if "field_dot_kernel" in name:
            counts["default" if "ILi1EE" in name else "highest"] = len(re.findall(r"\bHMMA\.", func))
    log(f"  field_dot SASS, HMMA instructions: {counts}")
    require(len(counts) == 2 and all(counts.values()), f"field_dot does not run on the tensor cores: {counts}")
    return counts


def dot_launches(torch, dev, field_inputs) -> dict:
    """{precision: the kernel nodes of a CUDA graph captured around one
    field_dot call}, by the graph's DOT dump (cudaGraphDebugDotPrint, which
    names each node's type and a kernel node's function): the kernel alone,
    no rotation or operand pass, at both precisions."""
    import tempfile
    import warnings

    from kss_icp_torch.ops.coarse_cuda import field_dot

    args = field_inputs(8, 2048, 1534)
    found = {}
    for prec in ("highest", "default"):
        field_dot(*args, prec)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph(keep_graph=True)  # the captured graph stays for the dump
        g.enable_debug_mode()
        with torch.cuda.graph(g, capture_error_mode="relaxed"):
            field_dot(*args, prec)
        torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp, warnings.catch_warnings():
            warnings.simplefilter("ignore")  # debug_dump warns that it runs
            path = Path(tmp, "graph.dot")
            g.debug_dump(str(path))
            require(path.exists(), f"field_dot {prec}: the captured graph gave no DOT dump")
            dot = path.read_text()
        nodes = re.findall(r'label="\{(\w+)\s*\n\| \{ID \| [^|]*\| ([^<}\\]*)', dot)
        found[prec] = [name.strip() for kind, name in nodes if kind == "KERNEL"]
        log(f"  field_dot {prec}: the captured graph's nodes {[kind for kind, _ in nodes]}, kernels {found[prec]}")
        require(len(found[prec]) == 1 and "field_dot_kernel" in found[prec][0],
                f"field_dot {prec}: the captured call's kernels are {found[prec]}, not field_dot_kernel alone")
        g.reset()
    return found


def cull_case(torch, dev, name, stat, args, plain, probe_plain, label) -> dict:
    """One shape of the field_trim kernel (`stat` "trim", "max" or "diff")
    against its plain versions, bit for bit: the probe mode's per-point
    values and the fused field. Then the share of (point, row) pairs the
    kernel scanned (its counter), the wrapper's times (back to back, and by
    graph replay on the device), the kernel's alone on a precomputed order,
    the preparation's, the plain version's and the yardstick's, and the
    bounds (inputs and output once): `bound_ms` on the work this run's
    data needed of the design, the scanned pairs (9 operations each) and
    the box tests (BOX_TEST_OPS each), both from the kernel's counter;
    `bruteforce_bound_ms` on every (rotation, valid point, valid row)
    pair."""
    from kss_icp_torch.ops import coarse_cuda as cc
    from kss_icp_torch.timing import graph_ms, time_ms

    src, smask, tgt, tmask, rots = args
    c_n, p_n, t_n = rots.shape[0], src.shape[0], tgt.shape[0]
    kernel = (lambda *a, **k: cc.field_trim(*a, 0.7, **k)) if stat == "trim" else \
        (lambda *a, **k: cc.field_sq(*a, stat, **k))
    probe = cc.field_trim_distances if stat == "trim" else cc.field_sq_distances
    dk, dp = probe(*args), probe_plain(cc.rotate_sources(rots, src), smask, tgt, tmask)
    counter = torch.zeros(2, dtype=torch.int64, device=dev)
    fk, fp = kernel(*args, scanned=counter), plain(*args)
    torch.cuda.synchronize()
    require(torch.equal(dk, dp), f"{name} {label}: the probe mode's values differ from the plain version's bits at "
                                 f"{int((dk != dp).sum())} of {dk.numel()}")
    require(torch.equal(fk, fp), f"{name} {label}: the {stat} field differs from the plain version's bits")
    require(torch.equal(fk, kernel(*args)), f"{name} {label}: repeated runs differ")
    ns, m = int(smask.sum()), int(tmask.sum())
    pairs = c_n * ns * (m or t_n)
    scanned, tests = (int(x) for x in counter.tolist())
    share = scanned / pairs
    require(0 < share <= 1, f"{name} {label}: {scanned} pairs scanned of {pairs}")
    order = cc.field_order(src, smask, tgt, tmask)
    out = torch.empty((c_n,), dtype=torch.float32, device=dev)
    rots = rots.contiguous()

    def kernel_alone():
        cc._cull_launch(name, stat, src, smask, tgt, tmask, order, rots, out)

    ms = time_ms(lambda: kernel(*args), 10)
    device_ms = graph_ms(lambda: kernel(*args), 10)  # field_order's sort and the kernel
    kernel_ms = graph_ms(kernel_alone, 10)
    prep_ms = graph_ms(lambda: cc.field_order(src, smask, tgt, tmask), 10)
    plain_ms = time_ms(lambda: plain(*args), 2)
    rotated = cc.rotate_sources(rots, src)
    valid_tgt = tgt[tmask] if m else tgt
    step = min(64, max(1, (1 << 31) // (p_n * len(valid_tgt))))  # 64 rotations a call, fewer on wide clouds
    yard_ms = time_ms(lambda: [torch.cdist(rotated[a:a + step], valid_tgt[None]).amin(-1)
                               for a in range(0, c_n, step)], 3)
    nbytes = 4 * (p_n * 3 + t_n * 3 + c_n * 9 + c_n) + p_n + t_n + 8 * (p_n + t_n)
    b = bound(9.0 * scanned + BOX_TEST_OPS * tests, nbytes)
    brute = bound(9.0 * pairs, nbytes)["bound_ms"]
    err = float((fk - fp).abs().max())
    case = dict({"shape": f"{c_n}x{p_n}x{t_n}", "label": label, "ms": ms, "device_ms": device_ms,
                 "kernel_device_ms": kernel_ms, "prep_device_ms": prep_ms, "plain_ms": plain_ms, "max_abs_err": err,
                 "yardstick_ms": yard_ms, "pairs": pairs, "scanned_pairs": scanned, "scanned_share": share,
                 "box_tests": tests, "bruteforce_bound_ms": brute, "cap": cc.field_cull_plan(p_n, t_n, stat)}, **b)
    log(f"  {name} {stat} C={c_n} P={p_n} T={t_n} ({label}): probe values and field identical; {share:.4f} of "
        f"{pairs} pairs scanned, {tests} box tests; {ms:.4f} ms a wrapper call back to back, {device_ms:.4f} ms on "
        f"the device (graph replay; the kernel alone {kernel_ms:.4f} ms, field_order {prep_ms:.4f} ms), plain "
        f"{plain_ms:.4f} ms, cdist+min {yard_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}; the pairs "
        f"scanned and the box tests), {brute:.4f} ms on every pair")
    return case


def phase_field_keys(torch, dev, rng) -> dict:
    """The keys kernel of field_order (the sort keys of the field_trim
    kernel's preparation) against its plain version, bit for bit, at the
    fields' shapes: both clouds at 2048 and at 512 rows, and a target of
    4173 rows."""
    from kss_icp_torch.ops.coarse_cuda import field_keys, field_keys_plain
    from kss_icp_torch.timing import graph_ms, time_ms

    cases = []
    for p_n, t_n in ((2048, 2048), (512, 512), (2048, 4173)):
        src, smask, tgt, tmask, _ = field_case_inputs(torch, dev, rng, 2, max(p_n, t_n), "inliers", "inliers")
        src, smask, tgt, tmask = src[:p_n], smask[:p_n], tgt[:t_n], tmask[:t_n]
        args = (src.contiguous(), smask.contiguous(), tgt.contiguous(), tmask.contiguous())
        got, want = field_keys(*args), field_keys_plain(*args)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"field_keys {p_n}+{t_n}: keys differ from the plain version's at "
                                        f"{int((got != want).sum())} of {got.numel()}")
        ms, device_ms = time_ms(lambda: field_keys(*args), 20), graph_ms(lambda: field_keys(*args), 20)
        plain_ms = time_ms(lambda: field_keys_plain(*args), 20)
        b = bound(0.0, (p_n + t_n) * (12 + 1 + 4))  # rows and masks read once, keys written once
        cases.append(dict({"shape": f"{p_n}+{t_n}", "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                           "max_abs_err": 0.0}, **b))
        log(f"  field_keys P={p_n} T={t_n}: keys identical; {ms:.4f} ms a wrapper call back to back, {device_ms:.4f} "
            f"ms on the device (graph replay), plain {plain_ms:.4f} ms, bound {b['bound_ms']:.5f} ms ({b['bound_by']})")
    return dict(cases[0], cases=cases, source="kss_icp_torch/csrc/field_trim.cu (kss_field_keys)",
                replaces="none: the sort keys of field_trim's preparation (no TPU counterpart)")


# The lockstep ICP step's update (csrc/icp_step.cu) at the cells' step shapes:
# (lanes, points a lane, target clouds, trimmed with scale, label).
ICP_UPDATE_CASES = ((2048, 512, 64, False, "remesh batch screen: 64 pairs x 32 lanes"),
                    (256, 2048, 64, False, "remesh batch refine: 64 pairs x 4 lanes"),
                    (8192, 512, 16, True, "overlap screen: 16 pairs x 512 lanes, trimmed with scale"),
                    (1, 2000, 1, False, "one lane of 2000 points"))
# Bytes a point: mask 1, d2 4, idx 4, cur 12 and its target row 12 read; the
# source 12 read and cur 12 written.
ICP_UPDATE_BYTES = 57


def phase_icp_update(torch, dev, rng) -> dict:
    """icp_update (the update of one lockstep ICP step) against
    icp_update_plain at the cells' step shapes, on lanes near their padded
    clouds with a tenth of them inactive: R and t within 2e-5, s and the MSE
    within rtol 2e-5, iterations equal, the stop flag the lanes'
    `active.any()`, each inactive lane's state and cur bit for bit. Then, with
    every lane kept active (gates that cannot hold), ms a wrapper call back to
    back, device ms (graph replay), the plain version's ms and the bound of
    the bytes, ICP_UPDATE_BYTES a point over HBM."""
    from kss_icp_torch.config import KSSICPConfig
    from kss_icp_torch.core.transforms import euler_xyz_matrix
    from kss_icp_torch.models.icp import ICPParams
    from kss_icp_torch.ops.icp_cuda import ICPState, icp_update, icp_update_plain, positions
    from kss_icp_torch.ops.nn import masked_quantile_threshold
    from kss_icp_torch.ops.nn_cuda import nn1
    from kss_icp_torch.timing import graph_ms, time_ms

    def copy(state):
        return ICPState(*(x.clone() for x in state))

    params = ICPParams.from_config(KSSICPConfig())._replace(max_iterations=6)
    busy = params._replace(max_iterations=2 ** 30, transformation_epsilon=-1.0, rotation_epsilon=-1.0,
                           euclidean_fitness_epsilon=-1.0)
    cases = []
    for lanes, n, groups, trimmed, label in ICP_UPDATE_CASES:
        t_n, valid = 2048, 2048 - 2048 // 40
        tgt = torch.as_tensor(np.stack([cloud(rng, t_n) for _ in range(groups)]), device=dev)
        tmask = torch.arange(t_n, device=dev)[None].expand(groups, t_n) < valid
        ref = torch.arange(groups, dtype=torch.int32, device=dev).repeat_interleave(lanes // groups)
        rows = torch.as_tensor(rng.integers(0, valid, size=(lanes, n)), device=dev)
        base = tgt[ref.long()[:, None], rows] + torch.as_tensor(rng.normal(0, 0.005, (lanes, n, 3)), device=dev).float()
        if trimmed:
            base[:, : n // 10] += 0.3
        turn = euler_xyz_matrix(torch.as_tensor(rng.uniform(-0.2, 0.2, (lanes, 3)), device=dev).float())
        source = torch.einsum("lij,lnj->lni", turn, base).contiguous()
        smask = torch.ones((lanes, n), dtype=torch.bool, device=dev)
        smask[::3, n - n // 20:] = False
        active = torch.as_tensor(rng.uniform(size=lanes) > 0.1, device=dev)
        active[0] = True
        state = ICPState(torch.eye(3, device=dev).expand(lanes, 3, 3).clone(), torch.zeros((lanes, 3), device=dev),
                         torch.ones(lanes, device=dev), torch.full((lanes,), 1e30, device=dev),
                         torch.ones(lanes, dtype=torch.int32, device=dev), ~active, active)
        cur = positions(source, *state[:3])
        d2, idx = nn1(cur, tgt, tmask.contiguous(), ref)
        thr = masked_quantile_threshold(d2, smask, 0.7) if trimmed else None
        args = dict(d2=d2, idx=idx, source=source, source_mask=smask, target=tgt, lane_ref=ref, threshold=thr,
                    estimate_scale=trimmed)
        want, _, want_flag = icp_update_plain(cur.clone(), state=copy(state), params=params, **args)
        stop = torch.zeros(2, dtype=torch.int32, device=dev)
        got, got_cur, flag = icp_update(cur.clone(), state=copy(state), params=params, stop=stop, step=0, **args)
        torch.cuda.synchronize()
        err = {"rotation": float((got.rotation - want.rotation).abs().max()),
               "translation": float((got.translation - want.translation).abs().max()),
               "scale_rel": float(((got.scale - want.scale) / want.scale).abs().max()),
               "mse_rel": float(((got.corr_mse - want.corr_mse) / want.corr_mse).abs().max())}
        require(max(err.values()) <= 2e-5, f"icp_update {label}: off the plain version beyond 2e-5: {err}")
        require(torch.equal(got.iteration, want.iteration) and int(flag) == int(bool(want_flag)),
                f"icp_update {label}: iterations or the stop flag differ from the plain version's")
        frozen = ~active
        require(all(torch.equal(x[frozen], y[frozen]) for x, y in zip(got, state))
                and torch.equal(got_cur[frozen], cur[frozen]), f"icp_update {label}: an inactive lane moved")
        live = ICPState(*(x.clone() for x in state[:5]), torch.zeros_like(active), torch.ones_like(active))
        work = cur.clone()
        ms = time_ms(lambda: icp_update(work, state=live, params=busy, stop=stop, step=0, **args), 20)
        device_ms = graph_ms(lambda: icp_update(work, state=live, params=busy, stop=stop, step=0, **args), 20)
        plain_ms = time_ms(lambda: icp_update_plain(work, state=live, params=busy, **args), 5)
        b = bound(0.0, lanes * n * ICP_UPDATE_BYTES)
        cases.append(dict({"shape": f"{lanes}x{n} G={groups}" + (" trimmed, scaled" if trimmed else ""),
                           "label": label, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                           "max_abs_err": max(err["rotation"], err["translation"]), "errors": err}, **b))
        log(f"  icp_update {lanes}x{n} G={groups}{' trimmed, scaled' if trimmed else ''} ({label}): {err}; "
            f"{ms:.4f} ms a wrapper call back to back, {device_ms:.4f} ms on the device (graph replay), plain "
            f"{plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}, {ICP_UPDATE_BYTES} B a point)")
    return dict(cases[0], cases=cases, source="kss_icp_torch/csrc/icp_step.cu (kss_icp_update)",
                replaces="none: JAX's lockstep step is XLA (kss_icp_tpu/models/icp.py:191-300); the port's eager "
                         "step, icp_update_plain")


def field_case_inputs(torch, dev, rng, steps, n, s_kind, t_kind):
    """(source, source mask, target, target mask, rotations) of a field shape:
    masks "inliers" (~70% scattered in the first n - n // 20 rows), "padded"
    (the first n - n // 20 rows) or "none"."""
    from kss_icp_torch.core.transforms import euler_xyz_matrix
    from kss_icp_torch.models.coarse import rotation_grid

    def t(x):
        return torch.as_tensor(x, device=dev)

    src, tgt = t(cloud(rng, n)), t(cloud(rng, n))
    rows = torch.arange(n, device=dev)
    masks = {"inliers": lambda: (rows < n - n // 20) & t(rng.uniform(size=n) < 0.7),
             "padded": lambda: rows < n - n // 20, "none": lambda: torch.zeros(n, dtype=torch.bool, device=dev)}
    smask, tmask = masks[s_kind](), masks[t_kind]()
    return src, smask, tgt, tmask, euler_xyz_matrix(rotation_grid(steps, 6.3, dev))


def phase_field_sq(torch, dev, rng) -> dict:
    """field_sq (the "max" and "diff" fields of the field_trim kernel)
    against its plain versions, bit for bit, at the 8^3 and 16^3 grids'
    padded clouds with ~70% scattered masks, the 16^3 grid's 512-point
    prefixes, a fully masked target (the biased path), and 8 rotations of
    a 40000-point source against a 20000-row target (~70% masks): past
    FIELD_MAX_POINTS, the mins in a device scratch and the target in two
    chunks."""
    from kss_icp_torch.ops import coarse_cuda as cc
    from kss_icp_torch.ops.coarse_cuda import FIELD_MAX_POINTS, SQ_PLAIN
    from kss_icp_torch.ops.nn import nn_sqdistances

    cases = []
    for steps, n, s_kind, t_kind, label in ((8, 2048, "inliers", "inliers", "8^3 field, ~70% scattered masks"),
                                            (16, 2048, "inliers", "inliers", "16^3 field, ~70% scattered masks"),
                                            (16, 512, "inliers", "padded", "16^3 field at 512-point prefixes"),
                                            (8, 2048, "inliers", "none", "8^3, target fully masked"),
                                            (2, 40000, "inliers", "inliers", "a source past shared memory")):
        args = field_case_inputs(torch, dev, rng, steps, n, s_kind, t_kind)
        if n > FIELD_MAX_POINTS:
            src, smask, tgt, tmask, rots = args
            args = (src, smask, tgt[:n // 2].contiguous(), tmask[:n // 2].contiguous(), rots)
            require(cc.field_cull_plan(n, n // 2, "max") < int(tmask[:n // 2].sum()),
                    "field_sq: the wide case's target fits one chunk")
        for metric in ("max", "diff"):
            cases.append(dict(cull_case(torch, dev, "field_sq", metric, args, SQ_PLAIN[metric], nn_sqdistances,
                                        label), metric=metric))
    return dict(cases[0], cases=cases, source="kss_icp_torch/csrc/field_trim.cu (kss_field_cull, max and diff)",
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
    """field_trim's probe values and fused trimmed field against the plain
    version, bit for bit, at the overlap rungs' full-resolution shapes."""
    from kss_icp_torch.ops.coarse_cuda import field_trim_plain
    from kss_icp_torch.ops.nn import nn_distances

    cases = []
    # (grid steps, source mask, target mask, label): ~70% scattered inliers on
    # both clouds, as the overlap re-solves' masks are; a fully masked target.
    for steps, s_kind, t_kind, label in ((8, "inliers", "inliers", "8^3 overlap field, inlier masks"),
                                          (16, "inliers", "inliers", "16^3 overlap field, inlier masks"),
                                          (16, "padded", "padded", "16^3 overlap field"),
                                          (8, "padded", "none", "8^3, target fully masked")):
        args = field_case_inputs(torch, dev, rng, steps, 2048, s_kind, t_kind)
        cases.append(cull_case(torch, dev, "field_trim", "trim", args, field_trim_plain, nn_distances, label))
    return dict(cases[0], cases=cases, source="kss_icp_torch/csrc/field_trim.cu (kss_field_cull, trim)",
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
    """The remesh 25, [(name, source, target)], from the committed fixtures
    (kss_icp_torch.stress.remesh_corpus)."""
    from kss_icp_torch.stress import remesh_corpus

    return [(name, src, tgt) for name, src, tgt, _ in remesh_corpus()]


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
    """nn1's launches since its counts were zeroed, by shape_key: logged, and
    returned; and by plan (queries a thread, cluster), logged."""
    shapes = sorted(nn1.launch_shapes.items(), key=lambda kv: -kv[1])
    log(f"  [{label}] nn1 launches by shape (L x Q x R, G reference clouds): " +
        ", ".join(f"{shape_key(*k)} {n}" for k, n in shapes))
    log(f"  [{label}] nn1 launches by plan (queries a thread, cluster): " +
        ", ".join(f"{k} {n}" for k, n in sorted(nn1.plan_launches.items())))
    return {shape_key(*k): n for k, n in shapes}


def field_grids(counters, label: str) -> dict:
    """field_trim's and field_sq's launches since their counts were zeroed,
    by rotations (512 the 8³ grid, 4096 the 16³): logged, and returned."""
    grids = {k: {str(c): n for c, n in sorted(counters[k].launch_grids.items())}
             for k in ("field_trim", "field_sq") if k in counters}
    if any(grids.values()):
        log(f"  [{label}] field launches by rotations: {grids}")
    return grids


def zero_counts(counters) -> None:
    """Every kernel's launch count, and nn1's and the fields' histograms, to 0."""
    for fn in counters.values():
        fn.launches = 0
        for hist in ("launch_shapes", "plan_launches", "launch_grids"):
            if hasattr(fn, hist):
                getattr(fn, hist).clear()


def drive(torch, dev, cfg, pairs, counters, timer, label, judge, rung_log=None):
    """One pass of `pairs` through register_pair -> apply_similarity ->
    registration_measure, the launch counts zeroed just before it. Returns
    (rows, seconds, launches); judge(name, src, metrics, aligned) -> row.
    With a RungLog, each row carries the overlap rungs of its pair."""
    import kss_icp_torch as kt

    rows, total = [], 0.0
    zero_counts(counters)
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
    launches["field_grids"] = field_grids(counters, label)
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
    require(launches.get("icp_update", 1) > 0, f"{label}: icp_update never launched: {launches}")
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
    from kss_icp_torch.ops.icp_cuda import icp_update
    from kss_icp_torch.ops.nn_cuda import nn1
    from kss_icp_torch.ops.resample_cuda import fps

    counters = {"nn1": nn1, "fps": fps, "field_ave": field_ave, "field_dot": field_dot, "field_trim": field_trim,
                "icp_update": icp_update}
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

    for name in ("nn1", "fps", "field_ave", "icp_update"):
        kernels[name]["launches"] = out["passes"]["esc-default"]["launches"][name]
    kernels["nn1"]["launch_shapes"] = out["passes"]["esc-default"]["launches"]["nn1_shapes"]
    kernels["field_dot"]["launches"] = out["passes"]["esc-dot"]["launches"]["field_dot"]
    return out


def phase_default_config(torch, dev, kernels: dict, e2e: dict) -> None:
    """4d: the unmodified DEFAULT_CONFIG, the overlap tier on, against
    fixtures/torch_port_expected_overlap.json."""
    from kss_icp_torch.challenge import BOARDS, transform_rmse
    from kss_icp_torch.config import DEFAULT_CONFIG as cfg
    from kss_icp_torch.ops.coarse_cuda import field_ave, field_dot, field_keys, field_trim
    from kss_icp_torch.ops.nn_cuda import nn1
    from kss_icp_torch.ops.resample_cuda import fps

    counters = {"nn1": nn1, "fps": fps, "field_ave": field_ave, "field_dot": field_dot, "field_trim": field_trim,
                "field_keys": field_keys}
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
    require(launches["field_keys"] == launches["field_trim"] + launches["field_ave"],
            f"shipped boards: {launches['field_keys']} field_keys launches for {launches['field_trim']} trimmed "
            f"and {launches['field_ave']} ave fields")
    kernels["field_keys"]["launches"] = launches["field_keys"]


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

    zero_counts(counters)
    with LadderLog(escalate, len(pairs)) as ladder:
        t0 = time.perf_counter()
        res, metrics = kt.register_many([(a, b) for _, a, b in pairs], cfg, full_pad=BATCH_PAD, device=dev,
                                        timer=timer)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"  [{label}] kernel launches: {launches}")
    launches["nn1_shapes"] = nn1_histogram(counters["nn1"], label)
    launches["field_grids"] = field_grids(counters, label)
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
    pass's histogram) gains the shapes that only 4f (the large-scan metric),
    4k (the VCM owners, the Voronoi labels) and 4l (the ranks' rows) launch,
    fps's lists its cases' launches, and field_ave's mesh case takes the
    ranks' launches of the sharded field."""
    for name in ("nn1", "fps"):
        for case in kernels[name]["cases"]:
            if case["batch_pass"]:
                launches = e2e["passes"][case["batch_pass"]]["launches"]
                case["launches"] = launches["nn1_shapes"].get(case["shape"], 0) if name == "nn1" else launches["fps"]
    kernels["nn1"]["launch_shapes"] = dict(kernels["nn1"]["launch_shapes"], **{
        case["shape"]: e2e["passes"][case["batch_pass"]]["launches"]["nn1_shapes"].get(case["shape"], 0)
        for case in kernels["nn1"]["cases"] if case["batch_pass"] in ("largescan", "vcm", "voronoi", "mesh")})
    for case in kernels["field_ave"]["cases"]:
        if case.get("batch_pass") == "mesh":
            case["launches"] = e2e["passes"]["mesh"]["field_launches"]
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
        nn1.plan_launches.clear()
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
        counters["nn1"].plan_launches.clear()
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
        missing = [k for k in ("nn1_kernel", "fps_kernel", "field_cull_kernel")
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
        nn1.plan_launches.clear()
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


# Phase 4l: the device mesh (kss_icp_torch/parallel on torch.distributed).
MESH_WORLD = 4  # gloo ranks sharing cuda:0
MESH_STEPS = 16  # the sharded field's grid: 4096 rotations, 1024 a rank
MESH_ICP_POINTS = 2048
MESH_TIMEOUT = 120.0  # seconds a collective may wait before its group fails
MESH_DEADLINE = 420.0  # seconds a world may take, spawn to its last result
# __graft_entry__.py:140-146: every pair escalated and offered every overlap rung.
FORCED_LADDER = dict(escalate_threshold=0.0, overlap_threshold=0.0, overlap_gate_ratio=100.0,
                     escalate_rotation_steps=8)
# A batch's pose against another batch's on the card: the widest gap ROADMAP
# queue 3 records for batch rounding ("A batch's answers are not one pair's
# bits": 2.4e-3 on the remesh 25, 1.75e-2 on the boards).
BATCH_POSE_BAND = 1.75e-2


def mesh_inputs(torch, dev) -> dict:
    """Phase 4l's inputs, made alike in the parent and in every rank: the
    largest remesh pair's resampled clouds, the source moved onto its
    pre-shape (the field); a noisy copy of a 2048-point cloud (point-sharded
    ICP); Room seed 0's full-resolution clouds, the source moved by JAX's
    recorded transform (the metric, 200704 x 200704); the remesh 25
    (register_many)."""
    from kss_icp_torch import largescan
    from kss_icp_torch.config import DEFAULT_CONFIG as cfg
    from kss_icp_torch.core.preshape import middle_align
    from kss_icp_torch.core.transforms import Similarity, apply_similarity
    from kss_icp_torch.models.kss_icp import resample_batch

    pairs = load_pairs()
    name, src, tgt = max(pairs, key=lambda r: cfg.resample_count(len(r[1]), len(r[2])))
    pn = torch.tensor([cfg.resample_count(len(src), len(tgt))], device=dev)
    (sp, sm), (tp, tm) = (resample_batch(torch.as_tensor(c, device=dev)[None],
                                         torch.ones((1, len(c)), dtype=torch.bool, device=dev), pn, cfg)
                          for c in (src, tgt))
    sim0, _, _ = middle_align(sp[0], sm[0], tp[0], tm[0])
    field = (apply_similarity(sim0, sp[0]).contiguous(), sm[0], tp[0].contiguous(), tm[0].contiguous())

    rng = np.random.default_rng(13)
    target = cloud(rng, MESH_ICP_POINTS)
    c, s = np.cos(0.35), np.sin(0.35)
    moved = (target @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32).T + np.float32([0.05, -0.02, 0.01])
             + rng.normal(0, 0.005, target.shape)).astype(np.float32)
    ones = torch.ones((MESH_ICP_POINTS,), dtype=torch.bool, device=dev)
    icp_pair = (torch.as_tensor(moved, device=dev), ones, torch.as_tensor(target, device=dev), ones)

    record = load_largescan()
    rec = next(r for r in record["seeds"] if r["seed"] == 0)
    scan = largescan.normalized_pair(record["n_points"], 0, dev)
    transform = Similarity(*(torch.tensor(rec[k], dtype=torch.float32, device=dev)
                             for k in ("scale", "rotation", "translation")))
    metric = (apply_similarity(transform, scan.source[0]).contiguous(), scan.source[1], scan.target[0], scan.target[1])
    return {"field_pair": name, "field": field, "icp": icp_pair, "metric": metric, "pairs": pairs}


def mesh_many(torch, dev, cfg, pairs, timer=None, mesh=None, ladder_n=None):
    """register_many over `pairs` [(name, src, tgt)], with a mesh or
    without, its ladder recorded (over ladder_n rows: a rank's padded slice);
    returns (result, metrics, ladder rows, seconds to a sync)."""
    from kss_icp_torch import escalate
    from kss_icp_torch.ladder_log import LadderLog
    from kss_icp_torch.parallel import register_many

    with LadderLog(escalate, ladder_n or len(pairs)) as ladder:
        t0 = time.perf_counter()
        res, metrics = register_many([(a, b) for _, a, b in pairs], cfg, mesh=mesh, full_pad=BATCH_PAD, device=dev,
                                     timer=timer)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    rows = {"escalated": ladder.escalated.tolist(), "won": ladder.won.tolist(), "finisher": ladder.finisher.tolist(),
            "rungs": [[(r["rung"], r["ran"], r["adopted"]) for r in rows] for rows in ladder.rungs]}
    return res, metrics, rows, seconds


def many_answer(res, metrics, rows) -> dict:
    """What the gates read of a register_many call, as numpy."""
    return dict(rows, rmse=np.asarray(metrics["rmse"]), transform=[x.cpu().numpy() for x in res.transform],
                fitness=res.fitness.cpu().numpy())


def mesh_rank(rank: int, world: int, store: str, backend: str, device: str, full: bool, queue) -> None:
    """One rank of phase 4l, in a process of its own (spawned): joins the
    group through the FileStore `store`, drives the mesh entry points on the
    phase's inputs and puts (rank, traceback or None, outputs) on `queue`.
    A failure is put on the queue and raised, so the process exits
    non-zero."""
    import traceback

    import torch

    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        out = mesh_rank_run(torch, rank, world, store, backend, dev, full)
    except BaseException:
        queue.put((rank, traceback.format_exc(), None))
        raise
    queue.put((rank, None, out))


def mesh_rank_run(torch, rank, world, store, backend, dev, full: bool) -> dict:
    import torch.distributed as dist

    from kss_icp_torch.config import DEFAULT_CONFIG
    from kss_icp_torch.models.icp import ICPParams
    from kss_icp_torch.ops.coarse_cuda import field_ave, field_dot, field_trim
    from kss_icp_torch.ops.nn_cuda import nn1
    from kss_icp_torch.ops.resample_cuda import fps
    from kss_icp_torch.parallel import (distributed_init, icp_point_sharded, make_mesh, mean_nn_distance_sharded,
                                        score_rotation_field_sharded)
    from kss_icp_torch.parallel.mesh import all_gather_rows

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))  # the ranks share the host's cores
    distributed_init(f"file://{store}", world, rank, backend, timeout=MESH_TIMEOUT)
    meshes = {name: make_mesh((name,), device_type=dev.type) for name in ("rot", "points", "pairs")}
    inputs = mesh_inputs(torch, dev)
    pairs, per = inputs["pairs"], -(-len(inputs["pairs"]) // world)
    counters = {"nn1": nn1, "fps": fps, "field_ave": field_ave, "field_dot": field_dot, "field_trim": field_trim}
    out, seconds = {}, {}

    def timed(label, fn):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t0
        return result

    for fn in counters.values():
        fn.launches = 0
    nn1.launch_shapes.clear()
    nn1.plan_launches.clear()
    all_gather_rows.collectives = 0
    # The first register_many is also the rank's warm-up: the dot field's, or the gated default call.
    if full:
        out["dot"] = many_answer(*mesh_many(torch, dev, dataclasses.replace(DEFAULT_CONFIG, coarse_method="dot"),
                                            pairs, mesh=meshes["pairs"], ladder_n=per)[:3])
    else:
        *answer, s = mesh_many(torch, dev, DEFAULT_CONFIG, pairs, mesh=meshes["pairs"], ladder_n=per)
        out["many"], seconds["many"] = many_answer(*answer), [s]
    before = field_ave.launches
    field = timed("field", lambda: score_rotation_field_sharded(*inputs["field"], steps=MESH_STEPS,
                                                               mesh=meshes["rot"]))
    out["field"], out["field_launches"] = field.cpu().numpy(), field_ave.launches - before
    res = timed("icp", lambda: icp_point_sharded(*inputs["icp"], ICPParams.from_config(DEFAULT_CONFIG),
                                                 mesh=meshes["points"]))
    out["icp"] = {k: v.cpu().numpy() for k, v in res._asdict().items()}
    out["metric"] = float(timed("metric", lambda: mean_nn_distance_sharded(*inputs["metric"],
                                                                           mesh=meshes["points"])))
    if full:
        turns = []
        for turn in range(2):
            dist.barrier()
            *answer, s = mesh_many(torch, dev, DEFAULT_CONFIG, pairs, mesh=meshes["pairs"], ladder_n=per)
            turns.append(s)
        out["many"], seconds["many"] = many_answer(*answer), turns
        timer = StageTimer(torch, True)
        dist.barrier()
        mesh_many(torch, dev, DEFAULT_CONFIG, pairs, timer=timer, mesh=meshes["pairs"], ladder_n=per)
        out["stage_seconds"], out["stage_iterations"] = dict(timer.seconds), dict(timer.iterations)
        forced = dataclasses.replace(DEFAULT_CONFIG, **FORCED_LADDER)
        dist.barrier()
        *answer, seconds["forced"] = mesh_many(torch, dev, forced, pairs, mesh=meshes["pairs"], ladder_n=per)
        out["forced"] = many_answer(*answer)
    torch.cuda.synchronize()
    out["launches"] = {k: fn.launches for k, fn in counters.items()}
    out["collectives"] = all_gather_rows.collectives
    out["nn1_shapes"] = {shape_key(*k): n for k, n in nn1.launch_shapes.items()}
    # Each rank recorded the ladder of its own slice: gather the rows in rank order.
    for key in [k for k in ("dot", "many", "forced") if k in out]:
        parts = [None] * world
        dist.all_gather_object(parts, {f: out[key][f] for f in ("escalated", "won", "finisher", "rungs")},
                               group=meshes["pairs"].get_group("pairs"))
        out[key].update({f: [x for p in parts for x in p[f]][:len(pairs)] for f in parts[0]})
    out["seconds"] = seconds
    dist.destroy_process_group()
    return out


def run_mesh_world(world: int, backend: str, devices: list, full: bool, label: str) -> list:
    """Spawn `world` ranks of mesh_rank (spawn start method), rank r on
    devices[r] ("cuda:i"), rendezvoused through a FileStore in a temporary
    directory; wait for every rank's outputs, in rank order. Any rank that
    fails, dies or outlasts MESH_DEADLINE fails the phase; every process is
    stopped before this returns."""
    import queue as queue_mod
    import tempfile

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results, errors = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        q = ctx.Queue()
        procs = [ctx.Process(target=mesh_rank, args=(r, world, str(Path(tmp) / "store"), backend, devices[r], full, q))
                 for r in range(world)]
        t0 = time.perf_counter()
        try:
            for p in procs:
                p.start()
            while len(results) + len(errors) < world:
                try:
                    rank, err, out = q.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0) and r not in results]
                    if dead and not errors:
                        errors.append(f"rank(s) {dead} exited with {[procs[r].exitcode for r in dead]}")
                    if errors or time.perf_counter() - t0 > MESH_DEADLINE:
                        break
                    continue
                if err is not None:
                    errors.append(f"rank {rank}:\n{err}")
                    break
                results[rank] = out
            for p in procs:
                p.join(timeout=max(1.0, MESH_DEADLINE - (time.perf_counter() - t0)) if not errors else 5.0)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    require(not errors, f"4l {label}: " + "\n".join(errors))
    require(len(results) == world, f"4l {label}: {world - len(results)} rank(s) gave no result within "
                                   f"{MESH_DEADLINE:.0f} s")
    require(all(p.exitcode == 0 for p in procs), f"4l {label}: exit codes {[p.exitcode for p in procs]}")
    log(f"  [{label}] {world} rank(s) spawned, ran and joined in {time.perf_counter() - t0:.1f} s")
    return [results[r] for r in range(world)]


def check_mesh_world(label, outs: list, ref: dict, exp_rows: list, names: list, full: bool) -> dict:
    """Phase 4l's gates on one world's outputs against the unsharded
    answers `ref` (this process, the same card) and JAX's register_many
    record `exp_rows`; returns the gaps."""
    head = outs[0]
    for r, o in enumerate(outs[1:], 1):  # every rank returns the same global answer
        require(np.array_equal(o["field"], head["field"]) and o["metric"] == head["metric"]
                and all(np.array_equal(o["icp"][k], head["icp"][k]) for k in head["icp"])
                and np.array_equal(o["many"]["rmse"], head["many"]["rmse"]),
                f"4l {label}: rank {r}'s answers differ from rank 0's")
    gaps = {"field": float(np.abs(head["field"] - ref["field"]).max())}
    require(np.array_equal(head["field"], ref["field"]),
            f"4l {label}: the sharded {MESH_STEPS}³ field differs from the unsharded field (max|Δ| {gaps['field']:.3g})")
    icp, want = head["icp"], ref["icp"]
    gaps["icp_pose"] = max(float(np.abs(icp[k] - want[k]).max()) for k in ("rotation", "translation"))
    gaps["icp_fitness_rel"] = abs(float(icp["fitness"]) / float(want["fitness"]) - 1.0)
    gaps["icp_iterations"] = int(icp["iterations"]) - int(want["iterations"])
    require(gaps["icp_pose"] <= 1e-5 and gaps["icp_fitness_rel"] <= 1e-4 and abs(gaps["icp_iterations"]) <= 1,
            f"4l {label}: point-sharded ICP off the unsharded ICP: {gaps}")
    gaps["metric_rel"] = abs(head["metric"] / ref["metric"] - 1.0)
    require(gaps["metric_rel"] <= 1e-5, f"4l {label}: the sharded metric {head['metric']!r} off the unsharded "
                                        f"{ref['metric']!r} by {gaps['metric_rel']:.3g} (bar 1e-5)")
    many = head["many"]
    failures = [n for b, n in enumerate(names)
                if not (np.isfinite(many["rmse"][b]) and many["rmse"][b] <= exp_rows[b]["rmse"] + RMSE_BAND
                        and many["escalated"][b] == exp_rows[b]["escalated"])]
    gaps["many_rmse_vs_jax"] = float(np.max(many["rmse"] - np.array([r["rmse"] for r in exp_rows])))
    require(not failures, f"4l {label}: register_many over the pairs mesh: pairs outside JAX's RMSE + {RMSE_BAND} "
                          f"or escalated unlike JAX: {failures}")
    for key in ("many", "dot", "forced") if full else ("many",):
        got, want = head[key], ref[key]
        ran = [[(r[0], r[1]) for r in rows] for rows in got["rungs"]]
        pose = [max(float(np.abs(a[b] - c[b]).max()) for a, c in zip(got["transform"], want["transform"]))
                for b in range(len(names))]
        differ = [n for b, n in enumerate(names)
                  if got["escalated"][b] != want["escalated"][b] or ran[b] != [(r[0], r[1]) for r in want["rungs"][b]]
                  or not abs(got["rmse"][b] - want["rmse"][b]) <= RMSE_BAND or not pose[b] <= BATCH_POSE_BAND]
        gaps[f"{key}_rmse_vs_unsharded"] = float(np.abs(got["rmse"] - want["rmse"]).max())
        gaps[f"{key}_pose_vs_unsharded"] = max(pose)
        adopted = sum(g[2] != w[2] for rg, rw in zip(got["rungs"], want["rungs"]) for g, w in zip(rg, rw))
        apart = [f"{n} {pose[b]:.3g} (RMSE {got['rmse'][b] - want['rmse'][b]:+.3g})" for b, n in enumerate(names)
                 if pose[b] > 1e-5]
        log(f"  [{label}] {key}: escalated {sum(got['escalated'])} (unsharded {sum(want['escalated'])}), rungs run "
            f"{sum(r[1] for rows in got['rungs'] for r in rows)} (unsharded "
            f"{sum(r[1] for rows in want['rungs'] for r in rows)}), adoptions that differ {adopted}; max|ΔRMSE| "
            f"{gaps[f'{key}_rmse_vs_unsharded']:.3g}, pose max|Δ| {gaps[f'{key}_pose_vs_unsharded']:.3g}; pairs "
            f"whose pose parts from the unsharded batch's by more than 1e-5: {', '.join(apart) or 'none'}")
        require(not differ, f"4l {label}: register_many {key} over the pairs mesh unlike the unsharded batch "
                            f"(escalation, rungs run, RMSE beyond {RMSE_BAND} or pose beyond {BATCH_POSE_BAND}): "
                            f"{differ}")
    if full:
        require(all(r[1] for rows in head["forced"]["rungs"] for r in rows) and all(head["forced"]["escalated"])
                and all(len(rows) == 3 for rows in head["forced"]["rungs"]),
                f"4l {label}: the forced ladder left a pair unescalated or a rung not run")
    log(f"  [{label}] gaps: " + ", ".join(f"{k} {v:.3g}" if isinstance(v, float) else f"{k} {v}"
                                          for k, v in gaps.items()))
    return gaps


def mesh_launches(outs: list) -> tuple:
    """The ranks' launch counts and nn1 launch shapes, summed."""
    total, shapes = defaultdict(int), defaultdict(int)
    for o in outs:
        for k, v in o["launches"].items():
            total[k] += v
        for k, v in o["nn1_shapes"].items():
            shapes[k] += v
    return dict(total), dict(shapes)


def mesh_world(torch, dev, label: str, world: int, backend: str, devices: list, full: bool, ctx: dict) -> dict:
    """Run one world of phase 4l and gate it. With `full`, the unsharded
    register_many on this process's card is timed just before and just
    after the world (turns: unsharded, mesh, mesh, unsharded). Where
    ctx["held"] (phase 3's nn1 case shapes) is given, every nn1 shape the
    ranks launched must be among them."""
    from kss_icp_torch.config import DEFAULT_CONFIG

    pairs, card = ctx["pairs"], ctx["card"]
    if full:
        before = mesh_many(torch, dev, DEFAULT_CONFIG, pairs)[3]
    outs = run_mesh_world(world, backend, devices, full, label)
    gaps = check_mesh_world(label, outs, ctx["ref"], ctx["exp"], ctx["names"], full)
    launches, shapes = mesh_launches(outs)
    log(f"  [{label}] kernel launches, every rank's summed: {launches}; all_gather_rows collectives, summed: "
        f"{sum(o['collectives'] for o in outs)}")
    log(f"  [{label}] nn1 launches by shape, summed: " + ", ".join(f"{k} {v}" for k, v in
                                                                    sorted(shapes.items(), key=lambda kv: -kv[1])))
    if ctx["held"] is not None and world == MESH_WORLD:  # phase 3 holds the shapes of MESH_WORLD ranks
        unheld = sorted(set(shapes) - ctx["held"])
        require(not unheld, f"4l {label}: nn1 shapes the ranks launched that phase 3 never held against the plain "
                            f"version: {unheld}")
    out = {"launches": dict(launches, nn1_shapes=shapes), "gaps": gaps,
           "field_launches": sum(o["field_launches"] for o in outs),
           "seconds": {k: max(o["seconds"][k] for o in outs) for k in ("field", "icp", "metric")}}
    if not full:
        log(f"  [{label}] seconds, after the gated register_many: " +
            ", ".join(f"{k} {outs[0]['seconds'][k]:.4f}" for k in ("field", "icp", "metric")) + f" ({card})")
        return out
    require(all(launches[k] > 0 for k in ("nn1", "fps", "field_ave", "field_dot", "field_trim")),
            f"4l {label}: a kernel of the mesh path was never launched in the ranks: {launches}")
    after = mesh_many(torch, dev, DEFAULT_CONFIG, pairs)[3]
    mesh_s = [max(o["seconds"]["many"][i] for o in outs) for i in range(2)]
    shared = (f"{world} ranks share one card, so this measures the collectives' and processes' overhead, not scaling"
              if len(set(devices)) == 1 else f"one rank a card over {world} cards; the unsharded batch on {dev}")
    log(f"  [{label}] register_many on the remesh 25, pairs/s in turns (unsharded, mesh, mesh, unsharded): "
        f"{len(pairs) / before:.3f}, {len(pairs) / mesh_s[0]:.3f}, {len(pairs) / mesh_s[1]:.3f}, "
        f"{len(pairs) / after:.3f} (mesh: the slowest rank's call to a sync); {shared} ({card})")
    for key in ("field", "icp", "metric", "forced"):
        log(f"  [{label}] {key}: " + ", ".join(f"rank {r} {o['seconds'][key]:.4f} s" for r, o in enumerate(outs)) +
            f"; max {max(o['seconds'][key] for o in outs):.4f} s")
    stages = sorted({k for o in outs for k in o["stage_seconds"]})
    for r, o in enumerate(outs):
        log(f"  [{label}] rank {r} stage seconds (synced pass): " +
            ", ".join(f"{k} {o['stage_seconds'].get(k, 0.0):.4f}" for k in stages))
    log(f"  [{label}] stage seconds, max over ranks: " +
        ", ".join(f"{k} {max(o['stage_seconds'].get(k, 0.0) for o in outs):.4f}" for k in stages))
    return dict(out, pairs_per_s=[len(pairs) / s for s in mesh_s],
                unsharded_pairs_per_s=[len(pairs) / before, len(pairs) / after],
                stage_seconds_max={k: max(o["stage_seconds"].get(k, 0.0) for o in outs) for k in stages})


def phase_mesh(torch, dev, kernels, e2e: dict, card: str, cards_only: bool = False) -> None:
    """4l: the device mesh (kss_icp_torch/parallel) at DEFAULT_CONFIG and the
    main path's widths, 4 gloo ranks sharing this card, then an NCCL group of
    world size 1, then (with 2+ cards) NCCL over min(4, count) cards, each
    against the unsharded answers of this process on the same inputs.
    `kernels` is phase 3's record (None when phase 3 did not run): the
    ranks' nn1 shapes are checked against its cases, and it gains the
    ranks' launches. `cards_only` runs the NCCL world over the cards alone
    (two cards or more), against the same unsharded answers."""
    from kss_icp_torch.config import DEFAULT_CONFIG
    from kss_icp_torch.metrics import registration_measure_padded
    from kss_icp_torch.models.coarse import score_rotation_field
    from kss_icp_torch.models.icp import ICPParams, icp

    inputs = mesh_inputs(torch, dev)
    pairs, names = inputs["pairs"], [n for n, _, _ in inputs["pairs"]]
    exp = json.loads((FIXTURES / "torch_port_expected_batch.json").read_text())["pairs"]
    require([p["name"] for p in exp] == names, "the batch record's remesh pairs differ")
    log(f"  [mesh] inputs: the {MESH_STEPS}³ field on {inputs['field_pair']}'s resampled pre-shapes "
        f"({int(inputs['field'][1].sum())} of {inputs['field'][0].shape[0]} source rows valid); ICP on a noisy "
        f"{MESH_ICP_POINTS}-point copy; the metric on Room seed 0, {inputs['metric'][0].shape[0]} x "
        f"{inputs['metric'][2].shape[0]}; register_many on the remesh 25")
    ref = {"field": score_rotation_field(*inputs["field"], steps=MESH_STEPS).cpu().numpy()}
    src, smask, tgt, tmask = inputs["icp"]
    res = icp(src[None], smask[None], tgt, tmask, ICPParams.from_config(DEFAULT_CONFIG))
    ref["icp"] = {k: v[0].cpu().numpy() for k, v in res._asdict().items()}
    ref["metric"] = float(registration_measure_padded(*inputs["metric"])["mae"])
    ref["dot"] = many_answer(*mesh_many(torch, dev, dataclasses.replace(DEFAULT_CONFIG, coarse_method="dot"),
                                        pairs)[:3])
    ref["many"] = many_answer(*mesh_many(torch, dev, DEFAULT_CONFIG, pairs)[:3])
    ref["forced"] = many_answer(*mesh_many(torch, dev, dataclasses.replace(DEFAULT_CONFIG, **FORCED_LADDER),
                                           pairs)[:3])
    log(f"  [mesh] unsharded on this card: field, ICP ({int(ref['icp']['iterations'])} iterations, fitness "
        f"{float(ref['icp']['fitness']):.6g}), metric {ref['metric']:.7g}, register_many default / dot / forced "
        f"ladder")
    ctx = {"pairs": pairs, "names": names, "exp": exp, "ref": ref, "card": card,
           "held": None if kernels is None else {case["shape"] for case in kernels["nn1"]["cases"]}}
    if kernels is None:
        log("  [mesh] phase 3 did not run: the ranks' nn1 shapes are not checked against its cases")

    count = torch.cuda.device_count()
    require(count >= 2 or not cards_only, f"4l over the cards needs two cards or more, found {count}")
    if not cards_only:
        e2e["passes"]["mesh"] = mesh_world(torch, dev, f"gloo x{MESH_WORLD} on cuda:0", MESH_WORLD, "gloo",
                                           [str(dev)] * MESH_WORLD, True, ctx)
        if kernels is not None:
            for name in ("nn1", "fps", "field_ave", "field_dot", "field_trim"):
                kernels[name]["mesh_launches"] = e2e["passes"]["mesh"]["launches"][name]
        e2e["passes"]["mesh nccl x1"] = mesh_world(torch, dev, "nccl x1 on cuda:0", 1, "nccl", [str(dev)], False,
                                                   ctx)
    if count >= 2:
        world = min(MESH_WORLD, count)
        e2e["passes"]["mesh cards"] = mesh_world(torch, dev, f"nccl x{world} on cuda:0-{world - 1}", world, "nccl",
                                                 [f"cuda:{i}" for i in range(world)], True, ctx)


# Phase 4m: the reference oracle (kss_icp_torch/oracle.py, numpy + scipy on the host) against JAX's record
# (scripts/torch_port_expected.py --oracle) and the port on the card against the oracle.
ORACLE_TOL = 1e-6  # |mse|, |rmse|, |mae| against the record
NATIVE_RTOL = 1e-5  # the native rotation scan (float32 points) against the numpy oracle's float64 field


def oracle_pair(item) -> dict:
    """One (name, source, target) through the oracle, in a worker process of
    phase 4m: never touches the card."""
    from kss_icp_torch.oracle import pcr_qm, register_pair_oracle

    name, src, tgt = item
    res = register_pair_oracle(src, tgt)
    return dict(pcr_qm(res.aligned, tgt), name=name, used_multistart=res.used_multistart,
                num_candidates=res.num_candidates, chosen_candidate=res.chosen_candidate, seconds=res.seconds,
                stage_seconds=res.stage_seconds)


def oracle_port_rows(e2e: dict) -> dict:
    """The port's full-resolution RMSE at DEFAULT_CONFIG on the remesh 25 and
    the category board, {name: rmse}, from phase 4d's shipped passes."""
    p = e2e["passes"]
    require("shipped" in p and "shipped boards" in p, "4m: phase 4d's shipped passes are missing")
    rmse = {r["name"]: r["rmse"] for r in p["shipped"]["rows"]}
    rmse.update({r["name"]: r["rmse"] for r in p["shipped boards"]["rows"] if r["name"].startswith("category:")})
    return rmse


def native_scan_check(src: np.ndarray, tgt: np.ndarray) -> dict:
    """The native rotation scan against the numpy oracle's field on one pair's
    resampled clouds, as register_pair_oracle makes them."""
    from kss_icp_torch import oracle
    from kss_icp_torch.native import oracle_hot

    t0 = time.perf_counter()
    oracle_hot.library()
    build_s = time.perf_counter() - t0
    p_number = min(min(len(src), len(tgt)) // 2, 2000)
    cloud_t = oracle.aivs_simplify(np.asarray(tgt, np.float64), p_number)
    cloud_s = oracle.aivs_simplify(np.asarray(src, np.float64), p_number)
    t0 = time.perf_counter()
    ir = oracle.OracleInitRegistration(cloud_s, cloud_t)
    numpy_s = time.perf_counter() - t0
    tree = oracle_hot.NativeKDTree(ir.point_target)
    t0 = time.perf_counter()
    field = oracle_hot.rotation_scan(ir.point_source, tree, ir.step)
    native_s = time.perf_counter() - t0
    rel = float(np.max(np.abs(field - ir.value) / np.abs(ir.value)))
    return {"p_number": p_number, "build_s": build_s, "numpy_s": numpy_s, "native_s": native_s, "max_rel": rel,
            "ok": bool(np.allclose(field, ir.value, rtol=NATIVE_RTOL, atol=0.0))}


def phase_oracle(e2e: dict, card: str) -> None:
    """4m: the oracle on the remesh 25 and the category board in a process
    pool on the host, against fixtures/torch_port_expected_oracle.json; the
    port's RMSE on the card within the oracle's + RMSE_BAND on every pair; the
    native rotation scan against the numpy field on remesh pair 0."""
    from kss_icp_torch.challenge import category_corpus
    from kss_icp_torch.native import cpu_model, map_spawned

    t_phase = time.perf_counter()
    record = json.loads((FIXTURES / "torch_port_expected_oracle.json").read_text())
    expected = {p["name"]: p for p in record["pairs"]}
    expected.update({f"category:{p['name']}": p for p in record["boards"]["category"]["pairs"]})
    remesh = load_pairs()
    category = [(f"category:{name}", src, tgt) for name, src, tgt, _ in category_corpus()]
    pairs = remesh + category
    require(sorted(n for n, _, _ in pairs) == sorted(expected), "4m: the oracle record's pairs are not the corpus's")
    import scipy

    log(f"  [oracle] host CPU {cpu_model()}, {os.cpu_count()} cores; numpy {np.__version__}, scipy {scipy.__version__}; "
        f"the record's platform: {record['platform']}")
    workers = len(os.sched_getaffinity(0))
    t0 = time.perf_counter()
    rows = map_spawned(oracle_pair, pairs, workers)
    wall = time.perf_counter() - t0
    log(f"  [oracle] {len(rows)} pairs through register_pair_oracle in {wall:.3f} s on {workers} worker processes "
        f"({card})")
    port = oracle_port_rows(e2e)
    record_bad, band_bad = [], []
    for r in rows:
        exp = expected[r["name"]]
        gaps = {k: abs(r[k] - exp[k]) for k in ("mse", "rmse", "mae")}
        same = (r["num_candidates"] == exp["num_candidates"] and r["used_multistart"] == exp["used_multistart"]
                and max(gaps.values()) <= ORACLE_TOL)
        within = port[r["name"]] <= r["rmse"] + RMSE_BAND
        log(f"  [oracle] {r['name']}: oracle rmse {r['rmse']:.6f} (record {exp['rmse']:.6f}, max gap "
            f"{max(gaps.values()):.3g}) candidates {r['num_candidates']} (record {exp['num_candidates']}) multistart "
            f"{int(r['used_multistart'])} (record {int(exp['used_multistart'])}) chosen {r['chosen_candidate']} "
            f"(record {exp['chosen_candidate']}); port rmse {port[r['name']]:.6f} "
            f"({port[r['name']] - r['rmse']:+.6f}); {r['seconds']:.3f} s"
            f"{'' if same else ' RECORD DIFFERS'}{'' if within else ' OUTSIDE THE BAND'}")
        if not same:
            record_bad.append(r["name"])
        if not within:
            band_bad.append(f"{r['name']} (port {port[r['name']]:.6f}, oracle {r['rmse']:.6f})")
    require(not record_bad, f"4m: the oracle differs from JAX's record on {record_bad}")
    require(not band_bad, f"4m: the port's RMSE (phase 4d) is above the oracle's + {RMSE_BAND} on {band_bad}")
    seconds = [r["seconds"] for r in rows]
    log(f"  [oracle] seconds a pair: median {float(np.median(seconds)):.3f}, largest {max(seconds):.3f} "
        f"({max(rows, key=lambda r: r['seconds'])['name']}), sum {sum(seconds):.3f}; by stage (median / largest): " +
        ", ".join(f"{k} {float(np.median([r['stage_seconds'][k] for r in rows])):.3f} / "
                  f"{max(r['stage_seconds'][k] for r in rows):.3f}" for k in rows[0]["stage_seconds"]) +
        f" ({workers} workers on {cpu_model()}; {card})")
    margins = [port[r["name"]] - r["rmse"] for r in rows]
    log(f"  [oracle] port RMSE (phase 4d) minus the oracle's: median {float(np.median(margins)):+.6f}, largest "
        f"{max(margins):+.6f}, {sum(m < 0 for m in margins)}/{len(rows)} pairs below the oracle")
    name, src, tgt = remesh[0]
    nat = native_scan_check(src, tgt)
    log(f"  [oracle] native rotation scan on {name} (pnumber {nat['p_number']}): within {nat['max_rel']:.3g} of the "
        f"numpy field (relative); native {nat['native_s']:.4f} s, numpy {nat['numpy_s']:.4f} s (the scan with its "
        f"pre-shape), g++ build {nat['build_s']:.2f} s ({cpu_model()}; {card})")
    require(nat["ok"], f"4m: the native field is outside rtol {NATIVE_RTOL} of the numpy oracle's: {nat['max_rel']}")
    e2e["passes"]["oracle"] = {"wall_s": wall, "workers": workers, "seconds": seconds, "native": nat,
                               "phase_s": time.perf_counter() - t_phase, "cpu": cpu_model()}


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
    gaps = []
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
            fields[key] = (tuple(c.candidate_angles[0].tolist()), {tuple(a) for a in c.candidate_angles[:6].tolist()},
                           c.field)
        gaps.append(float(((fields["default"][2] - fields["highest"][2]).abs() / fields["highest"][2].abs()).max()))
        line = [f"bf16 field within {gaps[-1]:.3g} of 'highest' (relative)"]
        for ref in ("highest", "vpu"):
            s0 = fields["default"][0] == fields[ref][0]
            s6 = fields["default"][1] == fields[ref][1]
            same0[ref] += s0
            same6[ref] += s6
            line.append(f"vs {ref}: candidate 0 {'same' if s0 else 'DIFFERS'}, top-6 set {'same' if s6 else 'differs'}")
        log(f"  [bf16 field] {name}: " + "; ".join(line))
    n = len(pairs)
    log(f"  [bf16 field] the bf16 8³ field (field_dot's tensor-core kernel, one bf16 pass) keeps candidate 0 of "
        f"'highest' (its six bf16 products) on {same0['highest']}/{n} pairs and of field_ave on {same0['vpu']}/{n}; "
        f"the top-6 set on {same6['highest']}/{n} and {same6['vpu']}/{n}; the field within {max(gaps):.3g} of "
        f"'highest' at the worst pair (median {float(np.median(gaps)):.3g})")


def main() -> int:
    import torch

    args = sys.argv[1:]
    require(args in ([], ["--mesh-cards"]), f"usage: python3 chip_smoke.py [--mesh-cards]; got {args}")
    mesh_cards = args == ["--mesh-cards"]
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

    if mesh_cards:
        log("== 4l. the device mesh over the cards alone (--mesh-cards): NCCL, one rank a card")
        e2e = {"passes": {}}
        phase_mesh(torch, dev, None, e2e, card, cards_only=True)
        lap("4l")
        cards = e2e["passes"]["mesh cards"]
        log(f"mesh over the cards: register_many {', '.join(f'{x:.3f}' for x in cards['pairs_per_s'])} pairs/s "
            f"beside the unsharded batch's {', '.join(f'{x:.3f}' for x in cards['unsharded_pairs_per_s'])} on one "
            f"card; field {cards['seconds']['field']:.4f} s, ICP {cards['seconds']['icp']:.4f} s, metric "
            f"{cards['seconds']['metric']:.4f} s (slowest rank) ({card})")
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return 0

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
    log("== 4l. the device mesh: kss_icp_torch.parallel on torch.distributed, 4 gloo ranks on this card, NCCL x1")
    phase_mesh(torch, dev, kernels, e2e, card)
    lap("4l")
    attach_pass_launches(kernels, e2e)
    g = p["mesh"]["gaps"]
    log(f"mesh: register_many over 4 ranks sharing the card {', '.join(f'{x:.3f}' for x in p['mesh']['pairs_per_s'])} "
        f"pairs/s beside the unsharded batch's {', '.join(f'{x:.3f}' for x in p['mesh']['unsharded_pairs_per_s'])} "
        f"(overhead, not scaling); field {p['mesh']['seconds']['field']:.4f} s, ICP {p['mesh']['seconds']['icp']:.4f} "
        f"s, metric {p['mesh']['seconds']['metric']:.4f} s (slowest rank); gaps: field {g['field']:.3g}, ICP pose "
        f"{g['icp_pose']:.3g}, metric {g['metric_rel']:.3g} ({card})")
    if "mesh cards" in p:
        c = p["mesh cards"]
        log(f"mesh over the cards: register_many {', '.join(f'{x:.3f}' for x in c['pairs_per_s'])} pairs/s beside "
            f"the unsharded batch's {', '.join(f'{x:.3f}' for x in c['unsharded_pairs_per_s'])} on one card ({card})")
    log(f"two-stage, pairs/s in turns with shipped: remesh 25 {p['two-stage']['pairs_per_s']:.3f} (shipped "
        f"{p['two-stage']['shipped_pairs_per_s']:.3f}), in one batch {p['two-stage many']['pairs_per_s']:.3f} (shipped "
        f"{p['two-stage many']['shipped_pairs_per_s']:.3f}); boards in one batch "
        f"{p['two-stage many boards']['pairs_per_s']:.3f} synced (shipped "
        f"{p['two-stage many boards']['shipped_pairs_per_s']:.3f}); vcm " + ", ".join(f"{r['ms']:.1f}" for r in p["vcm"]["runs"]) +
        f" ms; lloyd {p['voronoi']['ms']:.1f} ms; mesh angles {p['mesh angles']['ms']:.1f} ms ({card})")

    log("== 4m. the reference oracle: kss_icp_torch.oracle on the host, the port on the card against it")
    phase_oracle(e2e, card)
    lap("4m")
    o = p["oracle"]
    log(f"oracle: the remesh 25 and the category board in {o['wall_s']:.3f} s on {o['workers']} host processes "
        f"(median {float(np.median(o['seconds'])):.3f} s a pair, largest {max(o['seconds']):.3f}); native scan "
        f"{o['native']['native_s']:.4f} s beside numpy's {o['native']['numpy_s']:.4f} s; phase {o['phase_s']:.1f} s "
        f"({o['cpu']}; {card})")

    log("== 5. bf16 dot field against the float32 fields (gates nothing)")
    phase_bf16_ranking(torch, dev)
    log(f"smoke run {time.perf_counter() - t_start:.1f} s ({card})")

    keys = ("name", "route", "source", "replaces", "also_replaces", "launches", "cli_launches", "max_abs_err", "ms", "device_ms",
            "plain_ms", "bound_ms", "bound_by", "bruteforce_bound_ms", "library_ms", "yardstick", "yardstick_ms", "shape", "precision", "cases",
            "launch_shapes", "squared", "mesh_launches")
    line = {"kernels": [{k: v for k, v in dict(kernels[n], name=n, route="cuda", library_ms=None).items() if k in keys}
                        for n in ("nn1", "fps", "field_ave", "field_dot", "field_trim", "field_keys",
                                  "icp_update")]}
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
