#!/usr/bin/env python3
"""Old against new kernels, in turns, on one CUDA card.

    python3 scripts/torch_kernel_ab.py --old DIR [--reps N] [--sass] [--sweep] [--out DIR]

DIR holds older kernel sources, any of: `nn.cu` with the C interface it
had before its queries-a-thread argument (kss_nn1 with the cluster and the
slice, the running argmin a pair: `git show 30784b8:kss_icp_torch/csrc/nn.cu`;
the old plan is `old_nn1_plan`, the parent's rule); `fps.cu`
with the one-block interface it had before clusters (kss_fps with steps,
points a thread, threads and a workspace; the old plan is the one-block
plan, points in registers up to 8192 and the workspace above); `field.cu` and `field_dot.cu`
with their `field_kernel.cuh`, the field template they had before the tensor-core
field_dot and the culling kernel's "ave" statistic (kss_field_ave and kss_field_dot
on a rotated (C, P, 3) source, the target mask and the group-slots plan: `git show
b803993:kss_icp_torch/csrc/field.cu`, `field_dot.cu` and `field_kernel.cuh`);
`field_trim.cu` with the
per-point interface it had before culling (kss_field_trim and kss_field_sq
on a rotated (C, P, 3) source, writing a (C, P) buffer; with the
`field_kernel.cuh` of its commit beside it: `git show
7352256:kss_icp_torch/csrc/field_trim.cu` and `field_kernel.cuh`, in a directory of
their own). They are built with the
package's nvcc flags into a second ctypes library under
`kss_icp_torch/_build/ab_old/`; the package's own sources are built as
usual. For each kernel whose old source DIR holds, at each of the main
path's shapes, the script checks that old and new give the same bits, then
times the two C entry points on preallocated outputs in turns, old, new,
new, old: each turn is the mean device time of --reps launches replayed
from one CUDA graph (the kernel's own time; a launch of the small shapes
takes less than the host's cost of a call). It also times the new wrapper
called back to back, which is what the main path pays, and prints one line
per shape; nn1 runs at the shapes of PERF.md's K3 and K4 rows. The fields
run at chip_smoke.py phase 3's shapes: the 8³ grid's padded clouds (512 x
2048 x 2048) mostly valid, all valid and with both clouds suffix-masked
to the largest, median and smallest remesh pair's pnumber (1534, 1070,
378), the 16³ grid (4096 x 512 x 512), mostly valid,
the bench config's 512-point prefixes on the 8³ grid (512 x 512 x 512),
all valid and with the smallest pair's 378, and (field_ave) a mesh rank's
quarter of the 16³ grid at 1534 rows (1024 x 2048 x 2048); field_dot at
"highest" and "default". An old field is what the main path paid for it:
the rotation pass (and field_dot's operand pass), the old kernel and the
division, against the new wrapper (field_order's sort and one launch of
the culling kernel for field_ave; one launch for field_dot); each kernel is
also timed alone. The new field_ave must equal its plain version's bits
and the old one's within rtol 2e-5 (float32 partial sums against a
float64 mean); field_dot old and new within rtol 2e-5. The old
trim, max and diff fields are what the main path paid for them: the
rotation, the per-point kernel and PyTorch's row reduction (sort, cumsum and
gather; max; max and mean), against the new wrapper (field_order's sort and
one launch); they run at the overlap rungs' 512 and 4096 x 2048 x 2048 with
~70% scattered inliers and at the remesh suffixes 1534 / 1070 / 378 on the
8³ grid. Each row also times the two kernels alone and carries the new
kernel's share of (point, row) pairs scanned; the old per-point values must
equal the new probe mode's, and the old values reduced in float64 the new
fields.
The card's name, power limit and maximum SM clock come first; one JSON
object with every number is the last line, and is also written to
torch_kernel_ab.json in --out (default _scratch/kernel_ab/, gitignored).
--sass also writes the new library's SASS (cuobjdump) there as
torch_kernels.sass and prints each field_dot instantiation's tensor-core
instructions (HMMA) and, for the old and the new nn1 kernels, the
instructions a (query, row) pair of the scan's inner loop, by opcode.
--sweep also times every launch plan the new C entry points take at those
shapes (nn1: each cluster size at 2 and 4 queries a thread; fps: each cluster
size whose slices fit a block, with the slice in registers and in shared
memory where both hold it, each beside its empty step, the same cluster and
threads with one point a block), beside the plan the wrappers pick, and
writes them there as torch_kernel_sweep.json. Each fps row also carries the new plan's empty
step.

Imports nothing of JAX and nothing of kss_icp_tpu.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from kss_icp_torch import _build  # noqa: E402
from kss_icp_torch.core.transforms import euler_xyz_matrix  # noqa: E402
from kss_icp_torch.models.coarse import rotation_grid  # noqa: E402
from kss_icp_torch.ops import coarse_cuda as cc  # noqa: E402
from kss_icp_torch.ops.coarse_cuda import dot_operands, dot_plan, field_dot  # noqa: E402
from kss_icp_torch.ops.nn_cuda import MAX_CLUSTER, MIN_SLICE, QUERIES, NN1Plan, nn1, nn1_plan, sm_count  # noqa: E402
from kss_icp_torch.ops.resample import fps_centroid  # noqa: E402
from kss_icp_torch.ops.resample_cuda import (CLUSTERS, MAX_THREADS, REGISTER_POINTS, SHARED_K,  # noqa: E402
                                             SHARED_SLICE, FPSPlan, empty_step_plan, fps, fps_plan)
from kss_icp_torch.timing import graph_ms, time_ms  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int
# old source -> (C entry point, its argtypes)
OLD_SIGNATURES = {
    "nn.cu": ("kss_nn1", (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P)),
    "fps.cu": ("kss_fps", (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P)),
    "field.cu": ("kss_field_ave", (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P)),
    "field_dot.cu": ("kss_field_dot", (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P)),
    "field_trim.cu": ("kss_field_trim", (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P)),
}
# Further entry points of an old source: the per-point field_trim.cu's squared mode.
OLD_EXTRA = {"field_trim.cu": [("kss_field_sq", (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P))]}
# (L, Q, R, G reference clouds, valid rows of one cloud or None, label): the
# shapes of PERF.md's K3 rows (ICP, the ladder, the overlap screen, the batch
# and mesh passes, the tools) and K4 rows (the metrics).
NN1_SHAPES = [
    (32, 512, 2048, 1, None, "K3 screen"), (16, 512, 2048, 1, None, "K3 escalation screen"),
    (4, 2048, 2048, 1, None, "K3 refine"), (2, 2048, 2048, 1, None, "K3 two-tier refine"),
    (1, 2048, 2048, 1, None, "K3 final converge"),
    (800, 512, 2048, 25, None, "K3 many: screen, 25 clouds"), (2048, 512, 2048, 64, None, "K3 many boards: screen"),
    (100, 2048, 2048, 25, None, "K3 many: refine"), (256, 2048, 2048, 64, None, "K3 many boards: refine"),
    (512, 512, 2048, 1, None, "K3 overlap screen ICP"), (8192, 512, 2048, 16, None, "K3 many boards: screen rung"),
    (512, 2048, 2048, 1, None, "K3 overlap fitness, forward"),
    (512, 2048, 2048, 512, None, "K3 overlap fitness, reverse"),
    (8192, 2048, 2048, 16, None, "K3 many boards: fitness, forward"),
    (8192, 2048, 2048, 8192, None, "K3 many boards: fitness, reverse"),
    (12, 2048, 2048, 1, None, "K3 precision polish"), (300, 2048, 2048, 25, None, "K3 precise many: polish"),
    (1, 1310720, 40960, 1, None, "K3 VCM sample owners"), (1, 1048576, 4096, 1, None, "K3 Voronoi labels"),
    (1, 512, 2048, 1, None, "K3 point-sharded ICP"), (224, 512, 2048, 7, None, "K3 mesh rank: screen"),
    (28, 2048, 2048, 7, None, "K3 mesh rank: refine"), (21, 2048, 2048, 7, None, "K3 mesh rank: 3 lanes"),
    (7, 2048, 2048, 7, None, "K3 mesh rank: 1 lane"), (112, 512, 2048, 7, None, "K3 mesh rank: escalation screen"),
    (3584, 512, 2048, 7, None, "K3 mesh rank: overlap screen ICP"),
    (3584, 2048, 2048, 7, None, "K3 mesh rank: overlap fitness, forward"),
    (3584, 2048, 2048, 3584, None, "K3 mesh rank: overlap fitness, reverse"),
    (48, 512, 2048, 3, None, "K3 mesh rank: escalated screen"), (12, 2048, 2048, 3, None, "K3 mesh rank: escalated"),
    (3, 2048, 2048, 3, None, "K3 mesh rank: escalated, 1 lane"),
    (1, 3072, 8192, 1, None, "K4 metric, largest remesh pair"), (1, 768, 4096, 1, None, "K4 metric, smallest pair"),
    (25, 8192, 8192, 25, None, "K4 many: metric"), (64, 8192, 8192, 64, None, "K4 many boards: metric"),
    (1, 65536, 65536, 1, None, "K4 regime"), (1, 200704, 200704, 1, 200000, "K4 large-scan metric"),
    (1, 50176, 200704, 1, 200000, "K4 sharded large-scan metric"), (7, 8192, 8192, 7, None, "K4 mesh rank: metric"),
]
# (B, P, S, steps, label): register_pair's two launches at the largest pair's
# padded source and target (pnumber 1534 of 2048 slots), the PERF.md table's
# shape, register_many's batches (a mesh rank's 14 clouds, the remesh 25's 50,
# the boards' 128), the large scan's two survivor clouds and WLOP's start.
FPS_SHAPES = [(1, 3072, 2048, 1534, "remesh source"), (1, 8192, 2048, 1534, "remesh target"),
              (2, 8192, 2048, 2048, "table shape"), (14, 8192, 2048, 1500, "a mesh rank's 14 clouds"),
              (50, 8192, 2048, 1534, "many: the remesh 25's 50 clouds"),
              (128, 8192, 2048, 2000, "many boards: the boards' 128 clouds"),
              (2, 151552, 2048, 2000, "large scan: two survivor clouds"),
              (1, 40960, 8000, 8000, "WLOP start")]
# (grid steps, padded P = T, valid rows of both clouds, label, parts: the
# first 1/parts of the rotations); None: the smoke run's masks, n - n // 40
# source and n - n // 20 target rows.
FIELD_SHAPES = [(8, 2048, None, "8³ grid, mostly valid", 1), (8, 2048, 2048, "8³ grid, all valid", 1),
                (8, 2048, 1534, "8³ grid, largest remesh pair", 1), (8, 2048, 1070, "8³ grid, median remesh pair", 1),
                (8, 2048, 378, "8³ grid, smallest remesh pair", 1), (16, 512, None, "16³ grid, mostly valid", 1),
                (8, 512, 512, "8³ grid, bench prefixes", 1),
                (8, 512, 378, "8³ grid, bench prefixes, smallest remesh pair", 1),
                (16, 2048, 1534, "a mesh rank's quarter of the 16³ grid, largest remesh pair", 4)]
FIELD_VARIANTS = [("field_ave", None), ("field_dot", "highest"), ("field_dot", "default")]
OLD_GROUP = 256  # the old field template's points a partial sum
OLD_SLOTS = (4, 2, 1)  # its group slots a block
# (grid steps, P = T, valid rows of both clouds, label) of the trim, max and
# diff fields: "inliers" is ~70% scattered in the first n - n // 20 rows.
CULL_SHAPES = [(8, 2048, "inliers", "8³ overlap field, ~70% inliers"),
               (16, 2048, "inliers", "16³ overlap field, ~70% inliers"),
               (8, 2048, 1534, "8³ grid, largest remesh pair"), (8, 2048, 1070, "8³ grid, median remesh pair"),
               (8, 2048, 378, "8³ grid, smallest remesh pair")]


def cloud(rng: np.random.Generator, n: int) -> np.ndarray:
    u = rng.uniform(-1, 1, size=(n,))
    v = rng.uniform(-1, 1, size=(n,))
    return np.stack([u, v, 0.3 * np.sin(3 * u) * np.cos(2 * v)], axis=-1).astype(np.float32)


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def load_old(old_dir: Path) -> tuple:
    """(the old library, the sources of OLD_SIGNATURES that DIR holds)."""
    present = sorted(name for name in OLD_SIGNATURES if (old_dir / name).exists())
    if not present:
        raise SystemExit(f"{old_dir} holds none of {sorted(OLD_SIGNATURES)}")
    path, log, seconds = _build.build(csrc=old_dir, out=_build.BUILD / "ab_old")
    print(f"old library {path.name} ({', '.join(present)}) built in {seconds:.2f} s", flush=True)
    lib = ctypes.CDLL(str(path))
    for src in present:
        for name, argtypes in [OLD_SIGNATURES[src]] + OLD_EXTRA.get(src, []):
            getattr(lib, name).argtypes = list(argtypes)
            getattr(lib, name).restype = ctypes.c_int
    return lib, present, path


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(code: int, name: str) -> None:
    if code:
        raise RuntimeError(f"{name}: CUDA error {code}")


def nn1_inputs(rng, dev, lanes: int, q_n: int, r_n: int, groups: int, valid):
    """(query, ref, mask, lane_ref) of one nn1 shape: lane l against cloud
    l // (L / G); one cloud with `valid` rows (default a tail of R // 40
    padded rows); G clouds each with a valid prefix of R/5..R rows, and
    where G == L each lane's own ~70% inlier mask, as the overlap screen's
    reverse fitness has."""
    query = torch.as_tensor(np.stack([cloud(rng, q_n) for _ in range(lanes)]), device=dev)
    ref = torch.as_tensor(np.stack([cloud(rng, r_n) for _ in range(groups)]), device=dev)
    rows = torch.arange(r_n, device=dev)[None]
    if groups == 1:
        mask = rows < (r_n - r_n // 40 if valid is None else valid)
    else:
        mask = rows < torch.as_tensor(rng.integers(r_n // 5, r_n + 1, size=(groups, 1)), device=dev)
        if groups == lanes:
            mask &= torch.as_tensor(rng.uniform(size=(groups, r_n)) < 0.7, device=dev)
    lane_ref = torch.arange(groups, dtype=torch.int32, device=dev).repeat_interleave(lanes // groups)
    return query, ref, mask.contiguous(), lane_ref


def nn1_launch(lib, query, ref, mask, lane_ref, plan, out) -> None:
    """The new C entry point at `plan`."""
    lanes, q_n = query.shape[:2]
    groups, r_n = ref.shape[:2]
    _check(lib.kss_nn1(query.data_ptr(), ref.data_ptr(), mask.data_ptr(), lane_ref.data_ptr(), lanes, q_n, groups,
                       r_n, plan.cluster, plan.slice, plan.queries, out[0].data_ptr(), out[1].data_ptr(), _stream()),
           "kss_nn1")


def old_nn1_plan(lanes: int, q_n: int, r_n: int, sms: int) -> NN1Plan:
    """The old nn.cu's plan: 256 queries a block (2 a thread), R split over
    the smallest power-of-two cluster (up to 8, slices of at least 256 rows)
    that gives the launch 2 x `sms` blocks."""
    tiles = lanes * -(-q_n // 256)
    cluster = 1
    while cluster < MAX_CLUSTER and r_n >= 2 * cluster * MIN_SLICE and tiles * cluster < 2 * sms:
        cluster *= 2
    return NN1Plan(cluster, -(-r_n // cluster), 2)


def nn1_calls(old, query, ref, mask, lane_ref):
    """(old call, new call, outputs): both C entry points on preallocated
    outputs, the old one at its own plan (old_nn1_plan)."""
    lanes, q_n = query.shape[:2]
    groups, r_n = ref.shape[:2]
    outs = [(torch.empty((lanes, q_n), dtype=torch.float32, device=query.device),
             torch.empty((lanes, q_n), dtype=torch.int32, device=query.device)) for _ in range(2)]
    sms = sm_count(query.device.index)
    plan, old_plan = nn1_plan(lanes, q_n, r_n, sms), old_nn1_plan(lanes, q_n, r_n, sms)
    new = _build.library()

    def run_old():
        _check(old.kss_nn1(query.data_ptr(), ref.data_ptr(), mask.data_ptr(), lane_ref.data_ptr(), lanes, q_n,
                           groups, r_n, old_plan.cluster, old_plan.slice, outs[0][0].data_ptr(),
                           outs[0][1].data_ptr(), _stream()), "old kss_nn1")

    def run_new():
        nn1_launch(new, query, ref, mask, lane_ref, plan, outs[1])
    return run_old, run_new, outs


def nn1_reps(reps: int, lanes: int, q_n: int, r_n: int) -> int:
    return max(3, min(reps, int(2e10 // (lanes * q_n * r_n))))


def old_fps_plan(p_n: int) -> tuple:
    """The one-block plan of the old fps.cu: (points a thread in registers,
    threads), (0, 512) for the workspace path above 8192 points."""
    for k in REGISTER_POINTS:
        if p_n <= k * MAX_THREADS:
            return k, 32 * -(-p_n // (32 * k))
    return 0, MAX_THREADS


def new_fps(lib, points, mask, centroid, s, steps, plan: FPSPlan, out) -> None:
    """The new C entry point at `plan`."""
    batch, p_n = mask.shape
    _check(lib.kss_fps(points.data_ptr(), mask.data_ptr(), centroid.data_ptr(), batch, p_n, s, steps, plan.cluster,
                       plan.slice, plan.k, plan.threads, int(plan.registers), out.data_ptr(), _stream()), "kss_fps")


def fps_calls(old, points, mask, s, steps):
    batch, p_n = mask.shape
    centroid = fps_centroid(points, mask).contiguous()
    k_old, threads_old = old_fps_plan(p_n)
    work = torch.empty((batch, p_n, 4) if k_old == 0 else (1,), dtype=torch.float32, device=points.device)
    outs = [torch.empty((batch, s), dtype=torch.int32, device=points.device) for _ in range(2)]
    plan = fps_plan(batch, p_n, sm_count(points.device.index))
    new = _build.library()

    def run_old():
        _check(old.kss_fps(points.data_ptr(), mask.data_ptr(), centroid.data_ptr(), batch, p_n, s, steps, k_old,
                           threads_old, work.data_ptr(), outs[0].data_ptr(), _stream()), "old kss_fps")

    def run_new(k=steps):
        new_fps(new, points, mask, centroid, s, k, plan, outs[1])
    return run_old, run_new, outs


def fps_floor_ms(dev, batch: int, s: int, steps: int, plan: FPSPlan, reps: int) -> float:
    """Device ms of `steps` empty steps at `plan`'s cluster and threads
    (resample_cuda.empty_step_plan): B clouds of one point a block."""
    floor = empty_step_plan(plan)
    pts = torch.zeros((batch, plan.cluster, 3), dtype=torch.float32, device=dev)
    mask = torch.ones((batch, plan.cluster), dtype=torch.bool, device=dev)
    centroid = fps_centroid(pts, mask).contiguous()
    out = torch.empty((batch, s), dtype=torch.int32, device=dev)
    lib = _build.library()
    return graph_ms(lambda: new_fps(lib, pts, mask, centroid, s, steps, floor, out), reps)


def field_inputs(rng, dev, steps: int, n: int, valid, parts: int = 1):
    """(source, source mask, target, target mask, rotations) of one field shape."""
    src, tgt = (torch.as_tensor(cloud(rng, n), device=dev) for _ in range(2))
    rows = torch.arange(n, device=dev)
    smask, tmask = (rows < n - n // 40, rows < n - n // 20) if valid is None else (rows < valid, rows < valid)
    rots = euler_xyz_matrix(rotation_grid(steps, 6.3, dev))
    return src, smask, tgt, tmask, rots[:rots.shape[0] // parts].contiguous()


def old_slots(p_n: int) -> int:
    """The old field template's plan: as many group slots as the source has
    groups of 256 points, up to 4."""
    return next(s for s in OLD_SLOTS if s <= -(-p_n // OLD_GROUP))


def old_field_calls(old, name, precision, args):
    """(the old call, the old kernel alone, its sums' buffer): the main path's
    call before, the rotation pass (and field_dot's operand pass), PR 15's
    C entry point and the division; and that entry point alone on
    operands computed once."""
    src, smask, tgt, tmask, rots = args
    c_n, p_n, t_n = rots.shape[0], src.shape[0], tgt.shape[0]
    partial = torch.empty((c_n, -(-p_n // OLD_GROUP)), dtype=torch.float32, device=src.device)
    sums = torch.empty((c_n,), dtype=torch.float32, device=src.device)
    slots, bf16 = old_slots(p_n), int(precision == "default")

    def launch(rotated, q2, weight, ra):
        if name == "field_ave":
            _check(old.kss_field_ave(rotated.data_ptr(), weight.data_ptr(), tgt.data_ptr(), tmask.data_ptr(), c_n,
                                     p_n, t_n, slots, partial.data_ptr(), sums.data_ptr(), _stream()),
                   "old kss_field_ave")
        else:
            _check(old.kss_field_dot(rotated.data_ptr(), q2.data_ptr(), weight.data_ptr(), ra.data_ptr(),
                                     tmask.data_ptr(), c_n, p_n, t_n, bf16, slots, partial.data_ptr(),
                                     sums.data_ptr(), _stream()), "old kss_field_dot")

    def operands():
        if name == "field_ave":
            return cc.rotate_sources(rots, src), None, smask.to(torch.float32).contiguous(), None
        return dot_operands(*args)

    def run_old():
        ops = operands()
        launch(*ops)
        return sums / ops[2].sum().clamp_min(1.0)

    fixed = operands()
    return run_old, lambda: launch(*fixed), sums


def new_field_calls(name, precision, args):
    """(the new wrapper, the new kernel alone): field_ave's is one launch of
    the culling kernel on field_order's order computed once; field_dot's
    wrapper is its one launch."""
    if name == "field_dot":
        return (lambda: field_dot(*args, precision)), (lambda: field_dot(*args, precision))
    src, smask, tgt, tmask, rots = args
    order = cc.field_order(src, smask, tgt, tmask)
    out = torch.empty((rots.shape[0],), dtype=torch.float32, device=src.device)
    return (lambda: cc.field_ave(*args)), (lambda: cc._cull_launch("kss_field_cull", "ave", src, smask, tgt, tmask,
                                                                    order, rots, out))


def in_turns(old, new, reps: int) -> dict:
    """old, new, new, old; each the mean device time of `reps` graphed launches."""
    t = [graph_ms(old, reps), graph_ms(new, reps), graph_ms(new, reps), graph_ms(old, reps)]
    return {"old_ms": (t[0] + t[3]) / 2, "new_ms": (t[1] + t[2]) / 2, "turns_ms": t}


def sweep(dev, reps: int) -> dict:
    """Device ms of every launch plan at the main path's shapes."""
    rng = np.random.default_rng(1)
    lib = _build.library()
    result = {"nn1": [], "fps": []}
    for lanes, q_n, r_n, groups, valid, label in NN1_SHAPES:
        query, ref, mask, lane_ref = nn1_inputs(rng, dev, lanes, q_n, r_n, groups, valid)
        out = (torch.empty((lanes, q_n), dtype=torch.float32, device=dev),
               torch.empty((lanes, q_n), dtype=torch.int32, device=dev))
        n = nn1_reps(reps, lanes, q_n, r_n)
        rows, want = [], None
        for queries in QUERIES:
            for cluster in (1, 2, 4, 8):
                plan = NN1Plan(cluster, -(-r_n // cluster), queries)
                nn1_launch(lib, query, ref, mask, lane_ref, plan, out)
                torch.cuda.synchronize()
                want = (out[0].clone(), out[1].clone()) if want is None else want
                same = bool(torch.equal(out[0], want[0]) and torch.equal(out[1], want[1]))
                ms = graph_ms(lambda plan=plan: nn1_launch(lib, query, ref, mask, lane_ref, plan, out), n)
                rows.append(dict(plan._asdict(), ms=ms, same_bits=same))
        chosen = nn1_plan(lanes, q_n, r_n, sm_count(dev.index))
        best = min(rows, key=lambda r: r["ms"])
        result["nn1"].append({"shape": f"{lanes}x{q_n}x{r_n}", "groups": groups, "label": label,
                              "chosen": chosen._asdict(), "plans": rows})
        print(f"sweep nn1 {lanes}x{q_n}x{r_n} G={groups} ({label}): chosen {tuple(chosen)} "
              f"{next(r['ms'] for r in rows if (r['queries'], r['cluster']) == (chosen.queries, chosen.cluster)):.4f}"
              f" ms, fastest q{best['queries']} C{best['cluster']} {best['ms']:.4f} ms; " +
              "; ".join(f"q{r['queries']} C{r['cluster']} {r['ms']:.4f}{'' if r['same_bits'] else ' BITS DIFFER'}"
                        for r in rows), flush=True)
        if not all(r["same_bits"] for r in rows):
            raise RuntimeError(f"nn1 sweep {lanes}x{q_n}x{r_n}: a plan's answers differ from another's")
    sms = sm_count(dev.index)
    for b_n, p_n, s, steps, label in FPS_SHAPES:
        pts = torch.as_tensor(np.stack([cloud(rng, p_n) for _ in range(b_n)]), device=dev)
        mask = torch.ones((b_n, p_n), dtype=torch.bool, device=dev)
        centroid = fps_centroid(pts, mask).contiguous()
        idx = torch.empty((b_n, s), dtype=torch.int32, device=dev)
        want = None
        rows = []
        for cluster in CLUSTERS:
            slice_n = -(-p_n // cluster)
            if slice_n > SHARED_SLICE or b_n * cluster > 2 * sms or (cluster > 1 and slice_n < 256):
                continue
            # Every points-a-thread count that holds the slice in registers,
            # and the slice in shared memory.
            plans = [FPSPlan(cluster, slice_n, k, 32 * -(-slice_n // (32 * k)), True) for k in REGISTER_POINTS
                     if slice_n <= k * MAX_THREADS and (k == 1 or slice_n > k // 2 * 32)]
            plans.append(FPSPlan(cluster, slice_n, SHARED_K, MAX_THREADS, False))
            for plan in plans:
                new_fps(lib, pts, mask, centroid, s, steps, plan, idx)
                torch.cuda.synchronize()
                want = idx.clone() if want is None else want
                n = max(3, reps // 10)
                ms = graph_ms(lambda plan=plan: new_fps(lib, pts, mask, centroid, s, steps, plan, idx), n)
                floor = fps_floor_ms(dev, b_n, s, steps, plan, n)
                rows.append(dict(plan._asdict(), ms=ms, floor_ms=floor, same_bits=bool(torch.equal(idx, want)),
                                 us_per_step=ms * 1e3 / steps, floor_us_per_step=floor * 1e3 / steps))
        chosen = fps_plan(b_n, p_n, sms)
        result["fps"].append({"shape": f"{b_n}x{p_n}->{s}", "steps": steps, "label": label,
                              "chosen": chosen._asdict(), "plans": rows})
        print(f"sweep fps {b_n}x{p_n} steps {steps} ({label}): chosen {tuple(chosen)}; " +
              "; ".join(f"C {r['cluster']} k {r['k']} x {r['threads']} {'reg' if r['registers'] else 'smem'} "
                        f"{r['ms']:.4f} ms (floor {r['floor_ms']:.4f}){'' if r['same_bits'] else ' BITS DIFFER'}"
                        for r in rows), flush=True)
        if not all(r["same_bits"] for r in rows):
            raise RuntimeError(f"fps sweep {b_n}x{p_n}: a plan's picks differ from another's")
    return result


def old_row_stat(dist, smask, stat):
    """PyTorch's row reduction of the per-point kernel's (C, P) values, as
    the main path ran it before the fused kernel: the trimmed mean's float32
    sort, cumulative sum and gather; the max; the max and the float32 mean."""
    from kss_icp_torch.ops.nn import BIG, masked_mean, trimmed_masked_mean

    mask = smask.expand(dist.shape)
    if stat == "trim":
        return trimmed_masked_mean(dist, mask, 0.7)
    neg = torch.full_like(dist, -BIG)
    if stat == "max":
        return torch.where(mask, dist, neg).amax(dim=-1)
    d = torch.sqrt(dist)
    return torch.where(mask, d, neg).amax(dim=-1) - masked_mean(d, mask)


def ab_cull(old, dev, rng, reps: int) -> list:
    """The per-point field_trim.cu path against the fused kernel at
    CULL_SHAPES, for trim, max and diff: bits, then device times in turns
    (the whole call each), and each kernel alone."""
    from kss_icp_torch.ops import coarse_cuda as cc
    from kss_icp_torch.ops.nn import trimmed_masked_mean

    rows = []
    for steps, n, valid, label in CULL_SHAPES:
        src, tgt = (torch.as_tensor(cloud(rng, n), device=dev) for _ in range(2))
        r = torch.arange(n, device=dev)
        if valid == "inliers":
            smask, tmask = ((r < n - n // 20) & torch.as_tensor(rng.uniform(size=n) < 0.7, device=dev)
                            for _ in range(2))
        else:
            smask = tmask = r < valid
        rots = euler_xyz_matrix(rotation_grid(steps, 6.3, dev)).contiguous()
        c_n = rots.shape[0]
        rotated = cc.rotate_sources(rots, src)
        weight = smask.to(torch.float32)
        dist = torch.empty((c_n, n), dtype=torch.float32, device=dev)
        order = cc.field_order(src, smask, tgt, tmask)
        out = torch.empty((c_n,), dtype=torch.float32, device=dev)
        for stat in ("trim", "max", "diff"):
            entry = old.kss_field_trim if stat == "trim" else old.kss_field_sq
            cap = cc.field_cull_plan(n, n, stat)

            def old_kernel(entry=entry):
                _check(entry(rotated.data_ptr(), weight.data_ptr(), tgt.data_ptr(), tmask.data_ptr(), c_n, n, n,
                             old_slots(n), dist.data_ptr(), _stream()), "old kss_field_trim")

            def run_old(stat=stat, entry=entry):
                rot = cc.rotate_sources(rots, src)
                w = smask.to(torch.float32).contiguous()
                _check(entry(rot.data_ptr(), w.data_ptr(), tgt.data_ptr(), tmask.data_ptr(), c_n, n, n,
                             old_slots(n), dist.data_ptr(), _stream()), "old kss_field_trim")
                return old_row_stat(dist, smask, stat)

            def run_new(stat=stat):
                if stat == "trim":
                    return cc.field_trim(src, smask, tgt, tmask, rots, 0.7)
                return cc.field_sq(src, smask, tgt, tmask, rots, stat)

            def new_kernel(stat=stat):
                cc._cull_launch("kss_field_cull", stat, src, smask, tgt, tmask, order, rots, out)

            old_kernel()
            probe = (cc.field_trim_distances if stat == "trim" else cc.field_sq_distances)(src, smask, tgt, tmask,
                                                                                           rots)
            scanned = torch.zeros(2, dtype=torch.int64, device=dev)
            fused = (cc.field_trim(src, smask, tgt, tmask, rots, 0.7, scanned=scanned) if stat == "trim"
                     else cc.field_sq(src, smask, tgt, tmask, rots, stat, scanned=scanned))
            torch.cuda.synchronize()
            if stat == "trim":
                want = trimmed_masked_mean(dist, smask.expand(dist.shape), 0.7, dtype=torch.float64)
            else:
                from kss_icp_torch.ops.nn import sq_error
                want = sq_error(dist, smask, stat)
            same = bool(torch.equal(dist, probe) and torch.equal(fused, want))
            m = max(3, reps // 5)
            row = dict(in_turns(run_old, run_new, m), shape=f"{c_n}x{n}x{n}", valid=valid, label=label, stat=stat,
                       same_bits=same, reps=m, cap=cap)
            row["old_kernel_ms"] = graph_ms(old_kernel, m)
            row["new_kernel_ms"] = graph_ms(new_kernel, m)
            row["order_ms"] = graph_ms(lambda: cc.field_order(src, smask, tgt, tmask), m)
            row["scanned_share"] = int(scanned[0]) / (c_n * int(smask.sum()) * int(tmask.sum()))
            rows.append(row)
            print(f"field {stat} {row['shape']} ({label}): device old {row['old_ms']:.4f} ms (rotation, per-point "
                  f"kernel, row reduction), new {row['new_ms']:.4f} ms (field_order and one launch; "
                  f"{row['old_ms'] / row['new_ms']:.2f}x; turns {row['turns_ms']}); kernels alone old "
                  f"{row['old_kernel_ms']:.4f} ms, new {row['new_kernel_ms']:.4f} ms (field_order {row['order_ms']:.4f} ms); "
                  f"{row['scanned_share']:.4f} of the pairs scanned; same bits {same}", flush=True)
    return rows


def ab_nn1(old, dev, rng, reps: int) -> list:
    rows = []
    sms = sm_count(dev.index)
    for lanes, q_n, r_n, groups, valid, label in NN1_SHAPES:
        query, ref, mask, lane_ref = nn1_inputs(rng, dev, lanes, q_n, r_n, groups, valid)
        run_old, run_new, outs = nn1_calls(old, query, ref, mask, lane_ref)
        run_old()
        run_new()
        wrapped = nn1(query, ref, mask, lane_ref)
        torch.cuda.synchronize()
        same = all(torch.equal(o, n) and torch.equal(o, w) for o, n, w in zip(outs[0], outs[1], wrapped))
        n = nn1_reps(reps, lanes, q_n, r_n)
        row = dict(in_turns(run_old, run_new, n), shape=f"{lanes}x{q_n}x{r_n}", groups=groups, label=label,
                   same_bits=same, reps=n, plan=nn1_plan(lanes, q_n, r_n, sms)._asdict(),
                   old_plan=old_nn1_plan(lanes, q_n, r_n, sms)._asdict())
        row["wrapper_ms"] = time_ms(lambda: nn1(query, ref, mask, lane_ref), n)
        rows.append(row)
        print(f"nn1 {row['shape']} G={groups} ({label}): device old {row['old_ms']:.4f} ms, new {row['new_ms']:.4f} "
              f"ms ({row['old_ms'] / row['new_ms']:.3f}x; turns {row['turns_ms']}); new wrapper back to back "
              f"{row['wrapper_ms']:.4f} ms; same bits {same}, plan {tuple(row['plan'].values())}, old plan "
              f"{tuple(row['old_plan'].values())}", flush=True)
    return rows


def ab_fps(old, dev, rng, reps: int) -> list:
    rows = []
    for b_n, p_n, s, steps, label in FPS_SHAPES:
        pts = torch.as_tensor(np.stack([cloud(rng, p_n) for _ in range(b_n)]), device=dev)
        mask = torch.ones((b_n, p_n), dtype=torch.bool, device=dev)
        mask[:, p_n - p_n // 40:] = False
        run_old, run_new, outs = fps_calls(old, pts, mask, s, steps)
        run_old()
        run_new(s)
        i_full = outs[1].clone()
        run_new()
        i_new, _ = fps(pts, mask, s, steps)
        torch.cuda.synchronize()
        same = bool(torch.equal(outs[0][:, :steps], i_full[:, :steps]) and torch.equal(outs[1], i_new)
                    and torch.equal(outs[0][:, :steps], i_new[:, :steps]) and not i_new[:, steps:].any())
        n = max(3, reps // 5) if p_n <= 8192 else max(3, reps // 10)
        plan = fps_plan(b_n, p_n, sm_count(dev.index))
        row = dict(in_turns(run_old, run_new, n), shape=f"{b_n}x{p_n}->{s}", steps=steps, label=label,
                   same_bits=same, reps=n, plan=plan._asdict(), old_plan=old_fps_plan(p_n))
        # All S picks in both, to split the kernel's gain from the steps cut's.
        row["new_all_steps_ms"] = graph_ms(lambda: run_new(s), n)
        row["us_per_step"] = row["new_all_steps_ms"] * 1e3 / s
        row["old_us_per_step"] = row["old_ms"] * 1e3 / steps
        row["floor_ms"] = fps_floor_ms(dev, b_n, s, steps, plan, n)
        row["wrapper_ms"] = time_ms(lambda: fps(pts, mask, s, steps), n)
        rows.append(row)
        print(f"fps {row['shape']} steps {steps} ({label}): device old {row['old_ms']:.4f} ms, new "
              f"{row['new_ms']:.4f} ms ({row['old_ms'] / row['new_ms']:.2f}x; turns {row['turns_ms']}); empty "
              f"steps {row['floor_ms']:.4f} ms; all {s} steps {row['new_all_steps_ms']:.4f} ms "
              f"({row['us_per_step']:.3f} us a step, old {row['old_us_per_step']:.3f}); new wrapper "
              f"{row['wrapper_ms']:.4f} ms; same bits {same}, plan {tuple(plan)}, old plan {row['old_plan']}",
              flush=True)
    return rows


_SASS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);")


def inner_loop_mix(func: str) -> dict:
    """The instructions a (query, row) pair of a kernel's scan: of the
    innermost loops (a backward branch with no other inside its span), the
    one with the most FMULs, whose pairs are its FMULs over 3; its
    instructions (NOPs left out) over its pairs, in all and by opcode."""
    ins = []
    for m in _SASS.finditer(func):
        words = m.group(2).split()
        if words and words[0].startswith("@"):
            words = words[1:]
        if words:
            ins.append((int(m.group(1), 16), words[0], m.group(2)))
    loops = []
    for addr, op, text in ins:
        target = re.search(r"0x([0-9a-f]+)", text) if op.startswith("BRA") else None
        if target and int(target.group(1), 16) <= addr:
            loops.append((int(target.group(1), 16), addr))
    inner = [(a, z) for a, z in loops if not any(a <= a2 and z2 <= z and (a2, z2) != (a, z) for a2, z2 in loops)]
    best = None
    for a, z in inner:
        body = [op for addr, op, _ in ins if a <= addr <= z and not op.startswith("NOP")]
        fmul = sum(op.split(".")[0] == "FMUL" for op in body)
        if fmul and (best is None or fmul > best[0]):
            best = (fmul, body)
    if best is None:
        return {}
    pairs = best[0] / 3
    mix = {}
    for op in best[1]:
        mix[op.split(".")[0]] = mix.get(op.split(".")[0], 0) + 1
    return {"pairs_a_pass": pairs, "instructions_a_pair": len(best[1]) / pairs,
            "by_opcode": {k: v / pairs for k, v in sorted(mix.items(), key=lambda kv: -kv[1])}}


def nn1_loop_mixes(sass: str) -> dict:
    """{nn1 kernel instantiation (its mangled name): inner_loop_mix}."""
    return {func.split()[0]: inner_loop_mix(func) for func in sass.split("Function : ")[1:]
            if "nn1_kernel" in func.split()[0]}


def sass_of(path: Path) -> str:
    out = subprocess.run([str(Path(_build.find_nvcc()).parent / "cuobjdump"), "-sass", str(path)],
                         capture_output=True, text=True, timeout=300)
    return out.stdout + out.stderr


def dot_tensor_instructions(sass: str) -> dict:
    """{field_dot instantiation ("highest" or "default"): its HMMA
    instructions} from the SASS."""
    return {("default" if "ILi1EE" in func.split()[0] else "highest"): len(re.findall(r"\bHMMA\.", func))
            for func in sass.split("Function : ")[1:] if "field_dot_kernel" in func.split()[0]}


def ab_field(old, name, dev, rng, reps: int) -> list:
    """Old and new fields at FIELD_SHAPES: the fields, then device times in
    turns (the whole call each, as the main path pays it) and each kernel
    alone."""
    rows = []
    for steps, n, valid, label, parts in FIELD_SHAPES:
        args = field_inputs(rng, dev, steps, n, valid, parts)
        c_n = args[4].shape[0]
        for precision in [p for k, p in FIELD_VARIANTS if k == name and (parts == 1 or k == "field_ave")]:
            run_old, old_kernel, sums = old_field_calls(old, name, precision, args)
            run_new, new_kernel = new_field_calls(name, precision, args)
            f_old, f_new = run_old(), run_new()
            torch.cuda.synchronize()
            plain = cc.field_ave_plain(*args) if name == "field_ave" else cc.field_dot_plain(*args, precision)
            same = bool(torch.allclose(f_old, f_new, rtol=2e-5, atol=0.0) and torch.equal(f_new, run_new())
                        and (torch.equal(f_new, plain) if name == "field_ave" else
                             torch.allclose(f_new, plain, rtol=2e-5, atol=0.0)))
            m = max(3, reps // 2)
            row = dict(in_turns(run_old, run_new, m), shape=f"{c_n}x{n}x{n}", valid=valid, label=label,
                       precision=precision, same_bits=same, reps=m,
                       max_rel_old_new=float(((f_old - f_new).abs() / f_old.abs().clamp_min(1e-30)).max()))
            row["old_kernel_ms"] = graph_ms(old_kernel, m)
            row["new_kernel_ms"] = graph_ms(new_kernel, m)
            row["wrapper_ms"] = time_ms(run_new, m)
            if name == "field_dot":
                row["plan"] = dot_plan(c_n, n, n, precision, sm_count(dev.index))._asdict()
            rows.append(row)
            print(f"{name}{'' if precision is None else ' ' + precision} {row['shape']} ({label}): device old "
                  f"{row['old_ms']:.4f} ms (the rotation pass, the old kernel, the division), new {row['new_ms']:.4f} "
                  f"ms ({row['old_ms'] / row['new_ms']:.2f}x; turns {row['turns_ms']}); kernels alone old "
                  f"{row['old_kernel_ms']:.4f} ms, new {row['new_kernel_ms']:.4f} ms; new wrapper "
                  f"{row['wrapper_ms']:.4f} ms back to back; old and new within rtol 2e-5, the new one "
                  f"{'the plain bits' if name == 'field_ave' else 'within rtol 2e-5 of plain'}: {same} (old/new "
                  f"{row['max_rel_old_new']:.3g} relative)", flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="directory of older kernel sources: nn.cu, fps.cu, field.cu and field_dot.cu (with their "
                         "field_kernel.cuh), field_trim.cu (with its own), any of them")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--sass", action="store_true", help="write the new library's SASS to --out")
    ap.add_argument("--out", type=Path, default=REPO / "_scratch" / "kernel_ab", help="directory for the files")
    ap.add_argument("--sweep", action="store_true", help="also time every launch plan at the main path's shapes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_ab: needs a CUDA card", file=sys.stderr)
        return 1
    card = smi("name,power.limit")
    clock = smi("clocks.max.sm")
    print(card, f"max SM clock {clock}", flush=True)
    dev = torch.device("cuda", 0)
    old, present, old_path = load_old(args.old)
    path, nvcc_out, seconds = _build.build()
    print(f"new library {path.name} built in {seconds:.2f} s", flush=True)
    for line in nvcc_out.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print("  " + line.strip(), flush=True)
    out_dir = args.out
    out_dir.mkdir(parents=True, exist_ok=True)
    mixes = {}
    if args.sass:
        sass = sass_of(path)
        (out_dir / "torch_kernels.sass").write_text(sass)
        print(f"field_dot's tensor-core instructions: {dot_tensor_instructions(sass)}", flush=True)
        mixes = {"new": nn1_loop_mixes(sass)}
        if "nn.cu" in present:
            mixes["old"] = nn1_loop_mixes(sass_of(old_path))
        for side, kernels in mixes.items():
            for name, mix in kernels.items():
                print(f"nn1 inner loop, {side} {name}: {mix.get('instructions_a_pair', float('nan')):.3f} "
                      f"instructions a pair ({mix.get('pairs_a_pass')} pairs a pass): {mix.get('by_opcode')}",
                      flush=True)
    rng = np.random.default_rng(0)
    result = {"card": card, "nn1_inner_loop": mixes, "nn1": [], "fps": [], "field_ave": [], "field_dot": [], "field_trim": []}
    if "nn.cu" in present:
        result["nn1"] = ab_nn1(old, dev, rng, args.reps)
    if "fps.cu" in present:
        result["fps"] = ab_fps(old, dev, rng, args.reps)
    for src, name in (("field.cu", "field_ave"), ("field_dot.cu", "field_dot")):
        if src in present:
            result[name] = ab_field(old, name, dev, rng, args.reps)
    if "field_trim.cu" in present:
        result["field_trim"] = ab_cull(old, dev, rng, args.reps)

    if args.sweep:
        (out_dir / "torch_kernel_sweep.json").write_text(json.dumps(sweep(dev, args.reps), indent=1))
    ok = all(r["same_bits"] for k in ("nn1", "fps", "field_ave", "field_dot", "field_trim") for r in result[k])
    result["ok"] = ok
    (out_dir / "torch_kernel_ab.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
