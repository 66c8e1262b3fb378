"""Wrapper of the `fps` CUDA kernel (csrc/fps.cu): batched farthest-point sampling.

Ports kss_icp_tpu/ops/resample_pallas.py::fps_batch_pallas (K2). On CPU
tensors the wrapper runs the plain version,
ops/resample.py::farthest_point_sampling; on CUDA tensors it launches the
kernel or raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from kss_icp_torch.ops.nn_cuda import SMS, sm_count
from kss_icp_torch.ops.resample import check_steps, farthest_point_sampling, fps_centroid, sample_mask

# Points a cloud: the large-scan path's compacted octree survivors pad to
# 135168-151552 (kss_icp_torch/largescan.py); 2^18 leaves room for other
# seeds, and is 16 blocks of SHARED_SLICE points.
MAX_POINTS = 1 << 18
# A block's slice of a cloud (csrc/fps.cu). In registers: x, y, z and the
# score of 1, 2, 4, 8 or 16 points a thread, at most 512 threads (16 points
# fill the 128 registers a thread has there), so up to 8192 points. At the
# remesh clouds (3072 and 8192 points) 384 x 8 and 512 x 16 measured faster
# than 768 x 4 and 1024 x 8 (PERF.md). Wider slices keep x, y, z in shared
# memory (12 B a point) and 32 scores a thread in registers, at 512 threads
# (the kernel's constant stride): up to 16384 points, 192 KB.
MAX_THREADS = 512
REGISTER_POINTS = (1, 2, 4, 8, 16)
REGISTER_SLICE = REGISTER_POINTS[-1] * MAX_THREADS
SHARED_THREADS = MAX_THREADS
SHARED_K = 32
SHARED_SLICE = SHARED_K * SHARED_THREADS
# Blocks a cloud: one block, or a thread-block cluster of 2-16 (16 is the
# most an H100 schedules, with the non-portable cluster size).
CLUSTERS = (1, 2, 4, 8, 16)
# A cluster's exchange costs about 0.3 us a step more than one block's pick,
# which smaller slices win back only above some 5000 points a cloud (PERF.md):
# clouds of up to CLUSTER_POINTS points run one block a cloud, and so does a
# cloud of up to 8192 points whose batch leaves room for a cluster of fewer
# than MIN_CLUSTER blocks. Wider clouds split over the widest cluster the
# card fits: B x C <= SMs, C <= 16, slices of at least MIN_SLICE points.
CLUSTER_POINTS = 6144
MIN_CLUSTER = 4
MIN_SLICE = 512
# A cluster's block holds its slice in registers at 4 or more points a thread
# and at most CLUSTER_THREADS threads where it can: with fewer warps its pick
# costs less (512-point slices: 4 x 128 beat 1 x 512 by 12%; 2560: 8 x 320
# beat 16 x 160 by 6%; PERF.md).
CLUSTER_MIN_POINTS = 4
CLUSTER_THREADS = 320


class FPSPlan(NamedTuple):
    cluster: int     # blocks a cloud; block rank r holds points [r * slice, (r + 1) * slice)
    slice: int       # points a block holds; cluster * slice >= P
    k: int           # points (registers) or scores (shared memory) a thread
    threads: int     # threads a block
    registers: bool  # x, y, z in registers; else in shared memory


def block_plan(p_n: int, cluster: int) -> FPSPlan:
    """The plan of `fps` for clouds of P points over `cluster` blocks: each
    block's slice in registers at the fewest points a thread that keeps it
    within 512 threads, rounded up to whole warps (for a cluster, at least
    CLUSTER_MIN_POINTS points a thread, within CLUSTER_THREADS threads where
    16 points a thread allow it), or, above 8192 points, in shared memory at
    32 scores a thread and 512 threads. Raises if the slice fits neither."""
    slice_n = -(-p_n // cluster)
    caps = (MAX_THREADS,) if cluster == 1 else (CLUSTER_THREADS, MAX_THREADS)
    points = [k for k in REGISTER_POINTS if cluster == 1 or k >= CLUSTER_MIN_POINTS]
    for cap in caps:
        for k in points:
            if slice_n <= k * cap:
                return FPSPlan(cluster, slice_n, k, 32 * -(-slice_n // (32 * k)), True)
    if slice_n <= SHARED_SLICE:
        return FPSPlan(cluster, slice_n, SHARED_K, SHARED_THREADS, False)
    raise ValueError(f"fps: {p_n} points over {cluster} blocks leave {slice_n} a block, more than {SHARED_SLICE}")


@functools.lru_cache(maxsize=256)
def fps_plan(batch: int, p_n: int, sms: int = SMS) -> FPSPlan:
    """The launch plan of `fps` for B clouds of P points on a card of `sms`
    streaming multiprocessors: the smallest cluster whose slices fit a block
    (one block up to 8192 points), doubled while the B clusters still fit
    the SMs (B x 2C <= sms), the slices keep MIN_SLICE points and the
    cluster stays within 16; one block a cloud up to CLUSTER_POINTS points,
    and up to 8192 where that cluster would be narrower than MIN_CLUSTER."""
    cluster = 1 if p_n <= REGISTER_SLICE else next(c for c in CLUSTERS[1:] if -(-p_n // c) <= SHARED_SLICE)
    fits = cluster
    while cluster < CLUSTERS[-1] and batch * 2 * cluster <= sms and -(-p_n // (2 * cluster)) >= MIN_SLICE:
        cluster *= 2
    if fits == 1 and (p_n <= CLUSTER_POINTS or cluster < MIN_CLUSTER):
        cluster = 1
    return block_plan(p_n, cluster)


def empty_step_plan(plan: FPSPlan) -> FPSPlan:
    """`plan`'s cluster and threads with one point a block (clouds of
    `plan.cluster` points) and one point a thread: what a step costs with
    (almost) no local update, its reductions and barriers. Steps times its
    time is the floor of a run at `plan`'s shape (PERF.md)."""
    return plan._replace(slice=1, k=1 if plan.registers else SHARED_K)


def fps(points: torch.Tensor, mask: torch.Tensor, num_samples: int, steps: Optional[int] = None, *,
        plan: Optional[FPSPlan] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """FPS of (B, P, 3) float32 clouds with (B, P) bool masks.

    Makes the first `steps` picks (default num_samples) of S = num_samples.
    Returns (indices (B, S) int32, sample_mask (B, S) bool), index for index
    the plain version's. On CUDA the kernel runs `plan` (default
    fps_plan(B, P, the card's SMs)); clouds wider than MAX_POINTS, and a
    cluster the card cannot schedule, raise."""
    if points.dim() != 3 or points.shape[-1] != 3 or mask.shape != points.shape[:2]:
        raise ValueError(f"expected points (B, P, 3) and mask (B, P), got {tuple(points.shape)}, {tuple(mask.shape)}")
    steps = check_steps(num_samples, steps)
    if points.device.type == "cpu":
        return farthest_point_sampling(points, mask, num_samples, steps)
    if points.device.type != "cuda":
        raise ValueError(f"fps runs on cpu or cuda tensors, not {points.device}")
    batch, p_n = mask.shape
    if points.dtype != torch.float32 or mask.dtype != torch.bool:
        raise TypeError(f"fps needs float32 points and a bool mask, got {points.dtype}, {mask.dtype}")
    if not (points.is_contiguous() and mask.is_contiguous()):
        raise ValueError("fps needs contiguous points and mask")
    if mask.device != points.device:
        raise ValueError(f"fps inputs on different devices: {points.device} and {mask.device}")
    if not 1 <= p_n <= MAX_POINTS:
        raise ValueError(f"fps holds 1..{MAX_POINTS} points per cloud, got {p_n}")
    plan = plan or fps_plan(batch, p_n, sm_count(points.device.index))
    centroid = fps_centroid(points, mask).contiguous()
    idx = torch.empty((batch, num_samples), dtype=torch.int32, device=points.device)
    from kss_icp_torch import _build

    lib = _build.library()
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.kss_fps(points.data_ptr(), mask.data_ptr(), centroid.data_ptr(), batch, p_n, num_samples,
                           steps, plan.cluster, plan.slice, plan.k, plan.threads, int(plan.registers),
                           idx.data_ptr(), stream)
    _build.check(code, "fps")
    fps.launches += 1
    return idx, sample_mask(mask, num_samples, steps)


fps.launches = 0
