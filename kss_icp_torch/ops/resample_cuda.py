"""Wrapper of the `fps` CUDA kernel (csrc/fps.cu): batched farthest-point sampling.

Ports kss_icp_tpu/ops/resample_pallas.py::fps_batch_pallas (K2). On CPU
tensors the wrapper runs the plain version,
ops/resample.py::farthest_point_sampling; on CUDA tensors it launches the
kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from kss_icp_torch.ops.resample import check_steps, farthest_point_sampling, fps_centroid, sample_mask

MAX_POINTS = 65536
# Threads a block, and points a thread keeps in registers: 16 points (x, y,
# z, score) fit the 128 registers a thread has at 512 threads, so clouds up
# to 8192 points stay in registers. At the remesh clouds (3072 and 8192
# points) 384 x 8 and 512 x 16 measured faster than 768 x 4 and 1024 x 8
# (PERF.md).
MAX_THREADS = 512
REGISTER_POINTS = (1, 2, 4, 8, 16)


class FPSPlan(NamedTuple):
    k: int        # points a thread in registers; 0: float4 points in shared or global memory
    threads: int  # threads a block (one block a cloud)


def fps_plan(p_n: int) -> FPSPlan:
    """The launch plan of `fps` for clouds of P points: the fewest points a
    thread that keeps the block within 512 threads, rounded up to whole
    warps; above 8192 points the shared/global-memory path at 512 threads."""
    for k in REGISTER_POINTS:
        if p_n <= k * MAX_THREADS:
            return FPSPlan(k, 32 * -(-p_n // (32 * k)))
    return FPSPlan(0, MAX_THREADS)


def fps(points: torch.Tensor, mask: torch.Tensor, num_samples: int,
        steps: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """FPS of (B, P, 3) float32 clouds with (B, P) bool masks.

    Makes the first `steps` picks (default num_samples) of S = num_samples.
    Returns (indices (B, S) int32, sample_mask (B, S) bool), index for index
    the plain version's. Clouds wider than 65536 points raise on CUDA."""
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
    plan = fps_plan(p_n)
    centroid = fps_centroid(points, mask).contiguous()
    idx = torch.empty((batch, num_samples), dtype=torch.int32, device=points.device)
    work = torch.empty((batch, p_n, 4) if plan.k == 0 else (1,), dtype=torch.float32, device=points.device)
    from kss_icp_torch import _build

    lib = _build.library()
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.kss_fps(points.data_ptr(), mask.data_ptr(), centroid.data_ptr(), batch, p_n, num_samples,
                           steps, plan.k, plan.threads, work.data_ptr(), idx.data_ptr(), stream)
    _build.check(code, "fps")
    fps.launches += 1
    return idx, sample_mask(mask, num_samples, steps)


fps.launches = 0
