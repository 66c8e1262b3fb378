"""Wrapper of the `fps` CUDA kernel (csrc/fps.cu): batched farthest-point sampling.

Ports kss_icp_tpu/ops/resample_pallas.py::fps_batch_pallas (K2). On CPU
tensors the wrapper runs the plain version,
ops/resample.py::farthest_point_sampling; on CUDA tensors it launches the
kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from kss_icp_torch.ops.resample import farthest_point_sampling, fps_centroid, sample_mask

MAX_POINTS = 65536


def fps(points: torch.Tensor, mask: torch.Tensor, num_samples: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """FPS of (B, P, 3) float32 clouds with (B, P) bool masks.

    Returns (indices (B, S) int32, sample_mask (B, S) bool), index for index
    the plain version's. Clouds wider than 65536 points raise on CUDA."""
    if points.dim() != 3 or points.shape[-1] != 3 or mask.shape != points.shape[:2]:
        raise ValueError(f"expected points (B, P, 3) and mask (B, P), got {tuple(points.shape)}, {tuple(mask.shape)}")
    if num_samples < 1:
        raise ValueError(f"num_samples must be >= 1, got {num_samples}")
    if points.device.type == "cpu":
        return farthest_point_sampling(points, mask, num_samples)
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
    centroid = fps_centroid(points, mask).contiguous()
    idx = torch.empty((batch, num_samples), dtype=torch.int32, device=points.device)
    work = torch.empty((batch, p_n, 4), dtype=torch.float32, device=points.device)
    from kss_icp_torch import _build

    lib = _build.library()
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.kss_fps(points.data_ptr(), mask.data_ptr(), centroid.data_ptr(), batch, p_n,
                           num_samples, work.data_ptr(), idx.data_ptr(), stream)
    _build.check(code, "fps")
    fps.launches += 1
    return idx, sample_mask(mask, num_samples)


fps.launches = 0
