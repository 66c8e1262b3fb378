"""Plain PyTorch farthest-point sampling (port of kss_icp_tpu/ops/resample.py).

The CPU path of the `fps` wrapper and the reference of its CUDA kernel
(ops/resample_cuda.py, csrc/fps.cu). Squared distances are summed in the
kernel's order, (dx² + dy²) + dz², so index sequences agree exactly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def sqdist3(points: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """((dx² + dy²) + dz²) between (..., N, 3) points and (..., 3) points."""
    dx = points[..., 0] - p[..., None, 0]
    dy = points[..., 1] - p[..., None, 1]
    dz = points[..., 2] - p[..., None, 2]
    return dx * dx + dy * dy + dz * dz


def fps_centroid(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked centroid of (..., N, 3) points — the FPS seed's reference point."""
    w = mask.to(points.dtype)
    return (points * w[..., None]).sum(dim=-2) / w.sum(dim=-1).clamp_min(1.0)[..., None]


def sample_mask(mask: torch.Tensor, num_samples: int, steps: int) -> torch.Tensor:
    """(..., S) validity of the samples: arange(S) < min(count, steps)."""
    count = mask.to(torch.float32).sum(dim=-1)
    s = torch.arange(num_samples, device=mask.device)
    return s < count.clamp_max(steps)[..., None]


def check_steps(num_samples: int, steps: Optional[int]) -> int:
    """The number of picks to make: `steps`, default num_samples, in [0, S]."""
    if num_samples < 1:
        raise ValueError(f"num_samples must be >= 1, got {num_samples}")
    if steps is None:
        return num_samples
    if not 0 <= steps <= num_samples:
        raise ValueError(f"steps must lie in [0, {num_samples}], got {steps}")
    return steps


def farthest_point_sampling(points: torch.Tensor, mask: torch.Tensor, num_samples: int,
                            steps: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy FPS over the valid points of (B, P, 3) clouds.

    Returns (indices (B, S) int32, sample_mask (B, S) bool). The first sample
    is the valid point farthest from the masked centroid; each next one has
    the largest squared distance to the samples so far (first index on
    ties); invalid points score -1 and are picked only once no valid point
    is left. Only the first `steps` picks are made (default S): picks are
    prefix-stable, the later slots hold index 0 and are masked off."""
    steps = check_steps(num_samples, steps)
    batch, p_n = mask.shape
    neg = torch.tensor(-1.0, dtype=points.dtype, device=points.device)
    score = torch.where(mask, sqdist3(points, fps_centroid(points, mask)), neg)
    rows = torch.arange(batch, device=points.device)
    idx = torch.zeros((batch, num_samples), dtype=torch.int64, device=points.device)
    for s in range(steps):
        sel = torch.argmax(score, dim=-1)
        idx[:, s] = sel
        d2 = torch.where(mask, sqdist3(points, points[rows, sel]), neg)
        score = d2 if s == 0 else torch.minimum(score, d2)
    return idx.to(torch.int32), sample_mask(mask, num_samples, steps)
