"""Plain PyTorch farthest-point sampling and the voxel downsample (port of
kss_icp_tpu/ops/resample.py).

`farthest_point_sampling` is the CPU path of the `fps` wrapper and the
reference of its CUDA kernel (ops/resample_cuda.py, csrc/fps.cu). Squared
distances round as XLA's CPU backend rounds them inside JAX's jitted
farthest_point_sampling, fma(dz, dz, fma(dy, dy, dx²)), and as the kernel
does: on a 40960-point cloud a near-tie at step 3530 picks otherwise when
the squares are rounded one by one (tests/test_torch_wlop.py).

`voxel_downsample` keeps, per occupied voxel, the real point nearest the
voxel centre (Method_Octree.hpp:20-108): a sort by (voxel key, distance to
the centre), the first point of each key run surviving. It gives JAX's
survivors bit for bit on the CPU and on the card, which takes two details:

  - JAX's `jnp.lexsort((d2c, k2, k1, k0))` becomes four stable sorts, by d2c
    and then by k2, k1 and k0. `lax.sort` is not stable, so points of one
    voxel at equal d2c (duplicates) may survive otherwise in JAX;
  - XLA's CPU backend contracts a multiply feeding an add into one fused
    multiply-add, and so the voxel centre, lo + (ijk + 0.5) * cell, and the
    sum of squares d2c round once where eager torch ops round twice.
    `fma32` rounds them as XLA does.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

BIG = 1e30
VOXEL_CLIP = 2_000_000    # voxel indices are clipped to [0, VOXEL_CLIP]
VOXEL_PAD_KEY = 2_100_000  # the key of padding rows: past the clip, so they sort last


def sqdist3(points: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """fma(dz, dz, fma(dy, dy, dx²)) between (..., N, 3) points and (..., 3)
    points (float32), or the sum of squares in another dtype."""
    dx = points[..., 0] - p[..., None, 0]
    dy = points[..., 1] - p[..., None, 1]
    dz = points[..., 2] - p[..., None, 2]
    if points.dtype != torch.float32:
        return dx * dx + dy * dy + dz * dz
    return fma32(dz, dz, fma32(dy, dy, dx * dx))


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


def fps_points(points: torch.Tensor, mask: torch.Tensor, num_samples: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """FPS of one padded (P, 3) cloud returning the gathered (num_samples, 3)
    points, zero in the masked slots, and their (num_samples,) mask
    (kss_icp_tpu/ops/resample.py:70-75): one launch of the `fps` kernel on a
    CUDA tensor, the plain loop above on a CPU one."""
    from kss_icp_torch.ops.resample_cuda import fps  # that module imports this one

    idx, smask = fps(points[None].contiguous(), mask[None].contiguous(), num_samples)
    return points[idx[0].long()] * smask[0, :, None].to(points.dtype), smask[0]


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c of float32 tensors, rounded to float32 once, as a fused
    multiply-add rounds it. The float64 product of two float32 values is
    exact; the float64 sum rounds before the float32 rounding, which can
    differ from one rounding only when the float64 sum lands on a float32
    midpoint (a chance near 2^-29 a value)."""
    return (a.double() * b.double() + c.double()).float()


def voxel_downsample(points: torch.Tensor, mask: torch.Tensor,
                     cell_size: Union[float, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep, per occupied voxel of edge `cell_size`, the valid point of (P, 3)
    `points` nearest the voxel centre (kss_icp_tpu/ops/resample.py:78-113).

    Returns (points, keep) of the input's padded shape: the points sorted by
    (voxel key, distance to the centre), survivors marked in `keep` and every
    other row zeroed."""
    dtype = points.dtype
    lo = torch.where(mask[:, None], points, BIG).amin(dim=0)
    cell = torch.as_tensor(cell_size, dtype=dtype, device=points.device).clamp_min(torch.finfo(dtype).tiny)
    ijk = torch.floor((points - lo) / cell).to(torch.int32).clamp(0, VOXEL_CLIP)
    center = fma32(ijk.to(dtype) + 0.5, cell, lo)
    d = points - center
    d2c = fma32(d[:, 2], d[:, 2], fma32(d[:, 1], d[:, 1], d[:, 0] * d[:, 0]))  # XLA's reduction of the squares
    key = torch.where(mask[:, None], ijk, VOXEL_PAD_KEY)
    order = torch.argsort(d2c, stable=True)
    for col in (2, 1, 0):
        order = order[torch.argsort(key[order, col], stable=True)]
    k_sorted = key[order]
    is_first = torch.ones_like(mask)
    is_first[1:] = (k_sorted[1:] != k_sorted[:-1]).any(dim=-1)
    keep = is_first & mask[order]
    return points[order] * keep[:, None].to(dtype), keep
