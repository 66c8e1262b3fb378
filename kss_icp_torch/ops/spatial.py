"""Voxel-grid spatial index (port of kss_icp_tpu/ops/spatial.py).

The reference's BallRegion (ballRegionCompute.hpp) as dense tensors: a box
id per point, per-box counts and the valid point nearest each box centre by
segment reductions, the kNN cache, the 8-colour schedule and the 27-box
stencil. Every function takes one cloud (P, 3)/(P,) or a batch of clouds
with leading axes; the segment reductions of a batch offset each cloud's box
ids, so one set of launches serves every cloud.

The grid follows the rounding of JAX's jitted `build_voxel_grid` on the
CPU (tests/test_torch_aivs.py): XLA multiplies the extent by the float32
reciprocal of boxes_per_axis instead of dividing, and contracts the box
centres and the squared distances to them into fused multiply-adds
(`fma32`).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from kss_icp_torch.ops.nn import BIG, knn, knn_kth_sqdist
from kss_icp_torch.ops.resample import fma32


def estimate_box_scale(point_count: int) -> int:
    """Boxes-per-axis ladder (ballRegionCompute.hpp:1194-1214)."""
    if point_count < 10_000:
        return 10
    if point_count < 50_000:
        return 20
    if point_count < 100_000:
        return 30
    if point_count < 500_000:
        return 40
    if point_count < 1_000_000:
        return 50
    return int(round((point_count / 8.0) ** (1.0 / 3.0)))


class VoxelGrid(NamedTuple):
    """Dense BallRegion state, B = boxes_per_axis**3 boxes; each field gains
    the clouds' leading axes."""

    box_id: torch.Tensor        # (P,) int32 flat box index per point (-1 on padding)
    counts: torch.Tensor        # (B,) int32 valid points per box
    centers: torch.Tensor       # (B, 3) geometric box centres
    center_point: torch.Tensor  # (B,) int32 index of the valid point nearest the centre (P if empty)
    occupied: torch.Tensor      # (B,) bool
    lo: torch.Tensor            # (3,) grid origin (AABB min)
    unit: torch.Tensor          # (3,) per-axis box edge length

    @property
    def num_boxes(self) -> int:
        return self.counts.shape[-1]


def sq_norm_fma(d: torch.Tensor) -> torch.Tensor:
    """(x² + y²) + z² of the last axis as XLA's CPU backend reduces the squares
    inside a jitted function: fma(z, z, fma(y, y, x²))."""
    return fma32(d[..., 2], d[..., 2], fma32(d[..., 1], d[..., 1], d[..., 0] * d[..., 0]))


def segment_ids(seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Flat ids of (..., P) per-cloud segment ids in [0, num_segments): cloud
    c's ids offset by c * num_segments, so the clouds share one reduction."""
    lead = seg.shape[:-1].numel()
    offset = torch.arange(lead, device=seg.device).view(seg.shape[:-1] + (1,)) * num_segments
    return (seg.long() + offset).reshape(-1)


def segment_reduce(values: torch.Tensor, gseg: torch.Tensor, total: int, op: str, init) -> torch.Tensor:
    """Reduce (N, ...) values into `total` segments by flat ids gseg (N,):
    op "sum" adds in index order (index_put_ with accumulate, which runs as a
    stable sort with sequential sums on CUDA, and serially on the CPU in
    deterministic mode, so the bits are XLA's and do not change from run to
    run); "amax" and "amin" do not depend on the order. Untouched segments
    keep `init`."""
    out = torch.full((total,) + values.shape[1:], init, dtype=values.dtype, device=values.device)
    if op == "sum":
        if values.device.type != "cpu" or torch.are_deterministic_algorithms_enabled():
            return out.index_put_((gseg,), values, accumulate=True)
        # Outside deterministic mode the CPU adds float32 rows of 32768 or more
        # elements with atomic adds across its threads, in no fixed order.
        torch.use_deterministic_algorithms(True)
        try:
            return out.index_put_((gseg,), values, accumulate=True)
        finally:
            torch.use_deterministic_algorithms(False)
    idx = gseg.view((-1,) + (1,) * (values.dim() - 1)).expand(values.shape)
    return out.scatter_reduce_(0, idx, values, op, include_self=True)


def build_voxel_grid(points: torch.Tensor, mask: torch.Tensor, boxes_per_axis: int) -> VoxelGrid:
    """Scatter padded clouds (..., P, 3)/(..., P) into boxes_per_axis³ grids
    over their AABBs (kss_icp_tpu/ops/spatial.py:74-130; BallRegion_AchieveXYZ
    + BallRegion_BoxInput)."""
    dtype, device = points.dtype, points.device
    lead, p = mask.shape[:-1], mask.shape[-1]
    nb = boxes_per_axis
    b = nb ** 3
    m3 = mask[..., None]
    lo = torch.where(m3, points, torch.full_like(points, BIG)).amin(dim=-2)
    hi = torch.where(m3, points, torch.full_like(points, -BIG)).amax(dim=-2)
    extent = (hi - lo).clamp_min(torch.finfo(dtype).eps)
    unit = extent * (torch.tensor(1.0, dtype=dtype) / nb)  # XLA: x / nb -> x * (1 / nb)

    cell = torch.floor((points - lo[..., None, :]) / unit[..., None, :])
    ijk = cell.clamp(0, nb - 1).to(torch.int32)  # valid points lie in [0, nb]; clamped before the cast
    flat = (ijk[..., 0] * nb + ijk[..., 1]) * nb + ijk[..., 2]
    box_id = torch.where(mask, flat, torch.full_like(flat, -1))
    gseg = segment_ids(torch.where(mask, flat, torch.full_like(flat, b)), b + 1)
    total = lead.numel() * (b + 1)

    counts = segment_reduce(mask.reshape(-1).to(torch.int32), gseg, total, "sum", 0).view(lead + (b + 1,))[..., :b]

    axes = torch.arange(nb, dtype=dtype, device=device) + 0.5
    c = [fma32(axes, unit[..., k, None], lo[..., k, None]) for k in range(3)]  # (..., nb) each
    centers = torch.stack(torch.broadcast_tensors(c[0][..., :, None, None], c[1][..., None, :, None],
                                                  c[2][..., None, None, :]), dim=-1).reshape(lead + (b, 3))

    # The valid point nearest each box's centre (squareBoxesCReal).
    my_center = fma32(ijk.to(dtype) + 0.5, unit[..., None, :], lo[..., None, :])
    d2c = torch.where(mask, sq_norm_fma(points - my_center), torch.full_like(points[..., 0], BIG))
    best = segment_reduce(d2c.reshape(-1), gseg, total, "amin", float("inf")).view(lead + (b + 1,))
    flat_c = flat.clamp(0, b - 1).long()
    is_best = mask & (d2c <= torch.take_along_dim(best, flat_c, dim=-1))
    idx = torch.arange(p, dtype=torch.int32, device=device).expand(mask.shape)
    center_point = segment_reduce(torch.where(is_best, idx, torch.full_like(idx, p)).reshape(-1), gseg, total,
                                  "amin", p).view(lead + (b + 1,))[..., :b]
    return VoxelGrid(box_id=box_id, counts=counts, centers=centers, center_point=center_point,
                     occupied=counts > 0, lo=lo, unit=unit)


def estimate_radius(points: torch.Tensor, mask: torch.Tensor, k: int = 12) -> torch.Tensor:
    """Global support radius: the largest k-NN distance over the valid points
    (kss_icp_tpu/ops/spatial.py:133-141; BallRegion_EstimateRadius_KDTree,
    pointNumEsti=12). The self-match is excluded by asking for k + 1."""
    kth = torch.sqrt(knn_kth_sqdist(points, points, mask, k + 1))
    return torch.where(mask, kth, torch.full_like(kth, -1.0)).max(dim=-1).values


def knn_cache(points: torch.Tensor, mask: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each point's k nearest other points, the `pointNeibor` cache
    (kss_icp_tpu/ops/spatial.py:144-151; ballRegionCompute.hpp:477-530).
    Returns (distances (..., P, k), indices (..., P, k))."""
    d2, idx = knn(points, points, mask, k + 1)
    return torch.sqrt(d2[..., 1:]), idx[..., 1:]


def _box_ijk(boxes_per_axis: int) -> torch.Tensor:
    """(B, 3) (i, j, k) of every box, row-major."""
    r = torch.arange(boxes_per_axis)
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(-1, 3)


def box_coloring(boxes_per_axis: int) -> torch.Tensor:
    """(B,) parity colour 0..7 of each box, the AIVS conflict-free schedule
    (Method_AIVS_SimPro.hpp:587-643). The segment reductions need none; kept
    for host-side scheduling, as in the JAX package."""
    ijk = _box_ijk(boxes_per_axis) % 2
    return (ijk[:, 0] * 4 + ijk[:, 1] * 2 + ijk[:, 2]).to(torch.int32)


def neighbor_box_ids(boxes_per_axis: int) -> torch.Tensor:
    """(B, 27) flat ids of each box's 3³ neighbourhood (itself included), -1
    where the stencil leaves the grid: BallRegion_ReturnNeiborBox
    (ballRegionCompute.hpp:852-1102) as one stencil table."""
    nb = boxes_per_axis
    offsets = _box_ijk(3) - 1  # (27, 3), the same row-major order
    nbr = _box_ijk(nb)[:, None, :] + offsets[None]
    valid = ((nbr >= 0) & (nbr < nb)).all(dim=-1)
    flat = (nbr[..., 0] * nb + nbr[..., 1]) * nb + nbr[..., 2]
    return torch.where(valid, flat, torch.full_like(flat, -1)).to(torch.int32)


def points_in_neighborhood(grid: VoxelGrid, boxes_per_axis: int, box: int) -> torch.Tensor:
    """(P,) bool mask of the points whose box lies in `box`'s 3³ neighbourhood,
    the gather AIVS used to build per-box local trees
    (Method_AIVS_SimPro.hpp:257-270)."""
    nbrs = neighbor_box_ids(boxes_per_axis)[box].to(grid.box_id.device)
    return ((grid.box_id[..., None] == nbrs) & (nbrs >= 0)).any(dim=-1)
