"""AIVS stratified uniform resampling (port of kss_icp_tpu/ops/aivs.py).

The reference's AIVS_Simplification_Pro (Method_AIVS_SimPro.hpp): voxel
boxes get sample quotas proportional to their population (round-up at a
fraction above 0.2, :776-794), every box runs farthest-point sampling over
its members, and an "accurate cut" deletes one member of the closest
surviving pair until the count is exact (:848-957), reading a 3-NN table
that is built once and never updated (:891-943).

As in the JAX package, all boxes' FPS rounds run in lockstep, round s
picking in every box whose quota exceeds s the member farthest from the
box's picks so far (the first pick: nearest the box's centroid), and the
cut is a masked loop over (P,) vectors. Every function takes one cloud or a
batch with a leading cloud axis, whose box ids are offset by the cloud
(ops/spatial.py::segment_ids), so one set of launches serves every cloud.
JAX's two loops have a fixed depth (max_rounds, max_cuts); here each stops
after one host sync at the depth past which no round picks and no cut
cuts, which gives the same answer.

The segment sums (the box centroids) add in index order on the CPU and on
CUDA alike (ops/spatial.py::segment_reduce), so a run's picks do not change
from run to run. The squared distances are XLA's fused multiply-adds
(ops/spatial.py::sq_norm_fma). The cut's 3-NN table comes from ops/nn.py::
knn in exact float32 differences, where JAX's knn takes the expansion form:
two selected points at near-equal distances can be cut in the other order.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from kss_icp_torch.ops.nn import BIG, knn
from kss_icp_torch.ops.spatial import (build_voxel_grid, estimate_box_scale, segment_ids, segment_reduce,
                                       sq_norm_fma)


def _at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx[..., j], ...] along the points or boxes axis (-1, or -2
    for (..., n, 3) rows)."""
    if x.dim() == idx.dim():
        return torch.take_along_dim(x, idx, dim=-1)
    return torch.take_along_dim(x, idx[..., None], dim=-2)


def box_quotas(counts: torch.Tensor, num_samples, class_rates: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-box sample quotas proportional to population, the fraction rounded
    up above 0.2 (kss_icp_tpu/ops/aivs.py:43-60; AIVS_BoxSimplification_Points
    :776-794); `class_rates` scales each box's weight (the prate mechanism).
    counts (..., B); num_samples an int or one a cloud."""
    w = counts.to(torch.float32)
    if class_rates is not None:
        w = w * class_rates.to(torch.float32)
    total = w.sum(dim=-1, keepdim=True).clamp_min(1.0)
    n = torch.as_tensor(num_samples, dtype=torch.float32, device=w.device)
    ideal = w * ((n[..., None] if n.dim() else n) / total)
    floor = torch.floor(ideal)
    quota = torch.where(ideal - floor > 0.2, floor + 1.0, floor).to(torch.int32)
    return torch.minimum(quota, counts.to(torch.int32))


def stratified_fps(points: torch.Tensor, mask: torch.Tensor, box_id: torch.Tensor, quotas: torch.Tensor,
                   max_rounds: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """All boxes' farthest-point sampling in lockstep
    (kss_icp_tpu/ops/aivs.py:63-128).

    points (..., P, 3), mask and box_id (..., P), quotas (..., B). Returns
    (selected (..., P) bool, pick_round (..., P) int32): min(quota_b, |box_b|)
    picks a box, and the round each point was picked in (P if never). Round
    s: each box whose quota exceeds s picks the unpicked member farthest
    from its picks (the first round: nearest its centroid), the lowest index
    among ties."""
    dtype, device = points.dtype, points.device
    lead, p = mask.shape[:-1], mask.shape[-1]
    b = quotas.shape[-1]
    seg = torch.where(mask, box_id, torch.full_like(box_id, b))  # padding -> a dump segment
    gseg = segment_ids(seg, b + 1)
    total = lead.numel() * (b + 1)

    def reduce(values, op, init):  # (..., P) or (..., P, 3) -> (..., B + 1) or (..., B + 1, 3)
        rows = values.shape[len(lead) + 1:]
        return segment_reduce(values.reshape((-1,) + rows), gseg, total, op, init).view(lead + (b + 1,) + rows)

    w = mask.to(dtype)
    sums = reduce(points * w[..., None], "sum", 0.0)
    cnts = reduce(w, "sum", 0.0)
    centroid = sums / cnts.clamp_min(1.0)[..., None]
    d2cent = sq_norm_fma(points - _at(centroid, seg.long()))

    box = box_id.clamp(0, b - 1).long()
    idx = torch.arange(p, dtype=torch.int32, device=device).expand(mask.shape)
    open_ = mask & (box_id >= 0)
    selected = torch.zeros_like(mask)
    min_d2 = torch.full(mask.shape, BIG, dtype=dtype, device=device)
    pick_round = torch.full(mask.shape, p, dtype=torch.int32, device=device)
    neg_big = torch.full_like(min_d2, -BIG)
    # Rounds past the largest quota pick nothing: stop there (one sync).
    for s in range(min(max_rounds, int(quotas.max()) if quotas.numel() else 0)):
        score = torch.where(mask & ~selected, -d2cent if s == 0 else min_d2, neg_big)
        best = reduce(score, "amax", float("-inf"))[..., :b]
        active = (quotas > s) & (best > -BIG / 2)
        is_best = open_ & ~selected & (score >= _at(best, box)) & _at(active, box)
        first = reduce(torch.where(is_best, idx, torch.full_like(idx, p)), "amin", p)[..., :b]
        pick = is_best & (idx == _at(first, box))
        selected = selected | pick
        pick_round = torch.where(pick, torch.full_like(pick_round, s), pick_round)
        box_pick = _at(reduce(torch.where(pick[..., None], points, torch.full_like(points, BIG)), "amin",
                              float("inf"))[..., :b, :], box)
        d2new = sq_norm_fma(points - box_pick)
        valid_new = (box_pick[..., 0] < BIG / 2) & mask
        min_d2 = torch.where(valid_new, torch.minimum(min_d2, d2new), min_d2)
    return selected, pick_round


def accurate_cut(points: torch.Tensor, selected: torch.Tensor, target, max_cuts: int = 64) -> torch.Tensor:
    """Trim each selection to exactly `target` points by deleting, one at a
    time, a member of the closest selected pair: the one whose second-nearest
    selected neighbour is nearer (kss_icp_tpu/ops/aivs.py:131-171;
    AIVS_AccurateCut_Optimization :848-957). The reference's static table:
    the 3 nearest selected points of every point, built once, deleted points
    excluded only through the alive flags. At most max_cuts cuts.

    points (..., P, 3), selected (..., P), target an int or one a cloud.
    Returns the alive flags (..., P)."""
    d2, idx = knn(points, points, selected, 3)
    d = torch.sqrt(d2.clamp_min(0.0))
    # Column 0 of a selected point is itself, so 1 and 2 are its nearest and
    # second-nearest selected neighbours.
    d1, i1, dsec = d[..., 1], idx[..., 1], d[..., 2]
    target = torch.as_tensor(target, device=selected.device)
    remaining = (selected.sum(dim=-1) - target).to(torch.int32)
    alive = selected.clone()
    big = torch.full_like(d1, BIG)
    # Once no cut is left, or no pair, a cut changes nothing: stop there (one sync).
    for _ in range(max(0, min(max_cuts, int(remaining.max()) if remaining.numel() else 0))):
        cand = torch.where(alive & _at(alive, i1), d1, big)
        b1 = torch.argmin(cand, dim=-1, keepdim=True)  # the first of equal minima, as jnp.argmin
        b2 = _at(i1, b1)
        do = (remaining > 0) & (_at(cand, b1)[..., 0] < BIG / 2)
        drop = torch.where(_at(dsec, b1) > _at(dsec, b2), b2, b1)
        alive = alive.scatter(-1, drop, _at(alive, drop) & ~do[..., None])
        remaining = remaining - do.to(torch.int32)
    return alive


def classify_curvature(normals: torch.Tensor, points: torch.Tensor, mask: torch.Tensor, k: int = 12,
                       curved_threshold: float = 0.1, edge_threshold: float = 0.3) -> torch.Tensor:
    """Per-point class 0 (flat), 1 (curved) or 2 (edge) from the mean normal
    deviation 1 - |n_j · n_p| over the k-neighbourhood
    (kss_icp_tpu/ops/aivs.py:174-192; AIVS_NormalValue and
    AIVS_Classification_{Curvature,Edge}). (..., P, 3) normals and points."""
    _, idx = knn(points, points, mask, k)
    neigh = torch.take_along_dim(normals[..., None, :], idx[..., None], dim=-3)  # (..., P, k, 3)
    dev = 1.0 - (neigh * normals[..., None, :]).sum(dim=-1).abs()
    mean_dev = dev.mean(dim=-1)
    cls = torch.where(mean_dev > edge_threshold, 2, torch.where(mean_dev > curved_threshold, 1, 0))
    return torch.where(mask, cls, torch.zeros_like(cls)).to(torch.int32)


def class_rate_per_box(cls: torch.Tensor, box_id: torch.Tensor, mask: torch.Tensor, num_boxes: int,
                       rates=(1.0, 3.0, 7.0)) -> torch.Tensor:
    """Each box's mean prate multiplier: flat 1x, curved 3x, edge 7x, the
    reference's prate = {3, 7} (kss_icp_tpu/ops/aivs.py:195-210)."""
    lead = mask.shape[:-1]
    gseg = segment_ids(torch.where(mask, box_id, torch.full_like(box_id, num_boxes)), num_boxes + 1)
    total = lead.numel() * (num_boxes + 1)
    r = torch.tensor(rates, dtype=torch.float32, device=cls.device)[cls.clamp(0, 2).long()]
    w = mask.to(torch.float32)
    s = segment_reduce((r * w).reshape(-1), gseg, total, "sum", 0.0).view(lead + (num_boxes + 1,))[..., :num_boxes]
    c = segment_reduce(w.reshape(-1), gseg, total, "sum", 0.0).view(lead + (num_boxes + 1,))[..., :num_boxes]
    return torch.where(c > 0, s / c.clamp_min(1.0), torch.ones_like(s))


def aivs_select(points: torch.Tensor, mask: torch.Tensor, num_samples, boxes_per_axis: int, max_rounds: int = 128,
                max_cuts: int = 256, class_rates: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grid, quotas, lockstep per-box FPS, exact-N cut
    (kss_icp_tpu/ops/aivs.py:213-240). Returns (selected (..., P) bool,
    pick_round (..., P) int32, P where not selected). A box whose quota
    exceeds max_rounds undersamples, and round-ups beyond max_cuts leave the
    count above num_samples, as in JAX."""
    grid = build_voxel_grid(points, mask, boxes_per_axis)
    quotas = box_quotas(grid.counts, num_samples, class_rates)
    selected, pick_round = stratified_fps(points, mask, grid.box_id, quotas, max_rounds)
    target = torch.minimum(torch.as_tensor(num_samples, device=mask.device), mask.sum(dim=-1))
    alive = accurate_cut(points, selected, target, max_cuts)
    return alive, torch.where(alive, pick_round, torch.full_like(pick_round, mask.shape[-1]))


def aivs_resample_packed(points: torch.Tensor, mask: torch.Tensor, num_samples, pad: int, boxes_per_axis: int,
                         max_rounds: int = 128, max_cuts: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pipeline's AIVS (kss_icp_tpu/ops/aivs.py:243-270): (points
    (..., pad, 3), mask (..., pad)) packed in pick-round order, a stable sort
    (ties in index order), so every prefix is a stratified uniform
    subsample, as the coarse and screen prefixes need."""
    selected, pick_round = aivs_select(points, mask, num_samples, boxes_per_axis, max_rounds, max_cuts)
    order = torch.argsort(pick_round, dim=-1, stable=True)[..., :min(pad, points.shape[-2])]
    out_mask = torch.take_along_dim(selected, order, dim=-1)
    out_pts = _at(points, order) * out_mask[..., None].to(points.dtype)
    short = pad - out_pts.shape[-2]
    if short > 0:
        out_pts = torch.nn.functional.pad(out_pts, (0, 0, 0, short))
        out_mask = torch.nn.functional.pad(out_mask, (0, short))
    return out_pts, out_mask


def aivs_resample(points: torch.Tensor, mask: torch.Tensor, num_samples: int, boxes_per_axis: Optional[int] = None,
                  normals: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Host-facing AIVS of one cloud (kss_icp_tpu/ops/aivs.py:273-306; `simplify
    -m aivs`): exactly min(num_samples, valid) points selected. The loop
    depth is the largest quota, so every quota is met, and the cut budget the
    next power of two above the round-up slack. With normals, curved and edge
    boxes get larger quotas. Returns (points zeroed where not selected, the
    selection mask), in the input's padded shape."""
    n_valid = int(mask.sum())
    nb = boxes_per_axis or estimate_box_scale(n_valid)
    grid = build_voxel_grid(points, mask, nb)
    rates = None
    if normals is not None:
        rates = class_rate_per_box(classify_curvature(normals, points, mask), grid.box_id, mask, nb ** 3)
    quotas = box_quotas(grid.counts, num_samples, rates)
    max_rounds = max(int(quotas.max()), 1)
    slack = int(quotas.sum()) - min(num_samples, n_valid)
    sel, _ = aivs_select(points, mask, num_samples, nb, max_rounds=max_rounds, max_cuts=_next_pow2(max(slack, 1)),
                         class_rates=rates)
    return points * sel[..., None].to(points.dtype), sel


def _next_pow2(x: int) -> int:
    return 1 << max(0, math.ceil(math.log2(max(x, 1))))
