"""Cloud simplification (port of kss_icp_tpu/ops/simplify.py).

`grid_simplify` and `octree_simplify` keep the real point nearest each
occupied voxel centre (ops/resample.py::voxel_downsample): the first at a
given cell (CGAL's grid_simplify_point_set, Method_CGAL.hpp:57-86), the
second at the cell that leaves about `target_points` voxels on a surface (the
octree downsampler of the reference's large-scan binary,
Method_Octree.hpp:148-165). `hierarchy_simplify` is CGAL's
hierarchy_simplify_point_set (Method_CGAL.hpp:88-121) as JAX's static-depth
sequence of segment reductions.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch

from kss_icp_torch.ops.normals import EIGH_BATCH
from kss_icp_torch.ops.resample import BIG, voxel_downsample
from kss_icp_torch.ops.spatial import segment_reduce, sq_norm_fma
from kss_icp_torch.utils.profiling import span, spanned


def _sqrt32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (by way of float64, whose
    square root rounds to float32 without a double-rounding error): torch's
    CPU float32 sqrt is off by an ulp on some inputs."""
    return x.double().sqrt().float()


def grid_simplify(points: torch.Tensor, mask: torch.Tensor,
                  cell_size: Union[float, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """One representative (nearest the voxel centre) per occupied voxel."""
    return voxel_downsample(points, mask, cell_size)


@spanned("octree")
def octree_simplify(points: torch.Tensor, mask: torch.Tensor,
                    target_points: int = 80000) -> Tuple[torch.Tensor, torch.Tensor]:
    """Voxel downsample of (P, 3) `points` at the cell diag / sqrt(target_points),
    diag the valid points' bounding-box diagonal: occupied voxels of a surface
    grow as (diag / cell)², so about `target_points` survive. Returns
    (points, keep) as voxel_downsample does.

    The cell's last bit moves the survivors, so it rounds as JAX's jitted
    octree_simplify does on the CPU (as run_largescan calls it): the
    diagonal's three squares summed as (x² + z²) + y², each rounded (XLA's
    order for this three-term reduction there, with no fused multiply-add,
    unlike a standalone `jnp.linalg.norm`), and the division by the constant
    sqrt(target_points) as XLA rewrites it, a product with its float32
    reciprocal. tests/test_torch_largescan.py holds both to JAX on clouds
    whose bounding boxes part every other order."""
    dtype = points.dtype
    hi = torch.where(mask[:, None], points, -BIG).amax(dim=0)
    lo = torch.where(mask[:, None], points, BIG).amin(dim=0)
    extent = hi - lo
    sq = extent * extent
    diag = _sqrt32((sq[0] + sq[2]) + sq[1])
    with span("sync.octree"):  # a scalar copied to the device: a blocking copy
        root = torch.tensor(float(target_points), dtype=dtype, device=points.device)
    inv = 1.0 / _sqrt32(root)
    cell = diag * inv
    return voxel_downsample(points, mask, cell)


def hierarchy_simplify(points: torch.Tensor, mask: torch.Tensor, max_cluster_size: int = 10,
                       max_variation: float = 1.0 / 3.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Variance-split hierarchy clustering of a (P, 3) cloud, keeping the
    valid point nearest each cluster's barycentre
    (kss_icp_tpu/ops/simplify.py:41-125). Returns (points, keep) of the
    input's padded shape, the rows not kept zeroed.

    ceil(log2 P) levels; at each, a cluster of more than `max_cluster_size`
    points (or, with max_variation < 1/3, of surface variation λ0 / (λ0 + λ1
    + λ2) above it) splits at its mean along its axis of largest variance,
    the points with coord > mean going to the second half. The split
    compares a coordinate with a segment mean, so the sums round as in JAX's
    jitted function: segment sums in index order (`segment_reduce`, the same
    bits on the CPU and the card), means by true division, and the squared
    distance to the barycentre in XLA's fused multiply-adds (`sq_norm_fma`).
    """
    p = points.shape[0]
    dtype, device = points.dtype, points.device
    depth = max(1, math.ceil(math.log2(max(2, p))))
    use_variation = max_variation < 1.0 / 3.0
    w = mask.to(dtype)
    wp = points * w[:, None]

    def seg_sum(values, cluster, n_seg):
        return segment_reduce(values, cluster, n_seg, "sum", 0.0)

    cluster = torch.zeros(p, dtype=torch.int64, device=device)
    for level in range(depth):
        n_seg = 1 << level
        count = seg_sum(w, cluster, n_seg)
        count_safe = count.clamp_min(1.0)
        mean = seg_sum(wp, cluster, n_seg) / count_safe[:, None]
        centered = (points - mean[cluster]) * w[:, None]
        var = seg_sum(centered * centered, cluster, n_seg) / count_safe[:, None]
        axis = torch.argmax(var, dim=1)
        coord = torch.gather(points, 1, axis[cluster][:, None])[:, 0]
        threshold = torch.gather(mean, 1, axis[:, None])[:, 0][cluster]
        needs_split = count > max_cluster_size
        if use_variation:
            cov = seg_sum(centered[:, :, None] * centered[:, None, :], cluster, n_seg) / count_safe[:, None, None]
            eig = torch.cat([torch.linalg.eigvalsh(cov[i:i + EIGH_BATCH]) for i in range(0, n_seg, EIGH_BATCH)])
            trace = eig.sum(dim=-1).clamp_min(torch.finfo(dtype).tiny)
            needs_split = needs_split | ((eig[:, 0] / trace > max_variation) & (count > 1))
        side = (needs_split[cluster] & (coord > threshold)).long()
        cluster = cluster * 2 + side

    n_seg = 1 << depth
    count = seg_sum(w, cluster, n_seg)
    mean = seg_sum(wp, cluster, n_seg) / count.clamp_min(1.0)[:, None]
    d2 = torch.where(mask, sq_norm_fma(points - mean[cluster]), torch.full_like(w, BIG))
    best = segment_reduce(d2, cluster, n_seg, "amin", BIG)
    is_best = mask & (d2 <= best[cluster])
    idx = torch.arange(p, device=device)
    first_best = segment_reduce(torch.where(is_best, idx, p), cluster, n_seg, "amin", p)
    keep = is_best & (idx == first_best[cluster])
    return points * keep[:, None].to(dtype), keep
