"""Point-axis sharding: one pair's source rows split over a mesh axis (port of
kss_icp_tpu/parallel/point_shard.py).

Each rank holds a contiguous slice of the source rows and the whole target.
Each ICP iteration's 1-NN (`nn1`) runs on the local rows; the Kabsch sums,
the correspondence MSE and the fitness are all-reduced over the axis
(models/icp.py's `group`), so the transform comes out the same on every
rank. The metric sums its local distances and all-reduces them: the PCR_QM
measure of full-resolution clouds across cards.
"""

from __future__ import annotations

import torch

from kss_icp_torch.models.icp import ICPParams, ICPResult, all_sum, icp
from kss_icp_torch.ops.nn_cuda import nn1
from kss_icp_torch.parallel.mesh import axis_rank


def _local_rows(n: int, mesh, point_axis: str, what: str) -> slice:
    """This rank's contiguous slice of n rows; n must divide by the axis size."""
    size, rank = axis_rank(mesh, point_axis)
    if n % size:
        raise ValueError(f"{what}={n} not divisible by {size} shards")
    per = n // size
    return slice(rank * per, (rank + 1) * per)


def icp_point_sharded(
    source: torch.Tensor,       # (P, 3), P divisible by the axis size
    source_mask: torch.Tensor,  # (P,)
    target: torch.Tensor,       # (T, 3), whole on every rank
    target_mask: torch.Tensor,  # (T,)
    params: ICPParams,
    *,
    mesh,
    point_axis: str = "points",
) -> ICPResult:
    """ICP of one pair with the source rows sharded over `point_axis`: the
    port's lane ICP at one lane on this rank's rows, its sums all-reduced.
    Every rank passes the whole source and returns the same unbatched
    result (rotation (3, 3), translation (3,), scalars)."""
    rows = _local_rows(source.shape[0], mesh, point_axis, "P")
    res = icp(source[rows][None].contiguous(), source_mask[rows][None], target.contiguous(),
              target_mask.contiguous(), params, group=mesh.get_group(point_axis))
    return ICPResult(*(x[0] for x in res))


def mean_nn_distance_sharded(
    query: torch.Tensor,       # (Q, 3), Q divisible by the axis size
    query_mask: torch.Tensor,  # (Q,)
    ref: torch.Tensor,         # (R, 3), whole on every rank
    ref_mask: torch.Tensor,    # (R,)
    *,
    mesh,
    point_axis: str = "points",
) -> torch.Tensor:
    """Mean 1-NN distance over the valid queries, the query rows sharded
    over `point_axis`: one `nn1` launch on this rank's rows, then the
    weighted sum and the weight all-reduced. A scalar, the same on every
    rank."""
    rows = _local_rows(query.shape[0], mesh, point_axis, "Q")
    d2, _ = nn1(query[rows][None].contiguous(), ref[None].contiguous(), ref_mask[None].contiguous())
    d = torch.sqrt(d2[0])
    w = query_mask[rows].to(d.dtype)
    group = mesh.get_group(point_axis)
    return all_sum((d * w).sum(), group) / all_sum(w.sum(), group).clamp_min(1.0)
