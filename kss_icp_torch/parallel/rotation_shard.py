"""Rotation-grid sharding: one pair's steps³ rotation scores split over a mesh
axis, the field all-gathered (port of kss_icp_tpu/parallel/rotation_shard.py).

Each rank scores its contiguous slice of the Euler grid's rotations with the
`field_ave` kernel, exact float32 differences (the port's rule for the "ave"
field, where JAX's shard calls XLA's masked_mean_nn_distance), against the
whole target; the slices are all-gathered in rank order. A rotation's score
does not depend on the others in its launch, so the field is the unsharded
`score_rotation_field`'s bit for bit.
"""

from __future__ import annotations

import torch

from kss_icp_torch.core.transforms import euler_xyz_matrix
from kss_icp_torch.models.coarse import rotation_grid
from kss_icp_torch.ops.coarse_cuda import field_ave
from kss_icp_torch.parallel.mesh import all_gather_rows, axis_rank


def score_rotation_field_sharded(
    source: torch.Tensor,
    source_mask: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    *,
    steps: int,
    span: float = 6.3,
    mesh,
    rot_axis: str = "rot",
) -> torch.Tensor:
    """(steps, steps, steps) "ave" error field, the rotation axis sharded over
    `rot_axis`. Requires steps³ % the axis size == 0 (pad steps if not).
    Every rank passes the whole clouds and returns the whole field."""
    total = steps ** 3
    size, rank = axis_rank(mesh, rot_axis)
    if total % size:
        raise ValueError(f"steps^3={total} not divisible by {size} shards")
    per = total // size
    rots = euler_xyz_matrix(rotation_grid(steps, span, source.device))[rank * per:(rank + 1) * per]
    scores = field_ave(source, source_mask, target.contiguous(), target_mask.contiguous(), rots.contiguous())
    return all_gather_rows(scores, mesh.get_group(rot_axis)).reshape(steps, steps, steps)
