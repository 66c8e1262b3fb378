"""Cloud simplification by voxels (port of kss_icp_tpu/ops/simplify.py:
`grid_simplify` and `octree_simplify`).

Both keep the real point nearest each occupied voxel centre
(ops/resample.py::voxel_downsample): `grid_simplify` at a given cell (CGAL's
grid_simplify_point_set, Method_CGAL.hpp:57-86), `octree_simplify` at the
cell that leaves about `target_points` voxels on a surface (the octree
downsampler of the reference's large-scan binary, Method_Octree.hpp:148-165).
`hierarchy_simplify` is not ported yet (ROADMAP.md queue 1 item 13).
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from kss_icp_torch.ops.resample import BIG, voxel_downsample


def _sqrt32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (by way of float64, whose
    square root rounds to float32 without a double-rounding error): torch's
    CPU float32 sqrt is off by an ulp on some inputs."""
    return x.double().sqrt().float()


def grid_simplify(points: torch.Tensor, mask: torch.Tensor,
                  cell_size: Union[float, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """One representative (nearest the voxel centre) per occupied voxel."""
    return voxel_downsample(points, mask, cell_size)


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
    inv = 1.0 / _sqrt32(torch.tensor(float(target_points), dtype=dtype, device=points.device))
    cell = diag * inv
    return voxel_downsample(points, mask, cell)
