"""2D Voronoi cells and centroidal relaxation (port of
kss_icp_tpu/ops/voronoi2d.py; the reference's VoronoiD, VD.hpp, not in the
reference build, of the CVT-remesh lineage).

VD.hpp clips CGAL's Voronoi cells to a bounding box and takes their areas and
centroids (VoronoiD_Bounding :50, VoronoiD_Centroid :101), which Lloyd / CVT
relaxation consumes. As in JAX, the cell is measure-theoretic: the box is
rasterised at `resolution`² pixel centres, each pixel is labelled with its
nearest valid site, and areas and centroids are segment sums. The labels are
one `nn1` launch with the 2D points padded to z = 0, which adds nothing to an
exact difference; JAX takes the argmin of the ‖p‖² − 2p·c + ‖c‖² expansion
(voronoi2d.py:55-60), so pixels that are near-tied between two sites may take
the other one. The sums run in pixel order (ops/spatial.py::segment_reduce).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from kss_icp_torch.ops.nn_cuda import nn1
from kss_icp_torch.ops.spatial import segment_reduce


class VoronoiCells(NamedTuple):
    areas: torch.Tensor      # (S,) cell area inside the bbox (0 for a masked site)
    centroids: torch.Tensor  # (S, 2) cell centroid (the site itself if masked or empty)
    labels: torch.Tensor     # (res, res) int32 nearest-site raster, [x index, y index]


def _grid(bbox, resolution: int, dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel centres (res², 2), x-major as JAX's meshgrid(indexing="ij"), and
    the pixel area, rounded as JAX under x64 rounds its Python floats: the
    widths in float64, then float32."""
    x0, y0, x1, y1 = (float(v) for v in bbox)
    i = torch.arange(resolution, dtype=dtype, device=device) + 0.5
    xs = x0 + i * torch.tensor(x1 - x0, dtype=dtype) / resolution
    ys = y0 + i * torch.tensor(y1 - y0, dtype=dtype) / resolution
    gx, gy = torch.meshgrid(xs, ys, indexing="ij")
    pix_area = torch.tensor(((x1 - x0) / resolution) * ((y1 - y0) / resolution), dtype=dtype, device=device)
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1), pix_area


def voronoi_cells(sites: torch.Tensor, site_mask: torch.Tensor, bbox: Tuple[float, float, float, float],
                  resolution: int = 256) -> VoronoiCells:
    """Bounded Voronoi cells of (S, 2) sites inside bbox = (x0, y0, x1, y1)
    (JAX voronoi2d.py:41-75). A masked site never wins a pixel and reports
    area 0 and its own position as centroid; with every site masked, each
    pixel's label is 0 (nn1's d² is 1e30 for all, and the first index wins,
    as JAX's argmin)."""
    dtype, device = sites.dtype, sites.device
    s = sites.shape[0]
    pix, pix_area = _grid(bbox, resolution, dtype, device)
    zero = torch.zeros((pix.shape[0], 1), dtype=dtype, device=device)
    _, labels = nn1(torch.cat([pix, zero], dim=-1),
                    torch.cat([sites, torch.zeros((s, 1), dtype=dtype, device=device)], dim=-1).contiguous(),
                    site_mask.contiguous())
    seg = labels.long()
    counts = segment_reduce(torch.ones_like(pix[:, 0]), seg, s, "sum", 0.0)
    sums = segment_reduce(pix, seg, s, "sum", 0.0)
    areas = counts * pix_area
    centroids = torch.where(counts[:, None] > 0, sums / counts.clamp_min(1.0)[:, None], sites)
    return VoronoiCells(areas=areas * site_mask.to(dtype),
                        centroids=torch.where(site_mask[:, None], centroids, sites),
                        labels=labels.reshape(resolution, resolution))


def lloyd_relax(sites: torch.Tensor, site_mask: torch.Tensor, bbox: Tuple[float, float, float, float],
                resolution: int = 256, iterations: int = 10) -> torch.Tensor:
    """Centroidal Voronoi tessellation by Lloyd iteration (JAX
    voronoi2d.py:78-93): `iterations` times, move each valid site to its
    bounded cell's centroid; one `nn1` launch a step."""
    for _ in range(iterations):
        cells = voronoi_cells(sites, site_mask, bbox, resolution)
        sites = torch.where(site_mask[:, None], cells.centroids, sites)
    return sites
