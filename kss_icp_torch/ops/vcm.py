"""Voronoi Covariance Measure (VCM) sharp-edge estimation (port of
kss_icp_tpu/ops/vcm.py; the reference's CGAL_VCM.hpp, CGAL::vcm_estimate_edges
/ vcm_is_on_feature_edge, not in the reference build).

The VCM of a point set (Mérigot, Ovsjanikov, Guibas 2010) gives each point the
covariance of its Voronoi cell cut by an offset ball of radius R; convolved
over an r-neighbourhood, its eigenvalues separate smooth-surface points (one
dominant eigenvalue, along the normal) from sharp edges (two). As in JAX, the
cell integral is a Monte-Carlo sum:

  1. samples uniform in the R-balls around the points (`ball_samples`, from a
     torch.Generator; JAX draws from a PRNG key, so `vcm` also takes the
     samples as an input);
  2. each sample's owner is its nearest valid site, one `nn1` launch over all
     samples (exact float32 differences; JAX takes the argmin of the
     ‖a‖² + ‖b‖² − 2ab expansion, vcm.py:73-78, whose near-ties order
     otherwise), kept where that squared distance is within R²;
  3. (sample − site)(sample − site)ᵀ summed per site in sample order
     (ops/spatial.py::segment_reduce);
  4. the convolution: each site's sum of the matrices of the valid sites
     within r, in blocks of rows: the block's mask in exact differences, then
     a float32 matmul with the (P, 9) matrices (TF32 off). JAX builds the
     whole (P, P) mask, 6.7 GB at 40960 points;
  5. the edge test on the sorted eigenvalues e0 ≤ e1 ≤ e2: edge iff
     e1 / (e0 + e1 + e2) ≥ threshold, with torch.linalg.eigvalsh in calls of
     ops/normals.py::EIGH_BATCH matrices (cuSOLVER's limit).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from kss_icp_torch.ops.nn import exact_sqdist
from kss_icp_torch.ops.nn_cuda import nn1
from kss_icp_torch.ops.normals import EIGH_BATCH
from kss_icp_torch.ops.spatial import segment_reduce

# Elements of a convolution block's (rows, P) mask.
_BLOCK_ELEMS = 1 << 24


def ball_samples(points: torch.Tensor, radius: float, samples_per_point: int,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Uniform samples in the R-balls centred at each of the (P, 3) points:
    (P * S, 3), point p's S samples in rows p*S .. p*S + S - 1 (JAX's
    _ball_samples, vcm.py:36-46: a normalised Gaussian direction times
    u^(1/3) R). `generator` must be on the points' device."""
    p, dtype, device = points.shape[0], points.dtype, points.device
    d = torch.randn((p, samples_per_point, 3), generator=generator, dtype=dtype, device=device)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True).clamp_min(1e-12)
    u = torch.rand((p, samples_per_point, 1), generator=generator, dtype=dtype, device=device)
    offs = d * (u ** (1.0 / 3.0)) * radius
    return (points[:, None, :] + offs).reshape(-1, 3)


def sample_owners(samples: torch.Tensor, points: torch.Tensor, mask: torch.Tensor,
                  offset_radius: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each sample's nearest valid site (one `nn1` launch; first index on
    ties) and whether it lies in the offset domain, d² ≤ R² in float32."""
    d2, owner = nn1(samples.contiguous(), points.contiguous(), mask.contiguous())
    r_off = torch.tensor(offset_radius, dtype=points.dtype)
    return owner, d2 <= (r_off * r_off).to(points.device)


def site_matrices(samples: torch.Tensor, points: torch.Tensor, mask: torch.Tensor,
                  offset_radius: float, samples_per_point: int) -> torch.Tensor:
    """Steps 2-3: each valid site's sum of (sample − site)(sample − site)ᵀ over
    the in-domain samples it owns, times the Monte-Carlo measure (ball volume
    over samples drawn, in float32 as JAX rounds it: (4/3)π as one float32,
    R³ as (R·R)·R). (P, 9); padded rows are zero."""
    dtype = points.dtype
    owner, in_domain = sample_owners(samples, points, mask, offset_radius)
    diff = samples - points[owner.long()]
    outer = (diff[:, :, None] * diff[:, None, :] * in_domain[:, None, None].to(dtype)).reshape(-1, 9)
    mats = segment_reduce(outer, owner.long(), points.shape[0], "sum", 0.0)
    r_off = torch.tensor(offset_radius, dtype=dtype)
    vol = torch.tensor(4.0 / 3.0 * math.pi, dtype=dtype) * (r_off * r_off * r_off)
    return mats * (vol / samples_per_point).to(points.device)


def convolve(points: torch.Tensor, mask: torch.Tensor, mats: torch.Tensor, convolve_radius: float) -> torch.Tensor:
    """Step 4: each valid site's sum of the (P, 9) matrices of the valid sites
    within r, a block of rows at a time (the block's mask in exact
    differences, then a float32 matmul)."""
    p = points.shape[0]
    r2 = torch.tensor(convolve_radius * convolve_radius, dtype=points.dtype).to(points.device)
    rows = max(1, _BLOCK_ELEMS // max(p, 1))
    conv = torch.empty_like(mats)
    for r0 in range(0, p, rows):
        block = slice(r0, r0 + rows)
        near = (exact_sqdist(points[block], points) <= r2) & mask[None, :] & mask[block, None]
        conv[block] = torch.matmul(near.to(mats.dtype), mats)
    return conv


def vcm(
    points: torch.Tensor,
    mask: torch.Tensor,
    offset_radius: float,
    convolve_radius: float,
    samples: Optional[torch.Tensor] = None,
    samples_per_point: int = 32,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Convolved VCM matrices (P, 3, 3) of a padded (P, 3) cloud with its (P,)
    mask (JAX vcm.py:49-90). `samples` ((P * samples_per_point, 3), JAX's
    draw in the tests) or else `ball_samples` from `generator`. Samples drawn
    around padded rows are owned by valid sites and add only far-field noise;
    padded rows get zero matrices."""
    if samples is None:
        samples = ball_samples(points, offset_radius, samples_per_point, generator)
    mats = site_matrices(samples, points, mask, offset_radius, samples_per_point)
    return convolve(points, mask, mats, convolve_radius).reshape(points.shape[0], 3, 3)


def edge_ratio(mats: torch.Tensor) -> torch.Tensor:
    """Step 5's ratio e1 / (e0 + e1 + e2) of (P, 3, 3) matrices' ascending
    eigenvalues, eigvalsh in calls of EIGH_BATCH matrices."""
    evals = torch.cat([torch.linalg.eigvalsh(mats[i:i + EIGH_BATCH]) for i in range(0, mats.shape[0], EIGH_BATCH)])
    return evals[:, 1] / evals.sum(dim=-1).clamp_min(torch.finfo(mats.dtype).tiny)


def vcm_edges(
    points: torch.Tensor,
    mask: torch.Tensor,
    offset_radius: float,
    convolve_radius: float,
    threshold: float = 0.16,
    samples: Optional[torch.Tensor] = None,
    samples_per_point: int = 32,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sharp-edge flags, CGAL_VCM_BorderOut (CGAL_VCM.hpp:25; JAX
    vcm.py:93-109): (edge (P,) bool, ratio (P,)), ratio = e1 / (e0 + e1 + e2)
    of the convolved matrices' ascending eigenvalues, edge iff ratio ≥
    threshold (CGAL's default 0.16); padded rows are neither."""
    ratio = edge_ratio(vcm(points, mask, offset_radius, convolve_radius, samples, samples_per_point, generator))
    return (ratio >= threshold) & mask, ratio * mask.to(points.dtype)
