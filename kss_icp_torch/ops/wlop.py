"""WLOP (Weighted Locally Optimal Projection) resampling (port of
kss_icp_tpu/ops/wlop.py).

The reference calls CGAL::wlop_simplify_and_regularize_point_set to build
its 8000-point `.wlop` benchmark fixtures (Method_CGAL.hpp:123-159,
transferPC.hpp:144-151). Each step moves every sample by two dense weighted
sums, the attraction to the input cloud (M x N) and the repulsion between
samples (M x M):

  x_i <- sum_j p_j a_ij / sum_j a_ij
         + mu * (sum_{i'!=i} (x_i - x_{i'}) b_ii') / sum b_ii'
  a = theta(r)/r,  b = theta(r)/r,  theta(r) = exp(-16 r^2 / h^2)

(Lipman et al. 2007; CGAL's formulation with uniform density weights.)

The samples start from farthest-point sampling through the `fps` kernel (one
launch a cloud on the card; its indices are those of JAX's
farthest_point_sampling). The steps are plain PyTorch, as JAX computes them
in XLA: rows of samples in blocks of at most `_BLOCK_ELEMS` (rows, N)
elements, so the peak memory stays bounded at any N. The distances are exact
float32 differences (ops/nn.py::exact_sqdist): a sample starts on an input
point, where JAX's jitted expansion gives d² = 0 and so the 1/r weight of
1/sqrt(tiny); eager float32 expansion leaves a residue there that moves the
samples (ROADMAP.md, "Numerics").
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from kss_icp_torch.ops.nn import BIG, exact_sqdist
from kss_icp_torch.ops.resample_cuda import fps

# (rows, N) elements of one block of samples.
_BLOCK_ELEMS = 1 << 24


def default_radius(points: torch.Tensor, mask: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Support radius h: twice the bounding-box diagonal over sqrt(M), about
    4x the expected sample spacing diag / (2 sqrt(M)) on a surface
    (kss_icp_tpu/ops/wlop.py:33-43)."""
    hi = torch.where(mask[:, None], points, -BIG).amax(dim=0)
    lo = torch.where(mask[:, None], points, BIG).amin(dim=0)
    diag = torch.linalg.vector_norm(hi - lo)
    return 2.0 * diag / math.sqrt(float(num_samples))


def _step(x: torch.Tensor, points: torch.Tensor, w_in: torch.Tensor, w_s: torch.Tensor, inv_h2: torch.Tensor,
          mu: float, eps: float) -> torch.Tensor:
    """One WLOP step of every sample, a block of rows at a time."""
    m_n = x.shape[0]
    rows = max(1, _BLOCK_ELEMS // max(points.shape[0], m_n))
    out = []
    for r0 in range(0, m_n, rows):
        xb = x[r0:r0 + rows]
        # Attraction to the input cloud.
        d2 = exact_sqdist(xb, points)
        alpha = torch.exp(-d2 * inv_h2) / torch.sqrt(d2.clamp_min(eps)) * w_in
        attract = (alpha @ points) / alpha.sum(dim=1, keepdim=True).clamp_min(eps)
        # Repulsion between samples; a sample does not repel itself.
        d2 = exact_sqdist(xb, x)
        beta = torch.exp(-d2 * inv_h2) / torch.sqrt(d2.clamp_min(eps)) * w_s
        own = torch.arange(r0, r0 + xb.shape[0], device=x.device)
        beta[own - r0, own] = 0.0
        repulse = torch.stack([(beta * (xb[:, None, k] - x[None, :, k])).sum(dim=1) for k in range(3)], dim=1)
        out.append(attract + mu * (repulse / beta.sum(dim=1, keepdim=True).clamp_min(eps)))
    return torch.cat(out)


def wlop_resample(points: torch.Tensor, mask: torch.Tensor, num_samples: int, iterations: int = 20,
                  mu: float = 0.45, radius: Optional[Union[float, torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resample a padded (N, 3) cloud to `num_samples` regularized points
    (kss_icp_tpu/ops/wlop.py:46-91). Returns (samples (num_samples, 3), zero
    in the masked slots, sample_mask); the mask is the FPS start's, so it
    holds min(count, num_samples) samples."""
    dtype = points.dtype
    eps = torch.finfo(dtype).tiny
    idx, smask = fps(points[None].contiguous(), mask[None].contiguous(), num_samples)
    idx, smask = idx[0].long(), smask[0]
    x = points[idx]
    if radius is None:
        radius = default_radius(points, mask, num_samples)
    h = torch.as_tensor(radius, dtype=dtype, device=points.device)
    inv_h2 = 16.0 / (h * h).clamp_min(eps)
    w_in = mask.to(dtype)
    w_s = smask.to(dtype)
    for _ in range(iterations):
        x = torch.where(smask[:, None], _step(x, points, w_in, w_s, inv_h2, mu, eps), x)
    return x * w_s[:, None], smask
