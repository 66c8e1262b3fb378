"""Kendall pre-shape normalization (port of kss_icp_tpu/core/preshape.py).

Mirrors initRegistration_MiddleAlign (initRegistrationKSS.hpp:144-220):
translate the source onto the target centroid and scale it by
meanRadius_T / meanRadius_S about that centroid, returned as the Similarity
x -> s·x + (c_T − s·c_S).
"""

from __future__ import annotations

from typing import Tuple

import torch

from kss_icp_torch.core.transforms import Similarity


def masked_centroid(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of valid points. points (..., N, 3), mask (..., N) -> (..., 3)."""
    w = mask.to(points.dtype)
    total = (points * w[..., None]).sum(dim=-2)
    count = w.sum(dim=-1).clamp_min(1.0)
    return total / count[..., None]


def masked_mean_radius(points: torch.Tensor, mask: torch.Tensor, centroid: torch.Tensor) -> torch.Tensor:
    """Mean distance-to-centroid over valid points (Kendall pre-shape size)."""
    w = mask.to(points.dtype)
    d = torch.linalg.vector_norm(points - centroid[..., None, :], dim=-1)
    count = w.sum(dim=-1).clamp_min(1.0)
    return (d * w).sum(dim=-1) / count


def middle_align(
    source_points: torch.Tensor,
    source_mask: torch.Tensor,
    target_points: torch.Tensor,
    target_mask: torch.Tensor,
) -> Tuple[Similarity, torch.Tensor, torch.Tensor]:
    """Pre-shape transform moving the source onto the target frame.

    Returns (sim, target_centroid, scale) with sim: x -> s·x + (c_T − s·c_S).
    """
    c_s = masked_centroid(source_points, source_mask)
    c_t = masked_centroid(target_points, target_mask)
    r_s = masked_mean_radius(source_points, source_mask, c_s)
    r_t = masked_mean_radius(target_points, target_mask, c_t)
    scale = r_t / r_s.clamp_min(torch.finfo(source_points.dtype).tiny)
    eye = torch.eye(3, dtype=source_points.dtype, device=source_points.device)
    sim = Similarity(
        scale=scale,
        rotation=eye.expand(scale.shape + (3, 3)).clone(),
        translation=c_t - scale[..., None] * c_s,
    )
    return sim, c_t, scale
