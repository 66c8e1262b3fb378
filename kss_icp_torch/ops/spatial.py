"""Spatial queries (port of kss_icp_tpu/ops/spatial.py, in part).

Only `estimate_radius` is ported, for `simplify -m grid` and the transfer
tools; the voxel grid and the kNN cache wait for the AIVS resampler
(ROADMAP.md queue 1 item 13, aivs).
"""

from __future__ import annotations

import torch

from kss_icp_torch.ops.nn import knn


def estimate_radius(points: torch.Tensor, mask: torch.Tensor, k: int = 12) -> torch.Tensor:
    """Global support radius: the largest k-NN distance over the valid points
    (kss_icp_tpu/ops/spatial.py:133-141; BallRegion_EstimateRadius_KDTree,
    pointNumEsti=12). The self-match is excluded by asking for k + 1."""
    d2, _ = knn(points, points, mask, k + 1)
    kth = torch.sqrt(d2[..., -1])
    return torch.where(mask, kth, torch.full_like(kth, -1.0)).max(dim=-1).values
