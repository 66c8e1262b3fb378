"""Registration quality metrics — the PCR_QM contract (port of kss_icp_tpu/metrics.py).

Mirrors registrationMeasure.hpp:47-98: for every aligned source point, the
squared distance to its 1-NN in the target; MSE = mean of squares,
MAE = mean of distances, RMSE = sqrt(MSE). The 1-NN runs through the `nn1`
kernel on CUDA at every size (the K4 regime included) and through its plain
version on the CPU.
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from kss_icp_torch.core.cloud import PointCloud
from kss_icp_torch.ops.nn_cuda import nn1


def registration_measure_padded(
    aligned_points: torch.Tensor,
    aligned_mask: torch.Tensor,
    target_points: torch.Tensor,
    target_mask: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """MSE/RMSE/MAE of padded (Q, 3) aligned points against a padded (R, 3)
    target; or of a batch of pairs, (B, Q, 3) against (B, R, 3), as one nn1
    launch in which lane b queries cloud b, each value of shape (B,)."""
    d2, _ = nn1(aligned_points.contiguous(), target_points.contiguous(), target_mask.contiguous())
    w = aligned_mask.to(d2.dtype)
    n = w.sum(dim=-1).clamp_min(1.0)
    mse = (d2 * w).sum(dim=-1) / n
    mae = (torch.sqrt(d2) * w).sum(dim=-1) / n
    return {"mse": mse, "rmse": torch.sqrt(mse), "mae": mae}


def registration_measure(
    aligned: Union[PointCloud, np.ndarray, torch.Tensor],
    target: Union[PointCloud, np.ndarray, torch.Tensor],
    device="cuda",
) -> Dict[str, float]:
    """Host-facing MSE/RMSE/MAE (floats), computed on `device`."""
    if not isinstance(aligned, PointCloud):
        aligned = PointCloud.from_points(aligned, device=device)
    if not isinstance(target, PointCloud):
        target = PointCloud.from_points(target, device=device)
    aligned, target = aligned.to(device), target.to(device)
    out = registration_measure_padded(aligned.points, aligned.mask, target.points, target.mask)
    return {k: float(v) for k, v in out.items()}
