"""Padded, masked point clouds (port of kss_icp_tpu/core/cloud.py).

Every cloud is a fixed-shape (P, 3) tensor plus a (P,) validity mask, padded
to a multiple of 256, on an explicit device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class PointCloud:
    """points: (..., P, 3) float tensor, zeros in padded rows.
    mask:   (..., P) bool, True for valid points."""

    points: torch.Tensor
    mask: torch.Tensor

    @property
    def padded_size(self) -> int:
        return self.points.shape[-2]

    @property
    def count(self) -> torch.Tensor:
        return self.mask.sum(dim=-1)

    @classmethod
    def from_points(
        cls,
        points,
        pad_to: Optional[int] = None,
        multiple: int = 256,
        dtype: torch.dtype = torch.float32,
        device="cpu",
    ) -> "PointCloud":
        """Build a padded cloud from an (N, 3) array or tensor."""
        if isinstance(points, torch.Tensor):
            points = points.detach().cpu().numpy()
        pts = np.asarray(points, dtype=np.float64)
        if pts.ndim != 2 or pts.shape[1] != 3:
            raise ValueError(f"expected (N, 3) points, got {pts.shape}")
        n = pts.shape[0]
        p = pad_to if pad_to is not None else _round_up(max(n, 1), multiple)
        if p < n:
            raise ValueError(f"pad_to={p} < point count {n}")
        padded = np.zeros((p, 3), dtype=np.float64)
        padded[:n] = pts
        mask = np.zeros((p,), dtype=bool)
        mask[:n] = True
        return cls(points=torch.as_tensor(padded, dtype=dtype).to(device),
                   mask=torch.as_tensor(mask).to(device))

    def to(self, device) -> "PointCloud":
        return PointCloud(points=self.points.to(device), mask=self.mask.to(device))

    def to_numpy(self) -> np.ndarray:
        """Valid points only, as a host (N, 3) array."""
        return self.points.detach().cpu().numpy()[self.mask.cpu().numpy()]
