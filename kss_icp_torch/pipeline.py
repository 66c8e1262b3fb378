"""Preprocessing facade (port of kss_icp_tpu/pipeline.py): the reference's
`pointPipeline` (pointPipeline.hpp).

The reference exposes three init paths:
  1. from file, with [-1,1]³ uniform normalization, a `.normal` sidecar
     cache, and a BallRegion build (pointPipeline.hpp:40-68);
  2. from in-memory points, with PCL normals (:70-86);
  3. `pointPipeline_init_point_withoutUniform` (:88-101) — the registration
     path: AABB border only + BallRegion without normals.

Here the same three entries return a `PipelineState`: the padded points and
mask and the optional oriented normals on the host, the voxel grid
(ops/spatial.py = BallRegion) on the device, the global support radius and
the AABB border indices. The `.normal` sidecar is kept (same count format,
readable by the reference) and is additionally backed by a content-hashed
cache that cannot go stale (utils/cache.py). Every entry point runs on the
card unless the caller passes device="cpu".
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from kss_icp_torch.io.formats import (
    UniformInfo,
    border_indices,
    load_normals,
    load_points,
    save_normals,
    uniform_normalize,
)
from kss_icp_torch.models.kss_icp import _device
from kss_icp_torch.ops.normals import estimate_oriented_normals
from kss_icp_torch.ops.spatial import VoxelGrid, build_voxel_grid, estimate_box_scale, estimate_radius
from kss_icp_torch.utils.cache import ArrayCache, content_key

PathLike = Union[str, Path]


@dataclasses.dataclass
class PipelineState:
    """BallRegion-equivalent preprocessing product (padded)."""

    points: np.ndarray            # (P, 3) padded
    mask: np.ndarray              # (P,) bool
    count: int                    # valid points
    grid: VoxelGrid               # on the device
    boxes_per_axis: int
    radius: float                 # max 12-NN distance (BallRegion radius)
    border: np.ndarray            # [minX,minY,minZ,maxX,maxY,maxZ] indices
    normals: Optional[np.ndarray] = None   # (P, 3) oriented, or None
    uniform: Optional[UniformInfo] = None  # set when normalized to [-1,1]³


def _pad(points: np.ndarray, multiple: int = 256):
    pts = np.asarray(points, dtype=np.float32)
    n = pts.shape[0]
    p = ((n + multiple - 1) // multiple) * multiple
    padded = np.zeros((p, 3), np.float32)
    padded[:n] = pts
    mask = np.zeros((p,), bool)
    mask[:n] = True
    return padded, mask, n


def _build_state(points: np.ndarray, normals: Optional[np.ndarray], uniform: Optional[UniformInfo],
                 device: torch.device) -> PipelineState:
    padded, mask, n = _pad(points)
    nb = estimate_box_scale(n)
    pt, mt = torch.as_tensor(padded, device=device), torch.as_tensor(mask, device=device)
    padded_normals = None
    if normals is not None:
        padded_normals = np.zeros_like(padded)
        padded_normals[:n] = np.asarray(normals, np.float32)[:n]
    return PipelineState(
        points=padded, mask=mask, count=n, grid=build_voxel_grid(pt, mt, nb), boxes_per_axis=nb,
        radius=float(estimate_radius(pt, mt)), border=border_indices(np.asarray(points)), normals=padded_normals,
        uniform=uniform,
    )


def _oriented_normals(points: np.ndarray, cache: Optional[ArrayCache], device: torch.device) -> np.ndarray:
    """Oriented normals for raw (N, 3) points, memoized by content hash."""
    pts = np.asarray(points, np.float32)
    if cache is not None:
        key = content_key(pts, op="oriented_normals", k=20)
        hit = cache.get(key)
        if hit is not None and "normals" in hit:
            return hit["normals"]
    padded, mask, n = _pad(pts)
    nrm = estimate_oriented_normals(torch.as_tensor(padded, device=device),
                                    torch.as_tensor(mask, device=device)).cpu().numpy()[:n]
    if cache is not None:
        cache.put(key, normals=nrm)
    return nrm


def pipeline_from_file(
    path: PathLike,
    denoise: bool = False,
    uniform: bool = True,
    use_normal_sidecar: bool = True,
    cache: Optional[ArrayCache] = None,
    device="cuda",
) -> PipelineState:
    """pointPipeline_init (pointPipeline.hpp:40-68): load, optionally
    normalize to [-1,1]³, estimate oriented normals with a `.normal` sidecar
    cache, build the spatial index. `denoise` mirrors the reference flag
    (it routes through an extra octree pass there only for huge scans;
    here the voxel grid handles any N, so it is accepted and ignored)."""
    del denoise
    device = _device(device)
    path = Path(path)
    pts = load_points(path)
    info = None
    if uniform:
        pts, info = uniform_normalize(pts)

    normals = None
    sidecar = path.with_suffix(".normal")
    if use_normal_sidecar and sidecar.exists():
        cached = load_normals(sidecar)
        if cached.shape[0] == pts.shape[0]:
            normals = cached.astype(np.float32)
    if normals is None:
        normals = _oriented_normals(pts, cache, device)
        if use_normal_sidecar:
            try:
                save_normals(sidecar, normals)
            except OSError:
                pass  # read-only data dir: content cache still holds it
    return _build_state(pts, normals, info, device)


def pipeline_from_points(points: np.ndarray, cache: Optional[ArrayCache] = None, device="cuda") -> PipelineState:
    """pointPipeline_init_point (:70-86): in-memory cloud, with normals."""
    device = _device(device)
    pts = np.asarray(points, np.float64)
    return _build_state(pts, _oriented_normals(pts, cache, device), None, device)


def pipeline_from_points_without_uniform(points: np.ndarray, device="cuda") -> PipelineState:
    """pointPipeline_init_point_withoutUniform (:88-101) — the registration
    path: no normalization, no normals; border + spatial index only."""
    return _build_state(np.asarray(points, np.float64), None, None, _device(device))
