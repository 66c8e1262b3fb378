"""Mesh triangle-angle statistics (port of kss_icp_tpu/measure_mesh.py; the
reference's MeshMeasure, meshMeasure.hpp:25-329, not in the reference build:
remesh-quality QA).

MeshMeasure_CountAngle emits every triangle's three interior angles; the
reference's driver program histograms them and counts the sliver angles.
Here the walk is three batched arccos evaluations over (F, 3) gathers, in
float32 on the device of the tensors given (the card unless the caller
passes `device="cpu"`), and the histogram is `jnp.histogram`'s: float32
edges from JAX's linspace over [0, float32(π)], bins half-open
[e_i, e_i+1) but the last, closed, a value's bin found by `searchsorted` on
those edges, so an equilateral triangle's π/3, an edge of the default 18
bins, counts in the bin it opens. Not `torch.histc`, whose arithmetic bin
index puts some values one float32 step below an edge in the bin above
(0.87266463 in bin 5, not 4).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


def triangle_angles(vertices, faces, device="cuda") -> torch.Tensor:
    """Interior angles (F, 3) in radians, float32, of each triangle's corners
    in face vertex order (meshMeasure.hpp:30-90: the angle at b1, b2, b3).
    Tensors stay on their device; arrays go to `device`."""
    if not isinstance(vertices, torch.Tensor):
        vertices = torch.as_tensor(np.asarray(vertices), device=device)
    vertices = vertices.to(torch.float32)
    faces = torch.as_tensor(faces, device=vertices.device).long()
    a, b, c = (vertices[faces[:, k]] for k in range(3))
    tiny = torch.finfo(torch.float32).tiny

    def corner(p, q, r):
        u, v = q - p, r - p
        num = (u * v).sum(dim=-1)
        den = torch.linalg.vector_norm(u, dim=-1) * torch.linalg.vector_norm(v, dim=-1)
        return torch.arccos((num / den.clamp_min(tiny)).clamp(-1.0, 1.0))

    return torch.stack([corner(a, b, c), corner(b, a, c), corner(c, a, b)], dim=-1)


def histogram_edges(bins: int, device=None) -> torch.Tensor:
    """jnp.histogram's bin edges over (0, π) for float32 values: the range in
    float32, then linspace as start + i * ((stop - start) / bins), its last
    edge the stop."""
    stop = torch.tensor(math.pi, dtype=torch.float32)
    edges = torch.arange(bins + 1, dtype=torch.float32) * (stop / bins)
    edges[-1] = stop
    return edges.to(device)


def angle_statistics(angles: torch.Tensor, bins: int = 18, sliver_threshold_deg: float = 30.0) -> Dict[str, np.ndarray]:
    """Min, max and mean angle, the [0, π] histogram (float32 counts, as
    jnp.histogram's), its edges, the count of angles below the sliver
    threshold and the number of angles (JAX measure_mesh.py:39-58). `angles`
    a tensor of any shape, or an array (counted on the host)."""
    flat = torch.as_tensor(angles, dtype=torch.float32).reshape(-1)
    edges = histogram_edges(bins, flat.device)
    idx = torch.searchsorted(edges, flat, right=True)
    idx = torch.where(flat == edges[-1], torch.full_like(idx, bins), idx)
    # Bin 0 takes values below the range and bin bins + 1 those above it: both dropped, as JAX drops them.
    hist = torch.bincount(idx, minlength=bins + 2)[1:bins + 1].to(torch.float32)
    sliver = torch.tensor(math.radians(sliver_threshold_deg), dtype=torch.float32)
    return {
        "min": flat.min().cpu().numpy(),
        "max": flat.max().cpu().numpy(),
        "mean": flat.mean().cpu().numpy(),
        "histogram": hist.cpu().numpy(),
        "bin_edges": edges.cpu().numpy(),
        "sliver_count": np.asarray((flat < sliver.to(flat.device)).sum().item()),
        "count": np.asarray(flat.shape[0]),
    }


def mesh_angle_report(vertices, faces, device="cuda", **kwargs) -> Dict[str, np.ndarray]:
    """MeshMeasure_CountAngle and its aggregate in one call."""
    return angle_statistics(triangle_angles(vertices, faces, device), **kwargs)
