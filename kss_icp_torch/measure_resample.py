"""Resampling-quality metric (port of kss_icp_tpu/measure_resample.py): the
reference's simMeasurement (pointCloudMeasure.hpp:127-281).

Every original point is projected onto the MLS surface of the simplified
cloud (Gaussian weights exp(-(d/h)^2), h the simplified cloud's support
radius; Newton steps x' = x - (n^T(a - x)) n, 10 of them) and the average and
largest displacement are reported beside the sampling rate. Each projection
step is a batched (N x M) weighted sum, over blocks of at most `_BLOCK_ELEMS`
(rows, M) elements, with squared distances in exact float32 differences
(ops/nn.py::exact_sqdist). The blended normal n = sum_j w_j n_j reads the
unoriented PCA normals of ops/normals.py::estimate_normals by default, as in
JAX, whose signs are the eigensolver's choice (LAPACK on the CPU, cuSOLVER
on the card, XLA's LAPACK in JAX, each its own): the displacements follow
those signs, by several percent on the test clouds (ROADMAP.md queue 3).
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from kss_icp_torch.ops.nn import exact_sqdist, knn_kth_sqdist
from kss_icp_torch.ops.normals import estimate_normals

# (rows, M) elements of one block of original points.
_BLOCK_ELEMS = 1 << 24


def simplification_measure(
    original: torch.Tensor,
    original_mask: torch.Tensor,
    simplified: torch.Tensor,
    simplified_mask: torch.Tensor,
    radius: Optional[Union[float, torch.Tensor]] = None,
    iterations: int = 10,
    normal_k: int = 12,
    normals: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Geometric error of `simplified` (M, 3) as a surface proxy for
    `original` (N, 3), both padded with masks (kss_icp_tpu/measure_resample.py:27-76).

    `normals`, (M, 3), replaces the simplified cloud's PCA normals
    (estimate_normals with k = normal_k, JAX's only choice): with the same
    normals the port gives JAX's displacements (rtol 1e-4,
    tests/test_torch_measure_resample.py), and with consistently oriented
    ones the blend no longer depends on the eigensolver's signs.

    Returns {"avg_displacement", "max_displacement", "sampling_rate"}, 0-d
    tensors on the inputs' device."""
    dtype = original.dtype
    eps = torch.finfo(dtype).tiny
    w_o = original_mask.to(dtype)
    w_s = simplified_mask.to(dtype)
    if radius is None:
        # The simplified cloud's BallRegion radius: the largest 12-NN
        # distance (ballRegionCompute.hpp:477-530, pointNumEsti=12).
        kth = knn_kth_sqdist(simplified, simplified, simplified_mask, min(13, simplified.shape[0]))
        radius = torch.where(simplified_mask, torch.sqrt(kth), torch.zeros_like(kth)).amax()
    radius = torch.as_tensor(radius, dtype=dtype, device=original.device)
    inv_h2 = 1.0 / (radius * radius).clamp_min(eps)
    if normals is None:
        normals = estimate_normals(simplified, simplified_mask, k=normal_k)

    rows = max(1, _BLOCK_ELEMS // max(1, simplified.shape[0]))
    projected = []
    for r0 in range(0, original.shape[0], rows):
        x = original[r0:r0 + rows]
        for _ in range(iterations):
            w = torch.exp(-exact_sqdist(x, simplified) * inv_h2) * w_s
            a = (w @ simplified) / w.sum(dim=1, keepdim=True).clamp_min(eps)  # the weighted anchor
            n = w @ normals
            n = n / torch.linalg.vector_norm(n, dim=1, keepdim=True).clamp_min(eps)
            # Move along the blended normal onto the local plane through a.
            x = x + (n * (a - x)).sum(dim=1, keepdim=True) * n
        projected.append(x)
    disp = torch.linalg.vector_norm(torch.cat(projected) - original, dim=1)
    n_o = w_o.sum().clamp_min(1.0)
    return {"avg_displacement": (disp * w_o).sum() / n_o,
            "max_displacement": torch.where(original_mask, disp, torch.full_like(disp, -1.0)).amax(),
            "sampling_rate": w_s.sum() / n_o}
