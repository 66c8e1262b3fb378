"""Coarse alignment: exhaustive Euler rotation-grid search in pre-shape space.

Port of kss_icp_tpu/models/coarse.py (initRegistration_Rotation and
initRegistration_kernel, initRegistrationKSS.hpp:222-296,:481-522). The
"ave" field is scored by the `field_ave` kernel (method "vpu") or the
`field_dot` kernel (method "dot"); the overlap tier's "trim" field by the
`field_trim` kernel and the "max" and "diff" fields by `field_sq`, in exact
float32 differences whatever the method. Local
minima come from a 3-D min-pool whose -inf padding equals the reference's
clamped-edge cube.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from kss_icp_torch.core.transforms import euler_xyz_matrix
from kss_icp_torch.ops.coarse_cuda import field_ave, field_dot, field_sq, field_trim

BIG = 1e30


class CoarseResult(NamedTuple):  # each field gains a leading B for a batch of pairs
    field: torch.Tensor             # (steps, steps, steps) mean-NN-distance error
    best_angles: torch.Tensor       # (3,) Euler angles of the global minimum
    candidate_angles: torch.Tensor  # (K, 3) local-minimum angles, ascending error
    candidate_mask: torch.Tensor    # (K,) validity (False once minima run out)
    candidate_errors: torch.Tensor  # (K,) field values at the candidates


def grid_angles(steps: int, span: float, device="cpu") -> torch.Tensor:
    """Per-axis sweep values i*span/steps, i in [0, steps)."""
    return torch.arange(steps, dtype=torch.float32, device=device) * (span / steps)


def rotation_grid(steps: int, span: float, device="cpu") -> torch.Tensor:
    """All (steps^3, 3) Euler-angle triples in row-major (i, j, k) order."""
    a = grid_angles(steps, span, device)
    ii, jj, kk = torch.meshgrid(a, a, a, indexing="ij")
    return torch.stack([ii.reshape(-1), jj.reshape(-1), kk.reshape(-1)], dim=-1)


def score_rotation_field(
    source: torch.Tensor,
    source_mask: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    *,
    steps: int,
    span: float = 6.3,
    error_metric: str = "ave",
    method: str = "vpu",
    precision: str = "highest",
    trim_fraction: float = 0.7,
) -> torch.Tensor:
    """(steps, steps, steps) field: field[i, j, k] is the alignment error of
    Rz(k)·Ry(j)·Rx(i)·source to the target. error_metric "ave" is the mean
    1-NN distance: method "vpu" scores it with exact float32 differences
    (`field_ave`, which ignores precision, as the TPU kernel does), "dot"
    through the augmented dot product at `precision` (`field_dot`). "trim"
    is the mean of the best trim_fraction quantile of the 1-NN distances
    (`field_trim`), "max" the largest squared 1-NN distance and "diff" the
    largest distance less the mean (`field_sq`), always in exact float32
    differences: the port's rule where JAX takes its XLA path
    (kss_icp_tpu/models/coarse.py:113-131), whatever the method."""
    if error_metric not in ("ave", "trim", "max", "diff"):
        raise ValueError(f"unknown error metric {error_metric!r}")
    if method not in ("vpu", "dot"):
        raise ValueError(f"coarse method must be 'vpu' or 'dot', got {method!r}")
    rots = euler_xyz_matrix(rotation_grid(steps, span, source.device))
    if error_metric == "trim":
        scores = field_trim(source, source_mask, target, target_mask, rots, trim_fraction)
    elif error_metric in ("max", "diff"):
        scores = field_sq(source, source_mask, target, target_mask, rots, error_metric)
    elif method == "dot":
        scores = field_dot(source, source_mask, target, target_mask, rots, precision)
    else:
        scores = field_ave(source, source_mask, target, target_mask, rots)
    return scores.reshape(steps, steps, steps)


def local_minima_mask(field: torch.Tensor, radius: int) -> torch.Tensor:
    """True where field[..., i, j, k] <= every value in the clamped
    (2r+1)^3 cube; leading axes are a batch of fields."""
    w = 2 * radius + 1
    flat = field.reshape((-1, 1) + field.shape[-3:])
    pooled = -F.max_pool3d(-flat, kernel_size=w, stride=1, padding=radius)
    return field <= pooled.reshape(field.shape)


def coarse_align(
    source: torch.Tensor,
    source_mask: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    *,
    steps: int,
    span: float = 6.3,
    radius: int = 2,
    max_candidates: int = 32,
    error_metric: str = "ave",
    method: str = "vpu",
    precision: str = "highest",
    trim_fraction: float = 0.7,
) -> CoarseResult:
    """Score the grid, extract local minima, rank candidates by error.

    Candidate 0 is the global minimum. Ties keep index order, as
    jax.lax.top_k does (a stable sort, not torch.topk). Clouds with a
    leading pair axis, (B, P, 3) and (B, P), give a CoarseResult whose
    fields lead with B: one field launch per pair, the minima and the sort
    over the batch."""
    kw = dict(steps=steps, span=span, error_metric=error_metric, method=method, precision=precision,
              trim_fraction=trim_fraction)
    if source.dim() == 3:
        field = torch.stack([score_rotation_field(*clouds, **kw)
                             for clouds in zip(source, source_mask, target, target_mask)])
    else:
        field = score_rotation_field(source, source_mask, target, target_mask, **kw)
    is_min = local_minima_mask(field, radius)
    flat = field.reshape(field.shape[:-3] + (-1,))
    masked = torch.where(is_min.reshape(flat.shape), flat, torch.full_like(flat, BIG))
    neg_vals, order = torch.sort(-masked, dim=-1, descending=True, stable=True)
    flat_idx = order[..., :max_candidates]
    cand_errors = -neg_vals[..., :max_candidates]
    cand_mask = cand_errors < BIG / 2

    unit = span / steps

    def angles(i):
        return torch.stack([i // (steps * steps), (i // steps) % steps, i % steps], dim=-1).to(field.dtype) * unit

    return CoarseResult(
        field=field,
        best_angles=angles(torch.argmin(flat, dim=-1)),
        candidate_angles=angles(flat_idx),
        candidate_mask=cand_mask,
        candidate_errors=cand_errors,
    )
