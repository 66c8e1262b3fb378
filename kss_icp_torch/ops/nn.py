"""Plain PyTorch 1-NN ops: the CPU path and the reference of the CUDA kernels.

Port of the contracts in kss_icp_tpu/ops/nn.py and ops/nn_pallas.py. Every
distance that feeds a min or an argmin is computed in exact float32
difference form, in the kernels' order, ((dx² + dy²) + dz²) + bias, where
bias is 0 for a valid reference row and 1e30 for a masked one — never the
‖a‖²+‖b‖²−2ab expansion. Ties go to the first index. The query axis is
chunked so that a (Q, R) block never exceeds `_BLOCK_ELEMS` elements.
"""

from __future__ import annotations

from typing import Tuple

import torch

BIG = 1e30
_BLOCK_ELEMS = 1 << 24


def _ref_bias(ref_mask: torch.Tensor) -> torch.Tensor:
    """0 for valid reference rows, 1e30 for masked ones (float32)."""
    big = torch.tensor(BIG, dtype=torch.float32, device=ref_mask.device)
    return torch.where(ref_mask, torch.zeros_like(big), big)


def _min_rel(query: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw running min of ((dx²+dy²)+dz²)+bias and its first argmin.

    query (..., Q, 3), ref (..., R, 3), ref_mask (..., R); leading dims
    broadcast. Returns ((..., Q) float32, (..., Q) int64)."""
    bias = _ref_bias(ref_mask)[..., None, :]
    rx, ry, rz = (ref[..., None, :, k] for k in range(3))
    q_n, r_n = query.shape[-2], ref.shape[-2]
    lead = torch.broadcast_shapes(query.shape[:-2], ref.shape[:-2])
    rows = max(1, _BLOCK_ELEMS // max(1, r_n * max(1, lead.numel())))
    mins, args = [], []
    for q0 in range(0, q_n, rows):
        q = query[..., q0:q0 + rows, :]
        dx = q[..., :, None, 0] - rx
        dy = q[..., :, None, 1] - ry
        dz = q[..., :, None, 2] - rz
        rel = dx * dx + dy * dy + dz * dz + bias
        arg = torch.argmin(rel, dim=-1)
        mins.append(torch.take_along_dim(rel, arg[..., None], dim=-1)[..., 0])
        args.append(arg)
    return torch.cat(mins, dim=-1), torch.cat(args, dim=-1)


def nearest_neighbor(query: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-NN of each query point among valid reference points.

    Returns (sq_distances (..., Q) float32, indices (..., Q) int32). A fully
    masked reference gives 1e30 (nn_pallas.py:138-141)."""
    m, arg = _min_rel(query, ref, ref_mask)
    d2 = torch.where(m >= BIG / 2, torch.full_like(m, BIG), m.clamp_min(0.0))
    return d2, arg.to(torch.int32)


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of values over the valid entries of the last axis (0 if none)."""
    w = mask.to(values.dtype)
    return (values * w).sum(dim=-1) / w.sum(dim=-1).clamp_min(1.0)


def masked_mean_nn_distance(query: torch.Tensor, query_mask: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor) -> torch.Tensor:
    """Mean 1-NN distance over valid query points — the "ave" rotation-field
    error (initRegistrationKSS.hpp:430-450) and the field kernel's contract:
    sqrt(max(min, 0)) of the raw biased min, weighted by the query mask."""
    m, _ = _min_rel(query, ref, ref_mask)
    return masked_mean(torch.sqrt(m.clamp_min(0.0)), query_mask)


def nn_distances(query: torch.Tensor, query_mask: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor) -> torch.Tensor:
    """Each valid query point's 1-NN distance, sqrt(max(min, 0)) of the raw
    biased min as `masked_mean_nn_distance` takes it, and 0 at a masked query
    point: the per-point values of the "trim" field and the contract of the
    `field_trim` kernel's per-point mode. A fully masked reference gives 1e15."""
    return torch.sqrt(nn_sqdistances(query, query_mask, ref, ref_mask).clamp_min(0.0))


def nn_sqdistances(query: torch.Tensor, query_mask: torch.Tensor, ref: torch.Tensor,
                   ref_mask: torch.Tensor) -> torch.Tensor:
    """Each valid query point's raw biased min ((dx² + dy²) + dz²) + bias, the
    squared 1-NN distance, and 0 at a masked query point: the per-point
    values of the "max" and "diff" fields and the contract of the field
    kernel's squared per-point mode (`field_sq`). A fully masked reference
    gives 1e30, as JAX's where(ref_mask, d², 1e30) does."""
    m, _ = _min_rel(query, ref, ref_mask)
    return torch.where(query_mask, m, torch.zeros_like(m))


def sq_error(min_d2: torch.Tensor, query_mask: torch.Tensor, metric: str) -> torch.Tensor:
    """The "max" or "diff" error from the squared 1-NN distances along the
    last axis (kss_icp_tpu/ops/nn.py:188-194): "max" is the largest squared
    distance, never its root (initRegistration_Error, a quirk of the
    reference kept); "diff" the largest distance less the mean, in JAX's
    order: sum(d w) / max(sum w, 1), the max over where(mask, d, -1e30)."""
    mask = query_mask.expand(min_d2.shape)
    neg = torch.full_like(min_d2, -BIG)
    if metric == "max":
        return torch.where(mask, min_d2, neg).amax(dim=-1)
    d = torch.sqrt(min_d2)
    return torch.where(mask, d, neg).amax(dim=-1) - masked_mean(d, mask)


def masked_mean_nn_sqdist(query: torch.Tensor, query_mask: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor) -> torch.Tensor:
    """Mean squared 1-NN distance — PCL's getFitnessScore contract."""
    d2, _ = nearest_neighbor(query, ref, ref_mask)
    return masked_mean(d2, query_mask)


# _trim_count's 1e-3 guard absorbs the float32 rounding of q * n_valid only
# while n_valid * 1.2e-7 < 1e-3, that is below 8192 valid points.
QUANTILE_MAX_WIDTH = 8192


def _trim_count(nvalid: torch.Tensor, q: float) -> torch.Tensor:
    """ceil(q * nvalid) in float32 with a 1e-3 guard, so that an exact-integer
    product that rounds up by an ulp (0.7 * 1000 -> 700.00006) keeps its rank
    (kss_icp_tpu/ops/nn.py:134-141)."""
    return torch.ceil(q * nvalid.to(torch.float32) - 1e-3).to(torch.int32)


def _sorted_rank(values: torch.Tensor, mask: torch.Tensor, q: float, name: str):
    """(ascending stable sort of the values with invalid entries at 1e30,
    the rank k = ceil(q * n_valid) clipped to [1, max(n_valid, 1)])."""
    if values.shape[-1] >= QUANTILE_MAX_WIDTH:
        raise ValueError(f"{name} takes fewer than {QUANTILE_MAX_WIDTH} values "
                         f"per row (the rank's rounding guard), got {values.shape[-1]}")
    vm = torch.where(mask, values, torch.full_like(values, BIG))
    vs = torch.sort(vm, dim=-1, stable=True).values
    nvalid = mask.sum(dim=-1, dtype=torch.int32)
    k = torch.minimum(_trim_count(nvalid, q).clamp_min(1), nvalid.clamp_min(1))
    return vs, k


def masked_quantile_threshold(values: torch.Tensor, mask: torch.Tensor, q: float) -> torch.Tensor:
    """The q-quantile of the valid values along the last axis: the value at
    rank ceil(q * n_valid), clipped to [1, max(n_valid, 1)], of the ascending
    stable sort with invalid entries set to 1e30 (kss_icp_tpu/ops/nn.py:144-157).

    Raises ValueError for a last axis of 8192 or more, where the rank's
    rounding guard no longer holds."""
    vs, k = _sorted_rank(values, mask, q, "masked_quantile_threshold")
    return torch.take_along_dim(vs, (k - 1).long()[..., None], dim=-1)[..., 0]


def trimmed_masked_mean(values: torch.Tensor, mask: torch.Tensor, trim_fraction: float) -> torch.Tensor:
    """Mean of the smallest ceil(q * n_valid) valid values along the last
    axis, the rank clipped as in `masked_quantile_threshold`
    (kss_icp_tpu/ops/nn.py:113-131): the cumulative sum of the same sort,
    read at that rank. The overlap tier's score: on partially overlapping
    clouds the largest NN distances come from the non-overlap region."""
    vs, k = _sorted_rank(values, mask, trim_fraction, "trimmed_masked_mean")
    picked = torch.take_along_dim(torch.cumsum(vs, dim=-1), (k - 1).long()[..., None], dim=-1)[..., 0]
    return picked / k.to(values.dtype)


def masked_nn_error(query: torch.Tensor, query_mask: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor,
                    metric: str = "ave", trim_fraction: float = 0.7) -> torch.Tensor:
    """The rotation-field error of kss_icp_tpu/ops/nn.py:160-199, from exact
    float32 differences: "ave" (the mean 1-NN distance), "max" (the largest
    squared 1-NN distance), "diff" (the largest 1-NN distance less the mean;
    both `sq_error`) and "trim" (the mean of the best trim_fraction quantile
    of the 1-NN distances)."""
    if metric == "ave":
        return masked_mean_nn_distance(query, query_mask, ref, ref_mask)
    if metric == "trim":
        d = nn_distances(query, query_mask, ref, ref_mask)
        return trimmed_masked_mean(d, query_mask.expand(d.shape), trim_fraction)
    if metric in ("max", "diff"):
        return sq_error(nn_sqdistances(query, query_mask, ref, ref_mask), query_mask, metric)
    raise ValueError(f"unknown error metric {metric!r}")


# (rows, R) elements of one sorted k-NN block: bounds the temporaries at any R.
_KNN_BLOCK_ELEMS = 1 << 22


def _sqdist(query: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor) -> torch.Tensor:
    """Exact float32 (dx² + dy²) + dz², 1e30 at a masked reference row."""
    d = query[..., :, None, :] - ref[..., None, :, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    return torch.where(ref_mask[..., None, :], d2, torch.full_like(d2, BIG))


def knn(query: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-NN squared distances and indices, ascending (kss_icp_tpu/ops/nn.py:219-330):
    the reference's 12-NN radius estimate (ballRegionCompute.hpp:477-530).

    query (..., Q, 3), ref (..., R, 3), ref_mask (..., R). Returns ((..., Q, k)
    float32, (..., Q, k) int64); a masked reference row scores 1e30. Each
    block of query rows (at most `_KNN_BLOCK_ELEMS` (..., rows, R) elements) is
    sorted whole by a stable sort, so ties go to the lower index, as
    `jax.lax.top_k` orders them. The blocks keep the memory bounded at any R,
    which is what the JAX package's streaming path (reference tiles with a
    running top-k merge) is for; its answer is this one's. The distances are
    exact float32 differences, where JAX's dense path takes the
    ‖a‖² + ‖b‖² − 2ab expansion, so the two agree to rounding (rtol 1e-5) and
    the port's order is the exact one. Refuses k above R, as `jax.lax.top_k`
    does."""
    q, r = query.shape[-2], ref.shape[-2]
    if k > r:
        raise ValueError(f"knn: k={k} is larger than the {r} reference rows")
    lead = torch.broadcast_shapes(query.shape[:-2], ref.shape[:-2], ref_mask.shape[:-1]).numel()
    rows = max(1, _KNN_BLOCK_ELEMS // max(1, r * lead))
    d2, idx = [], []
    for i in range(0, q, rows):
        vals, ix = torch.sort(_sqdist(query[..., i:i + rows, :], ref, ref_mask), dim=-1, stable=True)
        d2.append(vals[..., :k])
        idx.append(ix[..., :k])
    return torch.cat(d2, dim=-2), torch.cat(idx, dim=-2)
