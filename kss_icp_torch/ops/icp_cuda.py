"""Wrapper of the `icp_update` CUDA kernel (csrc/icp_step.cu): the whole update of
one lockstep ICP step after its `nn1` launch, one launch for every lane.

Replaces no Pallas TPU kernel: JAX's step (kss_icp_tpu/models/icp.py:191-300)
is one XLA program under a vmapped while_loop. The eager step it replaces,
`icp_update_plain` below (the body of models/icp.py's loop), costs about a
hundred small launches and two syncs inside CUDA's `torch.linalg.svd` a step.
On CPU tensors the wrapper runs the plain version; on CUDA tensors it launches
the kernel or raises. `svd3_jacobi` is the kernel's 3 x 3 solve in PyTorch,
float64, operation for operation: the tests hold it to `torch.linalg.svd`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from kss_icp_torch.core.transforms import matmul3, matvec3, rotate_points

SWEEPS = 16         # Jacobi sweeps at the most (csrc/icp_step.cu kSweeps)
JACOBI_TOL = 1e-15  # kJacobiTol
RANK_TOL = 1e-12    # kRankTol


class ICPState(NamedTuple):
    """The lanes' state between lockstep steps (models/icp.py::icp)."""

    rotation: torch.Tensor     # (L, 3, 3) float32
    translation: torch.Tensor  # (L, 3)
    scale: torch.Tensor        # (L,)
    corr_mse: torch.Tensor     # (L,) the last step's correspondence MSE
    iteration: torch.Tensor    # (L,) int32
    converged: torch.Tensor    # (L,) bool
    active: torch.Tensor       # (L,) bool: iteration < max_iterations and not converged


def positions(source: torch.Tensor, rotation: torch.Tensor, translation: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """s R x + t of each lane's source points, (L, N, 3), contiguous."""
    return (scale[:, None, None] * rotate_points(rotation, source) + translation[:, None, :]).contiguous()


def _where(active: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    return torch.where(active.reshape(active.shape + (1,) * (new.dim() - 1)), new, old)


def icp_update_plain(cur, d2, idx, source, source_mask, target, lane_ref, state: ICPState, params,
                     threshold: Optional[torch.Tensor] = None, estimate_scale: bool = False,
                     target_normals: Optional[torch.Tensor] = None, group=None, stop=None, step: int = 0):
    """The plain PyTorch version of `icp_update`, with the same arguments, and
    the eager step of the paths the kernel does not take: point-to-plane
    (`target_normals` given, each lane's correspondences' normals gathered
    from its own cloud) and a point axis sharded over the process `group`
    (every sum all-reduced before it is used). `stop` and `step` are unused.

    Returns (the new state, the next positions, active.any())."""
    # models/icp.py imports this module.
    from kss_icp_torch.models.icp import all_sum, kabsch, point_to_plane_step

    dtype = cur.dtype
    rot, trans, scale, corr_mse, iteration, converged, active = state
    max_d2 = torch.tensor(params.max_correspondence_distance, dtype=dtype) ** 2
    tiny = torch.finfo(dtype).tiny
    ref_row = lane_ref.long()[:, None]
    keep = source_mask & (d2 <= max_d2)
    if threshold is not None:
        keep = keep & (d2 <= threshold[:, None])
    w = keep.to(dtype)
    corr = target[ref_row, idx.long()]
    if target_normals is not None:
        dr, dt = point_to_plane_step(cur, corr, target_normals[ref_row, idx.long()], w, group)
        ds = torch.ones_like(scale)
    elif estimate_scale:
        dr, dt, ds = kabsch(cur, corr, w, estimate_scale=True, group=group)
    else:
        (dr, dt), ds = kabsch(cur, corr, w, group=group), torch.ones_like(scale)
    # new(x) = ds·dr·(s·R·x + t) + dt
    new_r = matmul3(dr, rot)
    new_t = ds[:, None] * matvec3(dr, trans) + dt
    new_s = ds * scale

    # Convergence MSE from the matched pairs in exact f32 (icp.py:293-301).
    wsum = all_sum(w.sum(dim=-1), group).clamp_min(1.0)
    diff = cur - corr
    d2_exact = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] + diff[..., 2] * diff[..., 2]
    new_mse = all_sum((d2_exact * w).sum(dim=-1), group) / wsum

    trans_delta2 = dt[:, 0] * dt[:, 0] + dt[:, 1] * dt[:, 1] + dt[:, 2] * dt[:, 2]
    cos_angle = (dr[:, 0, 0] + dr[:, 1, 1] + dr[:, 2, 2] - 1.0) / 2.0
    transform_small = (trans_delta2 < params.transformation_epsilon) & (
        (1.0 - cos_angle) < params.rotation_epsilon)
    if estimate_scale:
        transform_small = transform_small & ((ds - 1.0) ** 2 < params.transformation_epsilon)
    mse_delta = (new_mse - corr_mse).abs()
    if params.relative_mse:
        mse_delta = mse_delta / new_mse.clamp_min(tiny)
    mse_small = mse_delta < params.euclidean_fitness_epsilon
    new_conv = (iteration > 0) & (transform_small | mse_small)

    rot = _where(active, new_r, rot)
    trans = _where(active, new_t, trans)
    scale = _where(active, new_s, scale)
    corr_mse = _where(active, new_mse, corr_mse)
    converged = _where(active, new_conv, converged)
    iteration = _where(active, iteration + 1, iteration)
    active = (iteration < params.max_iterations) & ~converged
    state = ICPState(rot, trans, scale, corr_mse, iteration, converged, active)
    return state, positions(source, rot, trans, scale), active.any()


def icp_update(cur, d2, idx, source, source_mask, target, lane_ref, state: ICPState, params,
               threshold: Optional[torch.Tensor] = None, estimate_scale: bool = False,
               stop: Optional[torch.Tensor] = None, step: int = 0):
    """One lockstep point-to-point ICP step after `nn1`, for every lane.

    cur (L, N, 3) float32, the positions nn1 was given; d2 (L, N) float32 and
    idx (L, N) int32, its answers against target (G, T, 3) float32, lane l's
    cloud lane_ref[l] (L,) int32; source (L, N, 3) float32 and source_mask
    (L, N) bool, each lane's points; state an ICPState; params an ICPParams;
    threshold (L,) float32, the lanes' trim quantile of d2, or None;
    estimate_scale solves Umeyama's scale and gates on it. stop (2,) int32,
    zeroed before a call's first step and kept between its steps; `step`
    counts the call's steps from 0.

    Updates the state and cur in place (a lane inactive on entry keeps its
    bits) and returns (state, cur, flag): flag, a 0-dim int32 view of stop, is
    1 where some lane is still active, the one value the host reads a step.
    The kernel sums in float64 and solves Kabsch by a float64 Jacobi SVD, so
    its bits differ from the plain version's float32 sums and LAPACK or
    cuSOLVER SVD (within 2e-5, tests/test_torch_card.py); a lane's bits do not
    depend on the other lanes."""
    if cur.device.type == "cpu":
        return icp_update_plain(cur, d2, idx, source, source_mask, target, lane_ref, state, params, threshold,
                                estimate_scale)
    if cur.device.type != "cuda":
        raise ValueError(f"icp_update runs on cpu or cuda tensors, not {cur.device}")
    if cur.dim() != 3 or cur.shape[-1] != 3 or target.dim() != 3 or target.shape[-1] != 3:
        raise ValueError(f"expected cur (L, N, 3) and target (G, T, 3), got {tuple(cur.shape)}, "
                         f"{tuple(target.shape)}")
    lanes, n = cur.shape[:2]
    groups, t_n = target.shape[:2]
    if groups == 0 or t_n == 0:
        raise ValueError(f"icp_update needs a target with rows, got {tuple(target.shape)}")
    rot, trans, scale, corr_mse, iteration, converged, active = state
    if stop is None or stop.shape != (2,):
        raise ValueError("icp_update needs a (2,) int32 stop buffer")
    expected = ((cur, torch.float32, (lanes, n, 3), "cur"), (d2, torch.float32, (lanes, n), "d2"),
                (idx, torch.int32, (lanes, n), "idx"), (source, torch.float32, (lanes, n, 3), "source"),
                (source_mask, torch.bool, (lanes, n), "source_mask"), (target, torch.float32, None, "target"),
                (lane_ref, torch.int32, (lanes,), "lane_ref"), (rot, torch.float32, (lanes, 3, 3), "rotation"),
                (trans, torch.float32, (lanes, 3), "translation"), (scale, torch.float32, (lanes,), "scale"),
                (corr_mse, torch.float32, (lanes,), "corr_mse"), (iteration, torch.int32, (lanes,), "iteration"),
                (converged, torch.bool, (lanes,), "converged"), (active, torch.bool, (lanes,), "active"),
                (stop, torch.int32, None, "stop"))
    if threshold is not None:
        expected += ((threshold, torch.float32, (lanes,), "threshold"),)
    for t, dtype, shape, name in expected:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if shape is not None and t.shape != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != cur.device:
            raise ValueError(f"icp_update inputs on different devices: {cur.device} and {t.device}")
    from kss_icp_torch import _build

    lib = _build.library()
    parity = step % 2
    with torch.cuda.device(cur.device):
        code = lib.kss_icp_update(
            cur.data_ptr(), d2.data_ptr(), idx.data_ptr(), source.data_ptr(), source_mask.data_ptr(),
            target.data_ptr(), lane_ref.data_ptr(), None if threshold is None else threshold.data_ptr(),
            rot.data_ptr(), trans.data_ptr(), scale.data_ptr(), corr_mse.data_ptr(), iteration.data_ptr(),
            converged.data_ptr(), active.data_ptr(), stop.data_ptr(), lanes, n, groups, t_n,
            float(np.float32(params.max_correspondence_distance) ** 2), params.transformation_epsilon,
            params.rotation_epsilon, params.euclidean_fitness_epsilon, int(params.relative_mse),
            int(estimate_scale), params.max_iterations, parity, torch.cuda.current_stream().cuda_stream)
    _build.check(code, "icp_update")
    icp_update.launches += 1
    return state, cur, stop[parity]


icp_update.launches = 0


def svd3_jacobi(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's Kabsch solve (csrc/icp_step.cu::svd_rotation) in float64:
    for H (..., 3, 3) = U S V^T, the proper rotation R = V diag(1, 1, d) U^T,
    d = det(V U^T), and trace(diag(1, 1, d) S), Umeyama's numerator.

    One-sided cyclic Jacobi on the columns of A = H V (at most SWEEPS sweeps
    of the pairs (0, 1), (0, 2), (1, 2), a pair rotated while |a_p . a_q| >
    JACOBI_TOL |a_p| |a_q|), the columns sorted by norm, descending; U
    completed from its first two columns (u3 = u1 x u2; u2 orthogonal to u1
    when |a2 - (a2 . u1) u1| <= RANK_TOL sigma_1), so a planar H gives the
    unique proper rotation and a rank-1 H a proper one; R = v1 u1^T + v2 u2^T
    + (v1 x v2) u3^T. H = 0 gives R = I and 0."""
    h = h.to(torch.float64)
    a = [[h[..., i, j] for j in range(3)] for i in range(3)]
    one, zero = torch.ones_like(h[..., 0, 0]), torch.zeros_like(h[..., 0, 0])
    v = [[one if i == j else zero for j in range(3)] for i in range(3)]

    def col_dot(m, p, q):
        return (m[0][p] * m[0][q] + m[1][p] * m[1][q]) + m[2][p] * m[2][q]

    for _ in range(SWEEPS):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            alpha, beta, gamma = col_dot(a, p, p), col_dot(a, q, q), col_dot(a, p, q)
            turn = gamma.abs() > JACOBI_TOL * torch.sqrt(alpha * beta)
            zeta = (beta - alpha) / (2.0 * gamma)
            t = torch.copysign(one, zeta) / (zeta.abs() + torch.sqrt(1.0 + zeta * zeta))
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = c * t
            for m in (a, v):
                for i in range(3):
                    mp, mq = m[i][p], m[i][q]
                    m[i][p] = torch.where(turn, c * mp - s * mq, mp)
                    m[i][q] = torch.where(turn, s * mp + c * mq, mq)
    sig = [torch.sqrt(col_dot(a, j, j)) for j in range(3)]
    for p in (0, 1, 0):
        q = p + 1
        swap = sig[p] < sig[q]
        sig[p], sig[q] = torch.where(swap, sig[q], sig[p]), torch.where(swap, sig[p], sig[q])
        for m in (a, v):
            for i in range(3):
                m[i][p], m[i][q] = torch.where(swap, m[i][q], m[i][p]), torch.where(swap, m[i][p], m[i][q])

    def vec(m, j):
        return torch.stack([m[0][j], m[1][j], m[2][j]], dim=-1)

    def dot3(x, y):
        return (x[..., 0] * y[..., 0] + x[..., 1] * y[..., 1]) + x[..., 2] * y[..., 2]

    def cross(x, y):
        return torch.stack([x[..., 1] * y[..., 2] - x[..., 2] * y[..., 1],
                            x[..., 2] * y[..., 0] - x[..., 0] * y[..., 2],
                            x[..., 0] * y[..., 1] - x[..., 1] * y[..., 0]], dim=-1)

    full = sig[0] > 0.0
    u1 = vec(a, 0) / sig[0][..., None]
    a2, a3, v1, v2, v3 = vec(a, 1), vec(a, 2), vec(v, 0), vec(v, 1), vec(v, 2)
    u2 = a2 - dot3(a2, u1)[..., None] * u1
    n2 = torch.sqrt(dot3(u2, u2))
    # Rank 1: u1 x e_k, e_k the axis of u1's smallest |component| (the first on ties).
    mag = u1.abs()
    k = torch.where(mag[..., 0] <= mag[..., 1], torch.where(mag[..., 0] <= mag[..., 2], 0, 2),
                    torch.where(mag[..., 1] <= mag[..., 2], 1, 2))
    alt = cross(u1, torch.nn.functional.one_hot(k, 3).to(torch.float64))
    flat = ~(n2 > RANK_TOL * sig[0])
    u2 = torch.where(flat[..., None], alt, u2)
    n2 = torch.where(flat, torch.sqrt(dot3(alt, alt)), n2)
    u2 = u2 / n2[..., None]
    u3, v3p = cross(u1, u2), cross(v1, v2)
    det_v = torch.where(dot3(v3p, v3) < 0.0, -one, one)
    r = (v1[..., :, None] * u1[..., None, :] + v2[..., :, None] * u2[..., None, :]) + v3p[..., :, None] * u3[..., None, :]
    trace_ds = (sig[0] + sig[1]) + det_v * dot3(a3, u3)
    eye = torch.eye(3, dtype=torch.float64).expand(r.shape)
    return torch.where(full[..., None, None], r, eye), torch.where(full, trace_ds, zero)
