"""Batched ICP: point-to-point with Kabsch/SVD updates, or point-to-plane.

Port of kss_icp_tpu/models/icp.py (pcl::IterativeClosestPoint as configured
by KSS_ICP.hpp:155-162). JAX runs one `lax.while_loop` per lane under
`vmap`, which executes in lockstep: the loop goes on while any lane is
active, and a finished lane keeps its state. Here that is a Python loop over
iterations with all lanes batched, `torch.where` freezing the finished lanes,
and one host sync per iteration for the "any lane active" test. Per-lane
`iterations` and `converged` equal the reference's.

Correspondences come from the `nn1` kernel (one launch per iteration for all
lanes). Each lane may have its own target cloud (`lane_ref`), so the lanes of
a batch of pairs run in one loop (models/kss_icp.py::register_batch): JAX
vmaps the single-pair solve over pairs, which is the same lockstep. `trim_fraction` and `estimate_scale` give the overlap tier's trimmed
similarity ICP (icp.py:226-232): a per-lane quantile gate on the
correspondences, the Umeyama scale, and the trimmed mean as fitness.
`variant="point_to_plane"` takes the linearized point-to-plane step
(icp.py:136-170) against the target's normals, ahead of `estimate_scale`, as
in JAX. The sharded point axis is not ported (ROADMAP.md queue 1 item 13).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from kss_icp_torch.core.transforms import matmul3, matvec3, rotate_points
from kss_icp_torch.ops.nn import masked_quantile_threshold, trimmed_masked_mean
from kss_icp_torch.ops.nn_cuda import lane_refs, nn1


class ICPParams(NamedTuple):
    max_iterations: int
    max_correspondence_distance: float
    transformation_epsilon: float   # squared translation-delta gate
    rotation_epsilon: float         # 1 - cos(angle-delta) gate
    euclidean_fitness_epsilon: float  # correspondence-MSE delta gate
    relative_mse: bool              # True = relative delta (PCL parity)

    @classmethod
    def from_config(cls, cfg) -> "ICPParams":
        return cls(
            max_iterations=int(cfg.max_icp_iterations),
            max_correspondence_distance=float(cfg.max_correspondence_distance),
            transformation_epsilon=float(cfg.transformation_epsilon),
            rotation_epsilon=float(cfg.rotation_epsilon),
            euclidean_fitness_epsilon=float(cfg.euclidean_fitness_epsilon),
            relative_mse=cfg.fitness_epsilon_mode == "relative",
        )


class ICPResult(NamedTuple):
    rotation: torch.Tensor     # (L, 3, 3) accumulated rigid rotation
    translation: torch.Tensor  # (L, 3)
    fitness: torch.Tensor      # (L,) mean squared NN distance over valid points
    iterations: torch.Tensor   # (L,) int32
    converged: torch.Tensor    # (L,) bool
    scale: torch.Tensor        # (L,) accumulated scale (stays at its init unless estimate_scale)


def kabsch(source: torch.Tensor, target: torch.Tensor, weights: torch.Tensor, estimate_scale: bool = False):
    """Weighted rigid Kabsch over lanes: argmin_R,t sum w ||R s + t - t'||².

    source, target (L, N, 3); weights (L, N). Returns (R (L, 3, 3), t (L, 3)),
    with the determinant correction so that R is a proper rotation; with
    estimate_scale, (R, t, s (L,)), the Umeyama similarity
    argmin_s,R,t sum w ||s R x + t - y||², s = trace(D S) / var_src
    (kss_icp_tpu/models/icp.py:61-114)."""
    dtype = source.dtype
    wsum = weights.sum(dim=-1).clamp_min(torch.finfo(dtype).tiny)
    w = weights[..., None]
    cs = (w * source).sum(dim=-2) / wsum[..., None]
    ct = (w * target).sum(dim=-2) / wsum[..., None]
    s0 = source - cs[..., None, :]
    t0 = target - ct[..., None, :]
    h = (w[..., None] * s0[..., :, None] * t0[..., None, :]).sum(dim=-3) / wsum[..., None, None]
    u, sv, vh = torch.linalg.svd(h)
    v, ut = vh.transpose(-1, -2), u.transpose(-1, -2)
    det = torch.linalg.det(matmul3(v, ut))
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    r = matmul3(v * d[..., None, :], ut)
    if not estimate_scale:
        return r, ct - matvec3(r, cs)
    var_s = (weights * (s0 * s0).sum(dim=-1)).sum(dim=-1) / wsum
    scale = (sv * d).sum(dim=-1) / var_s.clamp_min(torch.finfo(dtype).tiny)
    return r, ct - scale[..., None] * matvec3(r, cs), scale


def _rodrigues(omega: torch.Tensor) -> torch.Tensor:
    """exp([w]x) of small rotation vectors (L, 3) -> (L, 3, 3)
    (kss_icp_tpu/models/icp.py:117-133); the identity below 1e-12 rad."""
    theta = torch.linalg.norm(omega, dim=-1)
    k = omega / theta.clamp_min(1e-12)[:, None]
    zero = torch.zeros_like(theta)
    kx = torch.stack([torch.stack([zero, -k[:, 2], k[:, 1]], -1), torch.stack([k[:, 2], zero, -k[:, 0]], -1),
                      torch.stack([-k[:, 1], k[:, 0], zero], -1)], dim=-2)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(kx.shape)
    r = eye + torch.sin(theta)[:, None, None] * kx + (1.0 - torch.cos(theta))[:, None, None] * matmul3(kx, kx)
    return torch.where((theta < 1e-12)[:, None, None], eye, r)


def point_to_plane_step(source: torch.Tensor, target: torch.Tensor, target_normals: torch.Tensor,
                        weights: torch.Tensor):
    """The linearized point-to-plane update of each lane (Chen & Medioni;
    kss_icp_tpu/models/icp.py:136-170): minimize sum w (n · (R p + t − q))²
    with R ≈ I + [w]x through the 6 x 6 normal equations, damped by 1e-6 I,
    then R = exp([w]x). Not in the reference (PCL is point-to-point): the
    opt-in icp_variant="point_to_plane". source, target, target_normals
    (L, N, 3), weights (L, N). Returns (R (L, 3, 3), t (L, 3)). Negating a
    normal negates its row of A and its residual, so AᵀA and Aᵀb keep their
    bits: unoriented normals do."""
    n = target_normals
    r = (n * (source - target)).sum(dim=-1)  # (L, N) signed residuals
    a = torch.cat([torch.linalg.cross(source, n, dim=-1), n], dim=-1)  # (L, N, 6)
    aw = a * weights[..., None]
    ata = aw.transpose(-1, -2) @ a
    atb = (aw.transpose(-1, -2) @ -r[..., None])[..., 0]
    eye = torch.eye(6, dtype=source.dtype, device=source.device)
    # solve_ex: no error check, so no host sync a step; an exactly singular
    # system gives non-finite values, as jnp.linalg.solve does, and no raise.
    x = torch.linalg.solve_ex(ata + 1e-6 * eye, atb)[0]
    return _rodrigues(x[:, :3]), x[:, 3:]


def _where(active: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    return torch.where(active.reshape(active.shape + (1,) * (new.dim() - 1)), new, old)


def icp(
    source: torch.Tensor,
    source_mask: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    params: ICPParams,
    init_rotation: Optional[torch.Tensor] = None,
    init_translation: Optional[torch.Tensor] = None,
    init_scale: Optional[torch.Tensor] = None,
    trim_fraction: float = 0.0,
    estimate_scale: bool = False,
    lane_ref: Optional[torch.Tensor] = None,
    variant: str = "point_to_point",
    target_normals: Optional[torch.Tensor] = None,
) -> ICPResult:
    """Run ICP on L lanes from identity (or a warm start).

    source (L, N, 3); source_mask (N,) or (L, N); target (T, 3) with
    target_mask (T,), one target for every lane, or (G, T, 3) with (G, T)
    and lane_ref (L,) int32 naming each lane's target cloud (default: cloud
    0 when G == 1, cloud l when G == L); init_* (L, 3, 3), (L, 3), (L,).
    Returns the rigid transform of each lane, source -> target, with PCL's
    convergence tests and getFitnessScore fitness. A lane's answer does not
    depend on the other lanes.

    trim_fraction > 0 keeps, each iteration, only the correspondences within
    the lane's trim_fraction-quantile of valid NN distances, and reports the
    trimmed mean squared distance as fitness; estimate_scale solves the
    Umeyama similarity, and a step converges on its transform only once the
    scale delta is small too, (ds - 1)² < transformation_epsilon.

    variant "point_to_plane" steps by `point_to_plane_step` against
    target_normals, shaped as target, each lane's correspondences' normals
    gathered from its own cloud. It comes before estimate_scale, as JAX's
    `if variant ... elif estimate_scale` does: such a lane solves no scale."""
    if variant not in ("point_to_point", "point_to_plane"):
        raise ValueError(f"unknown ICP variant {variant!r}")
    plane = variant == "point_to_plane"
    if plane and target_normals is None:
        raise ValueError("variant='point_to_plane' needs target_normals")
    lanes = source.shape[0]
    dtype, device = source.dtype, source.device
    smask = source_mask.expand(source.shape[:2])
    if target.dim() == 2:
        target, target_mask = target[None], target_mask[None]
        target_normals = None if target_normals is None else target_normals[None]
    tgt, tmask = target.contiguous(), target_mask.contiguous()
    # Each lane's correspondences are gathered from its own cloud.
    ref_row = lane_refs(lane_ref, lanes, tgt.shape[0], device).long()[:, None]
    big = torch.finfo(dtype).max / 4
    max_d2 = torch.tensor(params.max_correspondence_distance, dtype=dtype) ** 2
    tiny = torch.finfo(dtype).tiny

    rot = (torch.eye(3, dtype=dtype, device=device).expand(lanes, 3, 3).clone()
           if init_rotation is None else init_rotation)
    trans = torch.zeros((lanes, 3), dtype=dtype, device=device) if init_translation is None else init_translation
    scale = torch.ones((lanes,), dtype=dtype, device=device) if init_scale is None else init_scale
    corr_mse = torch.full((lanes,), big, dtype=dtype, device=device)
    iteration = torch.zeros((lanes,), dtype=torch.int32, device=device)
    converged = torch.zeros((lanes,), dtype=torch.bool, device=device)

    def positions(r, t, s):
        return (s[:, None, None] * rotate_points(r, source) + t[:, None, :]).contiguous()

    while True:
        active = (iteration < params.max_iterations) & ~converged
        if not bool(active.any()):
            break
        icp.lockstep_iterations += 1
        cur = positions(rot, trans, scale)
        d2, idx = nn1(cur, tgt, tmask, lane_ref)
        keep = smask & (d2 <= max_d2)
        if trim_fraction:
            keep = keep & (d2 <= masked_quantile_threshold(d2, smask, trim_fraction)[:, None])
        w = keep.to(dtype)
        corr = tgt[ref_row, idx.long()]
        if plane:
            dr, dt = point_to_plane_step(cur, corr, target_normals[ref_row, idx.long()], w)
            ds = torch.ones_like(scale)
        elif estimate_scale:
            dr, dt, ds = kabsch(cur, corr, w, estimate_scale=True)
        else:
            (dr, dt), ds = kabsch(cur, corr, w), torch.ones_like(scale)
        # new(x) = ds·dr·(s·R·x + t) + dt
        new_r = matmul3(dr, rot)
        new_t = ds[:, None] * matvec3(dr, trans) + dt
        new_s = ds * scale

        # Convergence MSE from the matched pairs in exact f32 (icp.py:293-301).
        wsum = w.sum(dim=-1).clamp_min(1.0)
        diff = cur - corr
        d2_exact = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] + diff[..., 2] * diff[..., 2]
        new_mse = (d2_exact * w).sum(dim=-1) / wsum

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

    d2, _ = nn1(positions(rot, trans, scale), tgt, tmask, lane_ref)
    if trim_fraction:
        fitness = trimmed_masked_mean(d2, smask, trim_fraction)
    else:
        w = smask.to(dtype)
        fitness = (d2 * w).sum(dim=-1) / w.sum(dim=-1).clamp_min(1.0)
    return ICPResult(rotation=rot, translation=trans, fitness=fitness,
                     iterations=iteration, converged=converged, scale=scale)


icp.lockstep_iterations = 0  # loop passes of every call, a counter for measurement
