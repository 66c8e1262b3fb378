"""Batched ICP: point-to-point with Kabsch/SVD updates, or point-to-plane.

Port of kss_icp_tpu/models/icp.py (pcl::IterativeClosestPoint as configured
by KSS_ICP.hpp:155-162). JAX runs one `lax.while_loop` per lane under
`vmap`, which executes in lockstep: the loop goes on while any lane is
active, and a finished lane keeps its state. Here that is a Python loop over
iterations with all lanes batched, a finished lane's state frozen, and one
host sync per iteration for the "any lane active" test. Per-lane
`iterations` and `converged` equal the reference's. Each call is a "kss.icp"
span and each pass of the loop a "kss.icp.step" span; inside it, the stop
test's read is a "kss.sync.icp_stop" span (utils/profiling.py::span).

A step is one `nn1` launch for all lanes (the correspondences), the trimmed
path's quantile, then the update. On the card, for point-to-point lanes with
the whole point axis here, the update is one `icp_update` launch
(ops/icp_cuda.py, csrc/icp_step.cu): the Kabsch sums, a float64 3 x 3 SVD,
the gates, the freeze, the next positions and the stop flag. Elsewhere it is
the eager `icp_update_plain`, whose CUDA `torch.linalg.svd` in `kabsch` also
waits on the device (a "kss.sync.kabsch_svd" span).

Each lane may have its own target cloud (`lane_ref`), so the lanes of
a batch of pairs run in one loop (models/kss_icp.py::register_batch): JAX
vmaps the single-pair solve over pairs, which is the same lockstep. `trim_fraction` and `estimate_scale` give the overlap tier's trimmed
similarity ICP (icp.py:226-232): a per-lane quantile gate on the
correspondences, the Umeyama scale, and the trimmed mean as fitness.
`variant="point_to_plane"` takes the linearized point-to-plane step
(icp.py:136-170) against the target's normals, ahead of `estimate_scale`, as
in JAX. `group` makes the solve SPMD over a sharded point axis
(icp.py:191-300 with axis_name; parallel/point_shard.py): each rank holds
its rows of the source, and every sum over the points is all-reduced over
the group before it is used.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from kss_icp_torch.core.transforms import matmul3, matvec3
from kss_icp_torch.ops.icp_cuda import ICPState, icp_update, icp_update_plain, positions
from kss_icp_torch.ops.nn import masked_quantile_threshold, trimmed_masked_mean
from kss_icp_torch.ops.nn_cuda import lane_refs, nn1
from kss_icp_torch.utils.profiling import span, spanned


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


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over the ranks of the process `group` (JAX's psum over
    axis_name), the same bits on every rank; x itself when group is None."""
    if group is None:
        return x
    x = x.contiguous()
    dist.all_reduce(x, group=group)
    return x


def kabsch(source: torch.Tensor, target: torch.Tensor, weights: torch.Tensor, estimate_scale: bool = False,
           group=None):
    """Weighted rigid Kabsch over lanes: argmin_R,t sum w ||R s + t - t'||².

    source, target (L, N, 3); weights (L, N). Returns (R (L, 3, 3), t (L, 3)),
    with the determinant correction so that R is a proper rotation; with
    estimate_scale, (R, t, s (L,)), the Umeyama similarity
    argmin_s,R,t sum w ||s R x + t - y||², s = trace(D S) / var_src
    (kss_icp_tpu/models/icp.py:61-114). With a process `group`, each rank
    holds its rows of the points and every sum is all-reduced over the
    group, so the 3 x 3 SVD sees the same matrix on every rank."""
    dtype = source.dtype
    wsum = all_sum(weights.sum(dim=-1), group).clamp_min(torch.finfo(dtype).tiny)
    w = weights[..., None]
    cs = all_sum((w * source).sum(dim=-2), group) / wsum[..., None]
    ct = all_sum((w * target).sum(dim=-2), group) / wsum[..., None]
    s0 = source - cs[..., None, :]
    t0 = target - ct[..., None, :]
    h = all_sum((w[..., None] * s0[..., :, None] * t0[..., None, :]).sum(dim=-3), group) / wsum[..., None, None]
    with span("sync.kabsch_svd"):  # on CUDA, torch.linalg.svd waits on the device (twice a call)
        u, sv, vh = torch.linalg.svd(h)
    v, ut = vh.transpose(-1, -2), u.transpose(-1, -2)
    det = torch.linalg.det(matmul3(v, ut))
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    r = matmul3(v * d[..., None, :], ut)
    if not estimate_scale:
        return r, ct - matvec3(r, cs)
    var_s = all_sum((weights * (s0 * s0).sum(dim=-1)).sum(dim=-1), group) / wsum
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
                        weights: torch.Tensor, group=None):
    """The linearized point-to-plane update of each lane (Chen & Medioni;
    kss_icp_tpu/models/icp.py:136-170): minimize sum w (n · (R p + t − q))²
    with R ≈ I + [w]x through the 6 x 6 normal equations, damped by 1e-6 I,
    then R = exp([w]x). Not in the reference (PCL is point-to-point): the
    opt-in icp_variant="point_to_plane". source, target, target_normals
    (L, N, 3), weights (L, N). Returns (R (L, 3, 3), t (L, 3)). Negating a
    normal negates its row of A and its residual, so AᵀA and Aᵀb keep their
    bits: unoriented normals do. With a process `group`, AᵀA and Aᵀb are
    all-reduced over it (JAX's psum)."""
    n = target_normals
    r = (n * (source - target)).sum(dim=-1)  # (L, N) signed residuals
    a = torch.cat([torch.linalg.cross(source, n, dim=-1), n], dim=-1)  # (L, N, 6)
    aw = a * weights[..., None]
    ata = all_sum(aw.transpose(-1, -2) @ a, group)
    atb = all_sum((aw.transpose(-1, -2) @ -r[..., None])[..., 0], group)
    eye = torch.eye(6, dtype=source.dtype, device=source.device)
    # solve_ex: no error check, so no host sync a step; an exactly singular
    # system gives non-finite values, as jnp.linalg.solve does, and no raise.
    x = torch.linalg.solve_ex(ata + 1e-6 * eye, atb)[0]
    return _rodrigues(x[:, :3]), x[:, 3:]


def _any_active(flag: torch.Tensor, group) -> bool:
    """Whether any lane is still active, from the step's device flag: one
    host sync, the span "sync.icp_stop"; with a group, on any rank (the flag
    all-reduced with MAX)."""
    if group is None:
        with span("sync.icp_stop"):
            return bool(flag)
    flag = flag.to(torch.int32).reshape(1)
    with span("sync.icp_stop"):
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
        return bool(flag)


@spanned("icp")
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
    group=None,
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
    `if variant ... elif estimate_scale` does: such a lane solves no scale.

    With a process `group` (torch.distributed), each rank holds its rows of
    the source (and source_mask) and the whole target: nn1 runs on the local
    rows, and every sum over the points (the Kabsch or point-to-plane sums,
    the convergence MSE's numerator and denominator, the fitness) is
    all-reduced over the group before it is used, so every rank takes the
    same branch and returns the same result. The loop's stop flag is
    all-reduced too (MAX), so no rank leaves it while another waits in a
    collective. trim_fraction > 0 raises with a group: a per-rank quantile is
    not the global quantile (JAX icp.py:234-242)."""
    if trim_fraction and group is not None:
        raise ValueError("trim_fraction > 0 is incompatible with a sharded point axis "
                         "(per-shard quantiles are not global quantiles)")
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
    ref = lane_refs(lane_ref, lanes, tgt.shape[0], device)
    big = torch.finfo(dtype).max / 4

    # The state is the call's own: the kernel updates it in place.
    rot = (torch.eye(3, dtype=dtype, device=device).expand(lanes, 3, 3).clone()
           if init_rotation is None else init_rotation.clone(memory_format=torch.contiguous_format))
    trans = (torch.zeros((lanes, 3), dtype=dtype, device=device) if init_translation is None
             else init_translation.clone(memory_format=torch.contiguous_format))
    scale = (torch.ones((lanes,), dtype=dtype, device=device) if init_scale is None
             else init_scale.clone(memory_format=torch.contiguous_format))
    iteration = torch.zeros((lanes,), dtype=torch.int32, device=device)
    converged = torch.zeros((lanes,), dtype=torch.bool, device=device)
    state = ICPState(rot, trans, scale, torch.full((lanes,), big, dtype=dtype, device=device), iteration, converged,
                     (iteration < params.max_iterations) & ~converged)

    # On the card, a point-to-point step with the whole point axis here is
    # nn1 and one icp_update launch (ops/icp_cuda.py); the eager step,
    # icp_update_plain, serves the CPU, point-to-plane and a sharded point
    # axis, whose sums are all-reduced between the sums and the SVD.
    fused = device.type == "cuda" and group is None and not plane
    if fused:
        source, smask = source.contiguous(), smask.contiguous()
        stop = torch.zeros((2,), dtype=torch.int32, device=device)
    cur = positions(source, rot, trans, scale)
    # Each pass is one "icp.step": nn1, the lanes' step and state update,
    # then the stop test that decides the next pass. The first pass needs
    # none: every lane starts active.
    go = params.max_iterations > 0 and lanes > 0
    step = 0
    while go:
        with span("icp.step"):
            icp.lockstep_iterations += 1
            d2, idx = nn1(cur, tgt, tmask, ref if fused else lane_ref)
            threshold = masked_quantile_threshold(d2, smask, trim_fraction) if trim_fraction else None
            if fused:
                icp.fused_steps += 1
                state, cur, flag = icp_update(cur, d2, idx, source, smask, tgt, ref, state, params, threshold,
                                              estimate_scale, stop=stop, step=step)
            else:
                state, cur, flag = icp_update_plain(cur, d2, idx, source, smask, tgt, ref, state, params, threshold,
                                                    estimate_scale, target_normals if plane else None, group)
            go = _any_active(flag, group)
            step += 1

    rot, trans, scale, _, iteration, converged, _ = state
    d2, _ = nn1(cur, tgt, tmask, ref if fused else lane_ref)
    if trim_fraction:
        fitness = trimmed_masked_mean(d2, smask, trim_fraction)
    else:
        w = smask.to(dtype)
        fitness = all_sum((d2 * w).sum(dim=-1), group) / all_sum(w.sum(dim=-1), group).clamp_min(1.0)
    return ICPResult(rotation=rot, translation=trans, fitness=fitness,
                     iterations=iteration, converged=converged, scale=scale)


icp.lockstep_iterations = 0  # loop passes of every call, a counter for measurement
icp.fused_steps = 0  # the passes that ran the icp_update kernel: their share of lockstep_iterations
