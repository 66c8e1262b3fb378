"""The KSS-ICP registration pipeline (port of kss_icp_tpu/models/kss_icp.py).

KSSICP_Registration (KSS_ICP.hpp:69-131) as batched tensor stages:

  1. FPS-resample both clouds to pNumber = min(|S|,|T|)//2 (≤ 2000), padded
     to 2048 (`fps` kernel, which stops after pNumber picks), or with
     resampler="aivs" the reference's own sampler (ops/aivs.py);
  2. Kendall pre-shape alignment (core/preshape.py);
  3. the Euler-grid coarse field (`field_ave` or `field_dot` kernel, by
     `coarse_method`; `field_sq` for the "max" and "diff" metrics) and its
     local-minima candidate list (models/coarse.py);
  4. multi-start ICP over all candidates at once (models/icp.py, `nn1`
     kernel), point-to-point or, with icp_variant="point_to_plane", against
     the target's PCA normals (ops/normals.py), with the fitness gate of
     KSS_ICP.hpp:99 and, where `pose_tiebreak_margin` is set, the
     symmetric-pose tie-break;
  5. the winning transform composed as one Sim3.

Steps 2-5 take a leading pair axis B (`register_batch`, JAX's vmap of
register_resampled): the lanes of every pair run in one ICP loop, each
against its own pair's target, and the gate and lane picks are per-pair
selects on the device. `register_resampled` is its batch of one, and
`polish_resampled`, `trimmed_fitness` and the overlap solvers take one
pair or a batch; `overlap_solve_batch` and `overlap_screen_solve_batch`
are JAX's batched rungs (parallel/batch.py::overlap_batch).

`escalation_ladder`, which register_pair (at B=1) and register_many
(parallel/batch.py) both climb, is the escalation of the JAX package: a
pair whose fitness is above `escalate_threshold`, or whose final converge
hit its iteration cap, is re-solved on the 16^3 grid (`escalation_config()`), the
better result is kept, and a result still at its cap is finished by an
uncapped warm-started ICP (`polish_resampled`). A pair still above
`overlap_threshold` then climbs the overlap tier: two trimmed, scaled,
inlier-masked solves (`register_overlap_resampled`, on the 8^3 and 16^3
grids) and a screen of every 8^3 grid rotation
(`register_overlap_screen_resampled`), each behind the crop-signature gate
and adopted by the trimmed-fitness margin. `overlap_mode=True` runs the
overlap solve alone.

Implemented: every knob of the JAX pipeline: both `multistart_mode`s, the
two-tier refine with its prefix-target gate probe, the pose tie-break, the
precision mode's winner-neighborhood restarts (`neighborhood_polish`), the
two-stage converge (`continue_capped`), escalation, the overlap tier and
every resampler, field metric and ICP variant.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from kss_icp_torch.config import DEFAULT_CONFIG, KSSICPConfig
from kss_icp_torch.core.cloud import PointCloud
from kss_icp_torch.core.preshape import middle_align
from kss_icp_torch.core.transforms import (Similarity, apply_similarity, compose, euler_xyz_matrix, matmul3,
                                          rotate_points)
from kss_icp_torch.models.coarse import CoarseResult, coarse_align, rotation_grid
from kss_icp_torch.escalate import tree_map
from kss_icp_torch.models.icp import ICPParams, ICPResult, icp
from kss_icp_torch.ops.aivs import aivs_resample_packed
from kss_icp_torch.ops.nn import masked_mean, masked_quantile_threshold, trimmed_masked_mean
from kss_icp_torch.ops.nn_cuda import MAX_LANES, nn1
from kss_icp_torch.ops.normals import estimate_normals
from kss_icp_torch.ops.resample import fps_points
from kss_icp_torch.ops.resample_cuda import fps
from kss_icp_torch.ops.spatial import estimate_box_scale
from kss_icp_torch.utils.profiling import span, spanned

BIG = 1e30


class RegistrationResult(NamedTuple):
    transform: Similarity         # full-resolution source -> target frame
    fitness: torch.Tensor         # chosen candidate's ICP fitness (mean sq NN dist)
    judge_fitness: torch.Tensor   # fitness from the best grid angle (the gate probe)
    used_multistart: torch.Tensor  # bool: gate failed, argmin-fitness candidate used
    chosen_candidate: torch.Tensor  # int index into coarse.candidate_angles
    icp_iterations: torch.Tensor  # iterations of the chosen candidate's ICP
    refine_hit_cap: torch.Tensor  # bool: the final converge ran out of iterations
    coarse: CoarseResult


Timer = Callable[[str], contextlib.AbstractContextManager]


def _host(x: torch.Tensor, site: str) -> np.ndarray:
    """x read to the host as numpy: a blocking read of a device value, inside
    the span "sync.<site>"."""
    with span(f"sync.{site}"):
        return x.cpu().numpy()


def _to_device(x, device, site: str) -> torch.Tensor:
    """The host array or list `x` on `device`: a blocking copy from pageable
    memory, inside the span "sync.<site>"."""
    with span(f"sync.{site}"):
        return torch.as_tensor(np.asarray(x), device=device)


def _prefix(points, mask, n):
    """The first n rows of (..., P, 3) points and their (..., P) mask."""
    if n and n < points.shape[-2]:
        return points[..., :n, :], mask[..., :n]
    return points, mask


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for every pair b: x (B, n, ...), idx (B, m) -> (B, m, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for every pair b: x (B, n, ...), idx (B,) -> (B, ...)."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def _pair_lanes(pairs: int, lanes: int, device) -> Optional[torch.Tensor]:
    """lane_ref of `lanes` lanes a pair, pair-major: (pairs * lanes,) int32;
    None for one pair, whose lanes all take cloud 0 (nn1's default)."""
    if pairs == 1:
        return None
    return torch.arange(pairs, dtype=torch.int32, device=device).repeat_interleave(lanes)


def _first(tree):
    """The single-pair view of a batch of one: row 0 of every tensor."""
    return tree_map(lambda x: x[0], tree)


def _one_or_many(fn):
    """Let `fn`, a function of a batch of pairs ((B, P, 3) clouds, (B,)
    transforms), also take one pair: unbatched clouds and transforms gain the
    pair axis, and the result loses it."""
    @functools.wraps(fn)
    def run(*args, **kw):
        if args[0].dim() == 3:
            return fn(*args, **kw)
        return _first(fn(*(tree_map(lambda x: x[None], a) if isinstance(a, (torch.Tensor, Similarity)) else a
                           for a in args), **kw))
    return run


def _keep(better: torch.Tensor, new, old):
    """Pair b's rows of `new` where better[b], else of `old`, across a result tree."""
    return tree_map(lambda n, o: torch.where(better.reshape(better.shape + (1,) * (n.dim() - 1)), n, o), new, old)


def _pose_tiebreak_select(
    fit: torch.Tensor,            # (B, K) candidate fitnesses (1e30 = invalid)
    aligned: torch.Tensor,        # (B, K, P, 3) candidate-aligned source clouds
    source_mask: torch.Tensor,    # (B, P)
    target_points: torch.Tensor,  # (B, T, 3)
    target_mask: torch.Tensor,    # (B, T)
    cfg: KSSICPConfig,
) -> torch.Tensor:
    """Symmetric-pose tie-break (kss_icp_tpu/models/kss_icp.py:394-419): per
    pair, among the candidates whose fitness is within
    (1 + pose_tiebreak_margin) of its best, the one with the smallest
    pose_tiebreak_quantile of its 1-NN distances; first index on ties. A
    slid symmetric pose barely moves the mean squared distance but lifts the
    high quantile. One nn1 launch for the B x K lanes, each against its
    pair's target."""
    b, k, p = aligned.shape[:3]
    near = fit <= fit.min(dim=1, keepdim=True).values * (1.0 + cfg.pose_tiebreak_margin)
    d2, _ = nn1(aligned.reshape(b * k, p, 3).contiguous(), target_points.contiguous(), target_mask.contiguous(),
                _pair_lanes(b, k, fit.device))
    mask = source_mask[:, None].expand(b, k, p).reshape(b * k, p)
    q = masked_quantile_threshold(torch.sqrt(d2), mask, cfg.pose_tiebreak_quantile).view(b, k)
    return torch.argmin(torch.where(near, q, torch.full_like(q, BIG)), dim=1)


def neighborhood_polish(
    total: Similarity,            # (B,) the winning transforms
    fitness: torch.Tensor,        # (B,) their fitness
    source_points: torch.Tensor,  # (B, P, 3) resampled padded clouds
    source_mask: torch.Tensor,    # (B, P)
    target_points: torch.Tensor,  # (B, T, 3)
    target_mask: torch.Tensor,    # (B, T)
    params: ICPParams,
    cfg: KSSICPConfig,
) -> tuple[Similarity, torch.Tensor]:
    """Winner-neighborhood precision restarts (cfg.neighborhood_fracs;
    kss_icp_tpu/models/kss_icp.py:343-391): re-converge from small Euler
    perturbations of each pair's winning pose and keep the better fitness.
    For narrow-basin shapes whose best converge point hides inside the
    winner's grid cell (tube/1 of the category board).

    The offsets are ±f·(angle_span / rotation_steps) on one Euler axis at a
    time: fracs outermost, then axis 0-2, then the sign, −1 first. Lane j of
    pair b starts from (r_off[j] @ R_b, s_b, t_b); the B x 6·len(fracs) lanes
    run as one lockstep ICP (12 a pair for the CLI's (0.25, 0.5)), each
    against its pair's target, at `params` (the uncapped ones: the point is
    to converge the narrow basin fully) with the config's icp_trim_fraction
    and icp_estimate_scale. Per pair, the first lane of least fitness
    replaces the incumbent only when strictly better, so the fitness never
    rises. Returns (transform, fitness), each leading with B.

    The caller keeps the capped base solve's refine_hit_cap, as JAX does: the
    polish answers for the pose, the flag for the base solve's converge, and
    the escalation reads the flag (ROADMAP.md queue 3, decided with item 13)."""
    b, p = source_mask.shape
    dtype, device = source_points.dtype, source_points.device
    step = cfg.angle_span / cfg.rotation_steps
    offs = [[sgn * f * step if ax == a else 0.0 for a in range(3)]
            for f in cfg.neighborhood_fracs for ax in range(3) for sgn in (-1.0, 1.0)]
    r_off = euler_xyz_matrix(torch.tensor(offs, dtype=dtype, device=device))  # (n, 3, 3)
    n = r_off.shape[0]

    def lanes(x):  # (B, ...) -> (B, n, ...)
        return x[:, None].expand((b, n) + x.shape[1:])

    pert = Similarity(scale=lanes(total.scale), rotation=matmul3(r_off, total.rotation[:, None]),
                      translation=lanes(total.translation))
    cur = apply_similarity(pert, source_points[:, None])  # (B, n, P, 3)
    res = icp(cur.reshape(b * n, p, 3).contiguous(), lanes(source_mask).reshape(b * n, p), target_points.contiguous(),
              target_mask.contiguous(), params, trim_fraction=cfg.icp_trim_fraction,
              estimate_scale=cfg.icp_estimate_scale, lane_ref=_pair_lanes(b, n, device))
    step_sim = Similarity(*(x.reshape((b, n) + x.shape[1:]) for x in (res.scale, res.rotation, res.translation)))
    tots = compose(step_sim, pert)
    fits = res.fitness.view(b, n)
    k = torch.argmin(fits, dim=1)
    best = _at(fits, k)
    better = best < fitness
    return _keep(better, tree_map(lambda x: _at(x, k), tots), total), torch.minimum(best, fitness)


def register_batch(
    source_points: torch.Tensor,
    source_mask: torch.Tensor,
    target_points: torch.Tensor,
    target_mask: torch.Tensor,
    cfg: KSSICPConfig = DEFAULT_CONFIG,
    timer: Optional[Timer] = None,
) -> RegistrationResult:
    """Register B pairs of already-resampled padded clouds (steps 2-5 above):
    JAX's vmapped register_resampled (kss_icp_tpu/parallel/batch.py:29-74,
    models/kss_icp.py:64-339).

    Shapes (B, P, 3)/(B, P); every field of the result leads with B. One
    field launch a pair; every ICP stage runs the lanes of all B pairs in
    one lockstep loop, each lane against its pair's target (`lane_ref`), so
    the batch pays its slowest lane's iterations, as JAX's vmapped
    while_loop does. The gate and the lane picks are per-pair selects on the
    device. With cfg.neighborhood_fracs, each pair's result is polished by
    `neighborhood_polish` on every return path, as JAX's is. With
    icp_variant="point_to_plane", each pair's target normals are estimated
    once (ops/normals.py, JAX :120-124) and every stage's lanes step against
    their prefix of them. `timer`, when given, is entered around each stage
    ("coarse", "screen", "refine", "polish") — a hook for measurement."""
    b, p = source_mask.shape
    dtype, device = source_points.dtype, source_points.device
    params = ICPParams.from_config(cfg)
    gate = cfg.multistart_fitness_gate
    sp, sm, tp, tm = source_points, source_mask, target_points.contiguous(), target_mask.contiguous()

    with span("coarse", timer):
        # 2. Kendall pre-shape normalization.
        sim0, _, _ = middle_align(sp, sm, tp, tm)
        src_aligned = apply_similarity(sim0, sp)
        # 3. Rotation-grid coarse search on optional FPS prefixes.
        score_src, score_mask = _prefix(src_aligned, sm, cfg.coarse_points)
        score_tgt, score_tmask = _prefix(tp, tm, cfg.coarse_target_points)
        coarse = coarse_align(
            score_src.contiguous(), score_mask, score_tgt, score_tmask,
            steps=cfg.rotation_steps, span=cfg.angle_span, radius=cfg.kernel_radius,
            max_candidates=cfg.max_candidates, error_metric=cfg.coarse_error_metric,
            method=cfg.coarse_method, precision=cfg.coarse_precision, trim_fraction=cfg.coarse_trim_fraction)
        r_cand = euler_xyz_matrix(coarse.candidate_angles)  # (B, K, 3, 3)
        rotated = rotate_points(r_cand, src_aligned[:, None])  # (B, K, P, 3)

    # Point-to-plane: the target normals, estimated once per pair (JAX :120-124).
    normals = estimate_normals(tp, tm) if cfg.icp_variant == "point_to_plane" else None

    def solve(lanes, prm, init=(None, None, None), rows=0):
        """ICP on (B, n, N, 3) lanes, pair b's against the first `rows` rows
        of pair b's target (all at 0) and their normals; the results and
        `init` shaped (B, n, ...)."""
        n, n_pts = lanes.shape[1:3]
        tgt, tmask = _prefix(tp, tm, rows)
        nrm = None if normals is None else normals[:, :tgt.shape[1]].contiguous()
        flat = [None if x is None else x.reshape((b * n,) + x.shape[2:]) for x in init]
        res = icp(lanes.reshape(b * n, n_pts, 3).contiguous(), sm[:, None, :n_pts].expand(b, n, n_pts).reshape(-1, n_pts),
                  tgt.contiguous(), tmask.contiguous(), prm, *flat, trim_fraction=cfg.icp_trim_fraction,
                  estimate_scale=cfg.icp_estimate_scale, lane_ref=_pair_lanes(b, n, device),
                  variant=cfg.icp_variant, target_normals=nrm)
        return ICPResult(*(x.reshape((b, n) + x.shape[1:]) for x in res))

    def pick(fit, judge, res, lanes):
        """Per pair: lane 0 when the gate passes (KSS_ICP.hpp:99), else
        argmin fitness, or the pose tie-break among the near-tied lanes
        where it is on (computed only when some pair fails the gate)."""
        use_best = judge <= gate
        best = torch.argmin(fit, dim=1)
        if cfg.pose_tiebreak_margin and not _host(use_best.all(), "tiebreak"):
            aligned = (res.scale[..., None, None] * rotate_points(res.rotation, lanes)
                       + res.translation[..., None, :])
            best = _pose_tiebreak_select(fit, aligned, sm, tp, tm, cfg)
        return torch.where(use_best, torch.zeros_like(best), best)

    def result(res, local, sel, judge, iterations, final_cap):
        """Compose ICP ∘ R_candidate ∘ preshape for pair b's lane local[b]."""
        choice = _at(sel, local)
        icp_sim = Similarity(scale=_at(res.scale, local), rotation=_at(res.rotation, local),
                             translation=_at(res.translation, local))
        cand_sim = Similarity.from_rigid(_at(r_cand, choice), torch.zeros((b, 3), dtype=dtype, device=device))
        return RegistrationResult(
            transform=compose(icp_sim, compose(cand_sim, sim0)),
            fitness=_at(res.fitness, local),
            judge_fitness=judge,
            used_multistart=judge > gate,
            chosen_candidate=choice,
            icp_iterations=iterations,
            refine_hit_cap=(_at(res.iterations, local) >= final_cap) & ~_at(res.converged, local),
            coarse=coarse,
        )

    refine_cap = params.max_iterations
    if cfg.refine_max_iterations:
        refine_cap = min(cfg.refine_max_iterations, cfg.max_icp_iterations)
    refine_params = params._replace(max_iterations=refine_cap)
    big = torch.full((), BIG, dtype=dtype, device=device)

    def polish(out):
        """Precision mode on the returned result (JAX :252-258, :322-326):
        the uncapped `params`, and the capped solve's refine_hit_cap kept."""
        if not cfg.neighborhood_fracs:
            return out
        with span("polish", timer):
            total, fitness = neighborhood_polish(out.transform, out.fitness, sp, sm, tp, tm, params, cfg)
        return out._replace(transform=total, fitness=fitness)

    if cfg.multistart_mode != "two_phase":  # "full", as any other value is in JAX
        with span("refine", timer):
            k = rotated.shape[1]
            sel = torch.arange(k, device=device).expand(b, k)
            res = solve(rotated, refine_params)
            fit = torch.where(coarse.candidate_mask, res.fitness, big)
            local = pick(fit, fit[:, 0], res, rotated)
            out = result(res, local, sel, fit[:, 0], _at(res.iterations, local), refine_cap)
        return polish(out._replace(fitness=_at(fit, local)))

    # Two-phase: screen every candidate with a short solve on the source's
    # first screen_points rows (an FPS prefix is a uniform subsample).
    with span("screen", timer):
        sp_n = min(cfg.screen_points, p)
        res1 = solve(rotated[:, :, :sp_n], params._replace(max_iterations=cfg.screen_iterations),
                     rows=cfg.screen_target_points)
        fit1 = torch.where(coarse.candidate_mask, res1.fitness, big)
        # Candidate 0 (the best grid angle) always survives: the gate is defined on it.
        n_refine = min(cfg.refine_candidates, fit1.shape[1])
        fit1[:, 0] = -float("inf")
        sel = torch.argsort(fit1, dim=1, stable=True)[:, :n_refine]  # (B, n_refine), row-wise as JAX :173
        init = tuple(_take(x, sel) for x in (res1.rotation, res1.translation, res1.scale))
        lanes = _take(rotated, sel)
        sel_mask = _take(coarse.candidate_mask, sel)

    with span("refine", timer):
        if not cfg.refine_tier_iterations:
            res = solve(lanes, refine_params, init)
            fit = torch.where(sel_mask, res.fitness, big)
            local = pick(fit, fit[:, 0], res, lanes)
            out = result(res, local, sel, fit[:, 0], _at(res.iterations, local), refine_cap)
            out = out._replace(fitness=_at(fit, local))
        else:
            # Two-tier refine: a capped solve on every selected lane ranks them,
            # then only each pair's winner converges fully.
            rtp = cfg.refine_tier_target_points
            res_a = solve(lanes, params._replace(max_iterations=cfg.refine_tier_iterations), init, rows=rtp)
            fit_a = torch.where(sel_mask, res_a.fitness, big)
            judge_a = fit_a[:, 0]
            if rtp and rtp < tp.shape[1]:
                # The gate is absolute and a prefix target inflates fitness:
                # re-evaluate candidate 0 on the full target (no ICP steps).
                probe = solve(lanes[:, :1], params._replace(max_iterations=0),
                              (res_a.rotation[:, :1], res_a.translation[:, :1], res_a.scale[:, :1]))
                judge_a = torch.where(sel_mask[:, 0], probe.fitness[:, 0], big)
            win = pick(fit_a, judge_a, res_a, lanes)
            res = solve(_at(lanes, win)[:, None], refine_params,
                        tuple(_at(x, win)[:, None] for x in (res_a.rotation, res_a.translation, res_a.scale)))
            out = result(res, torch.zeros_like(win), _at(sel, win)[:, None], judge_a,
                         _at(res_a.iterations, win) + res.iterations[:, 0], refine_cap)
    return polish(out)


@spanned("register_resampled")
def register_resampled(
    source_points: torch.Tensor,
    source_mask: torch.Tensor,
    target_points: torch.Tensor,
    target_mask: torch.Tensor,
    cfg: KSSICPConfig = DEFAULT_CONFIG,
    timer: Optional[Timer] = None,
) -> RegistrationResult:
    """Register two already-resampled padded clouds, shapes (P, 3)/(P,):
    register_batch on a batch of one pair, and its result's row."""
    return _first(register_batch(source_points[None], source_mask[None], target_points[None], target_mask[None],
                                 cfg, timer))


def resample_batch(
    points: torch.Tensor,
    mask: torch.Tensor,
    pnumber: torch.Tensor,
    cfg: KSSICPConfig = DEFAULT_CONFIG,
    pad: Optional[int] = None,
    steps: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Resample (B, N, 3) padded clouds to (B, resample_pad, 3), keeping
    pnumber[b] valid samples of cloud b (kss_icp_tpu/models/kss_icp.py:761-815):
    by FPS (the `fps` kernel on CUDA), or with cfg.resampler="aivs" by AIVS
    (ops/aivs.py::aivs_resample_packed, all B clouds at once, packed in
    pick-round order) on cfg.aivs_boxes_per_axis boxes an axis, or where
    that is 0 the ladder's count for N points (register_pair and
    register_many resolve it from the valid counts first,
    `_resolve_aivs_boxes`).

    `steps`, a host int, makes only the first min(steps, pad) FPS picks: the
    slots past pnumber are masked and zeroed anyway and picks are
    prefix-stable, so with steps >= max(pnumber) the output is bit-identical
    to the full run's (and JAX's). A smaller `steps` keeps `steps` samples.
    AIVS ignores it."""
    p = pad if pad is not None else cfg.resample_pad
    if cfg.resampler == "aivs":
        nb = cfg.aivs_boxes_per_axis or estimate_box_scale(points.shape[-2])
        pts, smask = aivs_resample_packed(points, mask, pnumber, p, nb, cfg.aivs_max_rounds, cfg.aivs_max_cuts)
        smask = smask & (torch.arange(p, device=points.device)[None, :] < pnumber[:, None])
        return pts * smask[..., None].to(points.dtype), smask
    idx, smask = fps(points, mask, p, None if steps is None else min(steps, p))
    smask = smask & (torch.arange(p, device=points.device)[None, :] < pnumber[:, None])
    pts = torch.take_along_dim(points, idx.long()[..., None], dim=1)
    return pts * smask[..., None].to(points.dtype), smask


def resample_pairs(
    source_points: torch.Tensor,
    source_mask: torch.Tensor,
    target_points: torch.Tensor,
    target_mask: torch.Tensor,
    pnumber: torch.Tensor,
    cfg: KSSICPConfig = DEFAULT_CONFIG,
    pad: Optional[int] = None,
    steps: Optional[int] = None,
):
    """Resample B source + target pairs (same padded N) as one 2B-cloud batch,
    one `fps` launch (`steps` as in resample_batch: the largest pnumber
    gives the full run's bits). Returns ((src_pts, src_mask), (tgt_pts, tgt_mask))."""
    pts = torch.cat([source_points, target_points], dim=0)
    msk = torch.cat([source_mask, target_mask], dim=0)
    rp, rm = resample_batch(pts, msk, torch.cat([pnumber, pnumber], dim=0), cfg, pad, steps)
    b = source_points.shape[0]
    return (rp[:b], rm[:b]), (rp[b:], rm[b:])


def resample_for_registration(
    points: torch.Tensor,
    mask: torch.Tensor,
    pnumber: Union[int, torch.Tensor],
    cfg: KSSICPConfig = DEFAULT_CONFIG,
    pad: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """FPS-resample one padded (N, 3) cloud to (pad or cfg.resample_pad, 3),
    keeping `pnumber` valid samples (kss_icp_tpu/models/kss_icp.py:839-851):
    one `fps` launch on the card, whatever cfg.resampler says, as in JAX."""
    p = pad if pad is not None else cfg.resample_pad
    pts, smask = fps_points(points, mask, p)
    smask = smask & (torch.arange(p, device=points.device) < torch.as_tensor(pnumber, device=points.device))
    return pts * smask[:, None].to(points.dtype), smask


def _resolve_aivs_boxes(cfg: KSSICPConfig, n_valid: int) -> KSSICPConfig:
    """Pin the AIVS box ladder from the true valid point count (the reference
    rule, ballRegionCompute.hpp:1194; kss_icp_tpu/models/kss_icp.py:746-757),
    not from the padded size: register_pair takes max(n_s, n_t), register_many
    the largest valid count of its batch."""
    if cfg.resampler == "aivs" and cfg.aivs_boxes_per_axis == 0:
        return dataclasses.replace(cfg, aivs_boxes_per_axis=estimate_box_scale(n_valid))
    return cfg


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' needs a CUDA device; pass device='cpu' for the plain path")
    return device


@_one_or_many
def polish_resampled(
    source_points: torch.Tensor,
    source_mask: torch.Tensor,
    target_points: torch.Tensor,
    target_mask: torch.Tensor,
    transform: Similarity,
    cfg: KSSICPConfig = DEFAULT_CONFIG,
) -> tuple[Similarity, torch.Tensor, torch.Tensor]:
    """Continue a capped final converge (kss_icp_tpu/models/kss_icp.py:697-737):
    warm-start full-resolution ICP from the composed transform and run up to
    min(refine_polish_iterations or max_icp_iterations, max_icp_iterations)
    more steps. Correspondences depend only on the current positions, so
    this continues the iteration sequence the cap cut short. Used as the
    escalation's uncapped finisher. Returns (transform, fitness, iterations).

    Clouds (P, 3)/(P,) with one transform, or a batch of pairs (B, P, 3)/(B, P)
    with (B,) transforms: one lane a pair, in one lockstep loop. With
    icp_variant="point_to_plane" the target normals are estimated again
    (JAX :725-732), so the finisher steps point-to-plane too."""
    current = apply_similarity(transform, source_points)
    cap = min(cfg.refine_polish_iterations or cfg.max_icp_iterations, cfg.max_icp_iterations)
    tp, tm = target_points.contiguous(), target_mask.contiguous()
    normals = estimate_normals(tp, tm) if cfg.icp_variant == "point_to_plane" else None
    res = icp(current.contiguous(), source_mask, tp, tm, ICPParams.from_config(cfg)._replace(max_iterations=cap),
              trim_fraction=cfg.icp_trim_fraction, estimate_scale=cfg.icp_estimate_scale,
              variant=cfg.icp_variant, target_normals=normals)
    step = Similarity(scale=res.scale, rotation=res.rotation, translation=res.translation)
    return compose(step, transform), res.fitness, res.iterations


def two_stage(cfg: KSSICPConfig) -> bool:
    """Whether cfg asks for the two-stage converge: a capped final converge
    (refine_max_iterations) continued by a polish (refine_polish_iterations)."""
    return bool(cfg.refine_polish_iterations and cfg.refine_max_iterations)


def continue_capped(res: RegistrationResult, clouds: tuple, cfg: KSSICPConfig = DEFAULT_CONFIG,
                    timer: Optional[Timer] = None) -> RegistrationResult:
    """The two-stage converge (KSSICPConfig.refine_polish_iterations): the
    pairs of a register_batch result `res` whose capped final converge hit
    refine_max_iterations are continued by `polish_resampled` at cfg, up to
    refine_polish_iterations more steps on the same resampled `clouds`, all
    of them in one lockstep loop, and each keeps the continuation where its
    fitness is lower (kss_icp_tpu/parallel/batch.py:183-200, through the
    `escalate` module's polish_rerun; JAX's register_pair :895-904 does the
    same for its one pair). refine_hit_cap is left as it was: register_pair
    clears it, register_many keeps it, as in JAX. Stage "two_stage" where
    some pair continues; without the knob, `res` unchanged."""
    from kss_icp_torch import escalate as esc

    hit = _host(res.refine_hit_cap, "two_stage")
    if not two_stage(cfg) or not hit.any():
        return res
    device = clouds[0].device

    def polish(sel):
        idx = _to_device(sel, device, "two_stage")
        tot, fit2, _ = polish_resampled(*(x[idx] for x in clouds), tree_map(lambda x: x[idx], res.transform), cfg)
        return tot, _host(fit2, "two_stage")

    with span("two_stage", timer):
        transform, fitness, _, _ = esc.polish_rerun(polish, hit, _host(res.fitness, "two_stage"), 1,
                                                    result=res.transform)
    return res._replace(transform=transform, fitness=_to_device(fitness, device, "two_stage"))


def trimmed_fitness(
    transform: Similarity,
    source_points: torch.Tensor,
    source_mask: torch.Tensor,
    target_points: torch.Tensor,
    target_mask: torch.Tensor,
    trim_fraction: float,
    bidirectional: bool = True,
) -> torch.Tensor:
    """Trimmed mean squared NN distance of the transformed source, plus the
    target -> source direction when bidirectional
    (kss_icp_tpu/models/kss_icp.py:422-451): the overlap tier's goodness
    metric, blind to the non-overlap points of a correct partial alignment;
    the reverse direction exposes a slid pose that leaves target regions
    uncovered. Unbatched clouds, or a batch of pairs with (B,) transforms."""
    aligned = apply_similarity(transform, source_points).contiguous()
    d2, _ = nn1(aligned, target_points.contiguous(), target_mask.contiguous())
    fwd = trimmed_masked_mean(d2, source_mask, trim_fraction)
    if not bidirectional:
        return fwd
    d2r, _ = nn1(target_points.contiguous(), aligned, source_mask.contiguous())
    return fwd + trimmed_masked_mean(d2r, target_mask, trim_fraction)


def _overlap_cfg(cfg: KSSICPConfig) -> KSSICPConfig:
    return cfg if cfg.overlap_mode else cfg.overlap_config()


@_one_or_many
def register_overlap_resampled(
    source_points: torch.Tensor,
    source_mask: torch.Tensor,
    target_points: torch.Tensor,
    target_mask: torch.Tensor,
    cfg: KSSICPConfig = DEFAULT_CONFIG,
) -> RegistrationResult:
    """Overlap-robust registration of two resampled padded clouds
    (kss_icp_tpu/models/kss_icp.py:454-520): register_batch at the overlap
    config (the trimmed field, trimmed similarity ICP), then
    overlap_iterations - 1 re-solves on mutual-inlier masks (the source
    points within the q-quantile of their distance to the target, and the
    target points within that of theirs to the aligned source), the
    pre-shape re-estimated on them. Keep-better per pair by the
    bidirectional trimmed fitness on the original masks, a device select as
    in JAX's fori_loop. The returned fitness is that trimmed fitness.
    Clouds (P, 3)/(P,), or a batch of pairs (B, P, 3)/(B, P)."""
    ocfg = _overlap_cfg(cfg)
    q = ocfg.overlap_trim_fraction
    tp, tm = target_points.contiguous(), target_mask.contiguous()
    clouds = (source_points, source_mask, tp, tm)
    res = register_batch(*clouds, ocfg)
    best = trimmed_fitness(res.transform, *clouds, q)
    for _ in range(ocfg.overlap_iterations - 1):
        aligned = apply_similarity(res.transform, source_points).contiguous()
        d2s, _ = nn1(aligned, tp, tm)
        sm_in = source_mask & (d2s <= masked_quantile_threshold(d2s, source_mask, q)[:, None])
        d2t, _ = nn1(tp, aligned, source_mask.contiguous())
        tm_in = tm & (d2t <= masked_quantile_threshold(d2t, tm, q)[:, None])
        res2 = register_batch(source_points, sm_in, tp, tm_in, ocfg)
        fit2 = trimmed_fitness(res2.transform, *clouds, q)
        better = fit2 < best
        res, best = _keep(better, res2, res), torch.where(better, fit2, best)
    return res._replace(fitness=best)


@_one_or_many
def register_overlap_screen_resampled(
    source_points: torch.Tensor,
    source_mask: torch.Tensor,
    target_points: torch.Tensor,
    target_mask: torch.Tensor,
    cfg: KSSICPConfig = DEFAULT_CONFIG,
) -> RegistrationResult:
    """The screen-seeded overlap solve, the third rung
    (kss_icp_tpu/models/kss_icp.py:523-637). Under heavy crops the trimmed
    field picks the wrong basin, so every rotation of the
    overlap_screen_steps grid seeds one lane of a single short trimmed
    similarity ICP on the source's screen_points prefix; each lane's full
    clouds are scored by bidirectional trimmed fitness (one nn1 launch a
    direction, the reverse one against the lanes' own clouds), and the
    overlap_screen_topk best lanes (a stable sort) converge fully as one
    ICP. Every lane runs in one batch, so no answer depends on
    overlap_screen_batch. Returns the best pose with fitness = its
    bidirectional trimmed fitness.

    Clouds (P, 3)/(P,), or a batch of pairs (B, P, 3)/(B, P), whose B x G
    screen lanes run in one ICP. nn1 takes at most 65535 lanes a launch, so
    a batch runs in chunks of at most 65535 // G pairs (127 on the 8^3
    grid), each chunk one screen."""
    ocfg = _overlap_cfg(cfg)
    q = ocfg.overlap_trim_fraction
    dtype, dev = source_points.dtype, source_points.device
    grid = rotation_grid(cfg.overlap_screen_steps, ocfg.angle_span, dev).to(dtype)
    g = grid.shape[0]
    chunk = MAX_LANES // g
    if source_points.shape[0] > chunk:
        parts = [register_overlap_screen_resampled(*(x[i:i + chunk] for x in (source_points, source_mask,
                                                                                 target_points, target_mask)), cfg)
                 for i in range(0, source_points.shape[0], chunk)]
        return tree_map(lambda *xs: torch.cat(xs), *parts)
    (b, p), t_n = source_mask.shape, target_mask.shape[1]
    sm, tp, tm = source_mask, target_points.contiguous(), target_mask.contiguous()
    sim0, _, _ = middle_align(source_points, sm, tp, tm)
    src_al = apply_similarity(sim0, source_points)
    rots = euler_xyz_matrix(grid)  # (G, 3, 3)
    params = ICPParams.from_config(ocfg)
    lane_ref = _pair_lanes(b, g, dev)

    def lanes_of(x, n):  # (B, ...) -> (B * n, ...), pair b's row for each of its n lanes
        return x[:, None].expand((b, n) + x.shape[1:]).reshape((b * n,) + x.shape[1:])

    sp_n = min(cfg.screen_points, p)
    seeded = rotate_points(rots, src_al[:, None])  # (B, G, P, 3)
    res = icp(seeded[:, :, :sp_n].reshape(b * g, sp_n, 3).contiguous(), lanes_of(sm[:, :sp_n], g), tp, tm,
              params._replace(max_iterations=cfg.overlap_screen_iters),
              trim_fraction=ocfg.icp_trim_fraction, estimate_scale=True, lane_ref=lane_ref)
    full = (res.scale[:, None, None] * rotate_points(res.rotation, seeded.reshape(b * g, p, 3))
            + res.translation[:, None, :]).contiguous()
    lane_sm = lanes_of(sm, g)
    d2, _ = nn1(full, tp, tm, lane_ref)
    fwd = trimmed_masked_mean(d2, lane_sm, q)
    # The reverse direction: lane l's target queries lane l's screened source.
    d2r, _ = nn1(lanes_of(tp, g).contiguous(), full, lane_sm.contiguous(),
                 torch.arange(b * g, dtype=torch.int32, device=dev))
    tfit_all = (fwd + trimmed_masked_mean(d2r, lanes_of(tm, g), q)).view(b, g)

    k = min(cfg.overlap_screen_topk, g)
    top = torch.argsort(tfit_all, dim=1, stable=True)[:, :k]  # (B, k)
    res = icp(_take(seeded, top).reshape(b * k, p, 3), lanes_of(sm, k), tp, tm, params,
              trim_fraction=ocfg.icp_trim_fraction, estimate_scale=True, lane_ref=_pair_lanes(b, k, dev))
    icp_sim = Similarity(scale=res.scale, rotation=res.rotation, translation=res.translation)
    cand_sim = Similarity.from_rigid(rots[top.reshape(-1)], torch.zeros((b * k, 3), dtype=dtype, device=dev))
    tots = tree_map(lambda x: x.reshape((b, k) + x.shape[1:]),
                    compose(icp_sim, compose(cand_sim, tree_map(lambda x: lanes_of(x, k), sim0))))
    # One call a top lane, each over the pairs: at one pair, the calls and
    # bits of the single-pair solve.
    tbs = torch.stack([trimmed_fitness(Similarity(*(x[:, i] for x in tots)), source_points, sm, tp, tm, q)
                       for i in range(k)], dim=1)
    best = torch.argmin(tbs, dim=1)

    def pick(x):
        return _at(x, best)

    coarse = CoarseResult(
        field=torch.zeros((b, 1, 1, 1), dtype=dtype, device=dev),
        best_angles=grid[pick(top)],
        candidate_angles=grid[top],
        candidate_mask=torch.ones((b, k), dtype=torch.bool, device=dev),
        candidate_errors=tbs,
    )
    no = torch.zeros((b,), dtype=torch.bool, device=dev)
    return RegistrationResult(
        transform=Similarity(*(pick(x) for x in tots)),
        fitness=pick(tbs),
        judge_fitness=pick(tbs),
        used_multistart=~no,
        chosen_candidate=pick(top),
        icp_iterations=pick(res.iterations.view(b, k)),
        refine_hit_cap=no,
        coarse=coarse,
    )


def _plain_fitness(transform: Similarity, source_points, source_mask, target_points, target_mask) -> torch.Tensor:
    """The mean squared NN distance of the transformed source: an adopted
    overlap solve's fitness (escalate.overlap_rerun's fit_std)."""
    d2, _ = nn1(apply_similarity(transform, source_points).contiguous(), target_points.contiguous(),
                target_mask.contiguous())
    return masked_mean(d2, source_mask)


def overlap_solve_batch(
    source_points: torch.Tensor,
    source_mask: torch.Tensor,
    target_points: torch.Tensor,
    target_mask: torch.Tensor,
    baseline: Similarity,
    cfg: KSSICPConfig = DEFAULT_CONFIG,
):
    """The batched overlap rung (kss_icp_tpu/models/kss_icp.py:670-694):
    register_overlap_resampled over B flagged pairs (B, P, 3)/(B, P), with
    (B,) incumbent transforms `baseline`. Returns (transform, fit_std,
    tfit_new, tfit_old), each leading with B. cfg must already be an overlap
    config (cfg.overlap_config() or its escalation's)."""
    clouds = (source_points, source_mask, target_points, target_mask)
    res = register_overlap_resampled(*clouds, cfg)
    return (res.transform, _plain_fitness(res.transform, *clouds), res.fitness,
            trimmed_fitness(baseline, *clouds, cfg.overlap_trim_fraction))


def overlap_screen_solve_batch(
    source_points: torch.Tensor,
    source_mask: torch.Tensor,
    target_points: torch.Tensor,
    target_mask: torch.Tensor,
    baseline: Similarity,
    cfg: KSSICPConfig = DEFAULT_CONFIG,
):
    """The batched screen rung (kss_icp_tpu/models/kss_icp.py:640-667):
    register_overlap_screen_resampled over B flagged pairs, with
    overlap_solve_batch's contract."""
    clouds = (source_points, source_mask, target_points, target_mask)
    res = register_overlap_screen_resampled(*clouds, cfg)
    return (res.transform, _plain_fitness(res.transform, *clouds), res.fitness,
            trimmed_fitness(baseline, *clouds, _overlap_cfg(cfg).overlap_trim_fraction))


def escalation_ladder(
    res: RegistrationResult,
    clouds: tuple,
    cfg: KSSICPConfig = DEFAULT_CONFIG,
    threshold: Optional[float] = None,
    ecfg: Optional[KSSICPConfig] = None,
    timer: Optional[Timer] = None,
    pair: bool = False,
) -> RegistrationResult:
    """The escalation ladder over a base result `res` of register_batch on
    its resampled `clouds`, (B, P, 3)/(B, P) source and target: register_many's
    (kss_icp_tpu/parallel/batch.py:209-337) and, with pair=True at B=1,
    register_pair's (kss_icp_tpu/models/kss_icp.py:905-976).

    1. "escalate": the pairs above `threshold` (cfg.escalate_threshold) or,
       without the two-stage converge, at their refine cap are re-solved at
       `ecfg` (cfg.escalation_config()) and the better fitness kept;
    2. "finish": a pair still at its cap is finished uncapped
       (polish_resampled);
    3. with cfg.overlap_escalate, a pair above overlap_threshold climbs the
       overlap rungs "overlap8", "overlap16" (register_overlap_resampled at
       cfg.overlap_config() and ecfg.overlap_config()) and "overlap_screen"
       (register_overlap_screen_resampled), each behind the crop-signature
       gate (the incumbent's trimmed fitness below overlap_gate_ratio x its
       fitness) and adopted when the rung's trimmed fitness is below
       overlap_adopt_margin x the incumbent's; an adopted rung's fitness is
       its plain mean squared NN distance.

    The two JAX entry points differ in two ways, and `pair` keeps both
    answers: register_pair enters the overlap tier once and then offers it
    every rung, where register_many re-checks overlap_threshold before each
    rung; and in register_pair a re-solve that wins becomes the whole
    result, its coarse field and chosen candidate included, where
    register_many keeps the base pass's candidate fields and takes the
    re-solve's transform, fitness and hit-cap flag.

    The re-solves go through the `escalate` module's escalate_rerun,
    polish_rerun and overlap_rerun, looked up at call time so that a
    measurement can wrap them (ladder_log.LadderLog). Selections are neither
    padded by repetition nor chunked: JAX does that for XLA's program
    shapes, and no answer depends on it. `timer` sees a stage only where
    some pair runs it."""
    from kss_icp_torch import escalate as esc

    device = clouds[0].device
    threshold = cfg.escalate_threshold if threshold is None else threshold
    ecfg = ecfg or cfg.escalation_config()
    solved = []  # each re-solve's whole result; register_pair takes the one that won

    def rows(sel, transform=None):
        """The clouds of the pairs `sel`, and their rows of `transform`."""
        idx = _to_device(sel, device, "ladder")
        sub = tuple(x[idx] for x in clouds)
        return sub if transform is None else sub + (tree_map(lambda x: x[idx], transform),)

    def won(res, wins):
        return solved[-1] if pair and wins else res

    def resolve(sel):
        r2 = register_batch(*rows(sel), ecfg)
        solved.append(r2)
        return (r2.transform, r2.refine_hit_cap), _host(r2.fitness, "ladder")

    # The hit-cap fold: a pair still unconverged after the capped final
    # converge is re-solved whatever its fitness, unless the two-stage
    # converge has continued it (JAX batch.py:238-239).
    fitness = _host(res.fitness, "ladder")
    flags = fitness > threshold
    if not two_stage(cfg):
        flags |= _host(res.refine_hit_cap, "ladder")
    with span("escalate", timer) if flags.any() else contextlib.nullcontext():
        (transform, hit_cap), fitness, wins, _ = esc.escalate_rerun(
            resolve, fitness, threshold, 1, result=(res.transform, res.refine_hit_cap), flags=flags)
    res = won(res, wins)._replace(transform=transform, fitness=_to_device(fitness, device, "ladder"),
                                  refine_hit_cap=hit_cap)

    hit = _host(hit_cap, "ladder")
    if hit.any():
        # The escalation solve runs capped too: finish the kept rows uncapped.
        def finish(sel):
            tot, fit2, _ = polish_resampled(*rows(sel, res.transform), ecfg)
            return tot, _host(fit2, "ladder")

        with span("finish", timer):
            transform, fitness, _, _ = esc.polish_rerun(finish, hit, fitness, 1, result=res.transform)
        res = res._replace(transform=transform, fitness=_to_device(fitness, device, "ladder"),
                           refine_hit_cap=torch.zeros_like(hit_cap))

    if not cfg.overlap_escalate or (pair and not fitness[0] > cfg.overlap_threshold):
        return res
    # register_pair's rungs are all reached once the tier is entered.
    reach = -np.inf if pair else cfg.overlap_threshold
    q = cfg.overlap_trim_fraction  # overlap_config() and escalation_config() keep it
    rungs = [("overlap8", cfg.overlap_config(), register_overlap_resampled),
             ("overlap16", ecfg.overlap_config(), register_overlap_resampled)]
    if cfg.overlap_screen_rung:
        rungs.append(("overlap_screen", cfg.overlap_config(), register_overlap_screen_resampled))
    for stage, ocfg, solve in rungs:
        flags = fitness > reach
        tf_old = np.full(fitness.shape, np.nan, np.float32)
        idx = np.nonzero(flags)[0]
        if idx.size:
            *sub, base = rows(idx, res.transform)
            tf_old[idx] = _host(trimmed_fitness(base, *sub, q), "ladder")
            flags[idx] = tf_old[idx] < cfg.overlap_gate_ratio * fitness[idx]

        def solve_rung(sel, ocfg=ocfg, solve=solve, tf_old=tf_old):
            """overlap_solve_batch's contract, the incumbent's trimmed fitness
            taken from the gate."""
            sub = rows(sel)
            r = solve(*sub, ocfg)
            solved.append(r)
            return r.transform, _plain_fitness(r.transform, *sub), r.fitness, tf_old[np.asarray(sel)]

        with span(stage, timer) if flags.any() else contextlib.nullcontext():
            transform, fitness, wins, _ = esc.overlap_rerun(
                solve_rung, fitness, reach, 1, cfg.overlap_adopt_margin, result=res.transform, flags=flags)
        res = won(res, wins)._replace(transform=transform, fitness=_to_device(fitness, device, "ladder"))
    return res


@spanned("register_pair")
def register_pair(
    source: Union[PointCloud, np.ndarray, torch.Tensor],
    target: Union[PointCloud, np.ndarray, torch.Tensor],
    cfg: KSSICPConfig = DEFAULT_CONFIG,
    device="cuda",
    timer: Optional[Timer] = None,
) -> RegistrationResult:
    """Single-pair registration (the reference `main` path) with escalation.

    Accepts (N, 3) arrays or padded PointClouds; resamples both by FPS (or
    AIVS, its boxes from max(n_s, n_t)) and runs register_batch on a batch of
    this one pair on `device`. The returned transform maps the
    full-resolution source into the target frame: apply it with
    `apply_similarity` and measure with `metrics.registration_measure`.

    With the two-stage converge (refine_polish_iterations and
    refine_max_iterations both set), a pair whose final converge hit its cap
    is continued by `continue_capped`, the result with the lower fitness is
    kept, and refine_hit_cap is cleared (JAX :895-904).

    With cfg.auto_escalate, the pair climbs `escalation_ladder` as
    register_pair does in JAX (pair=True): the 16^3 re-solve, the uncapped
    finisher and, with cfg.overlap_escalate, the overlap tier. A result that
    a re-solve won carries that solve's coarse field and candidates.
    cfg.overlap_mode runs register_overlap_resampled alone, and its result's
    fitness is trimmed.

    `timer` is entered around each stage: "resample", those of the base
    register_batch, "two_stage" when the pair is continued, then "escalate"
    when the pair is flagged, "finish" when
    the finisher runs, and "overlap8", "overlap16" and "overlap_screen" for
    each overlap rung that runs ("overlap" with overlap_mode)."""
    device = _device(device)
    if not isinstance(source, PointCloud):
        source = PointCloud.from_points(source, device=device)
    if not isinstance(target, PointCloud):
        target = PointCloud.from_points(target, device=device)
    source, target = source.to(device), target.to(device)
    n_s, n_t = int(source.count), int(target.count)
    pnumber = cfg.resample_count(n_s, n_t)
    cfg = _resolve_aivs_boxes(cfg, max(n_s, n_t))
    with span("sync.resample"):
        pn = torch.tensor([pnumber], device=device)
    with span("resample", timer):
        clouds = resample_batch(source.points[None], source.mask[None], pn, cfg, steps=pnumber)
        clouds += resample_batch(target.points[None], target.mask[None], pn, cfg, steps=pnumber)
    if cfg.overlap_mode:
        # The caller knows the scans overlap partially: the overlap solve alone.
        with span("overlap", timer):
            return _first(register_overlap_resampled(*clouds, cfg))
    res = register_batch(*clouds, cfg, timer)
    if two_stage(cfg):
        # The continuation is the designated finisher of the capped converge.
        res = continue_capped(res, clouds, cfg, timer)._replace(refine_hit_cap=torch.zeros_like(res.refine_hit_cap))
    if cfg.auto_escalate:
        res = escalation_ladder(res, clouds, cfg, timer=timer, pair=True)
    return _first(res)
