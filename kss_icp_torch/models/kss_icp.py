"""The KSS-ICP registration pipeline (port of kss_icp_tpu/models/kss_icp.py).

KSSICP_Registration (KSS_ICP.hpp:69-131) as batched tensor stages:

  1. FPS-resample both clouds to pNumber = min(|S|,|T|)//2 (≤ 2000), padded
     to 2048 (`fps` kernel, which stops after pNumber picks);
  2. Kendall pre-shape alignment (core/preshape.py);
  3. the Euler-grid coarse field (`field_ave` or `field_dot` kernel, by
     `coarse_method`) and its local-minima candidate list (models/coarse.py);
  4. multi-start ICP over all candidates at once (models/icp.py, `nn1`
     kernel), with the fitness gate of KSS_ICP.hpp:99 and, where
     `pose_tiebreak_margin` is set, the symmetric-pose tie-break;
  5. the winning transform composed as one Sim3.

register_pair adds the escalation of the JAX package: a pair whose fitness
is above `escalate_threshold`, or whose final converge hit its iteration
cap, is re-solved on the 16^3 grid (`escalation_config()`), the better
result is kept, and a result still at its cap is finished by an uncapped
warm-started ICP (`polish_resampled`).

Implemented: both `multistart_mode`s, the two-tier refine with its
prefix-target gate probe, the pose tie-break and escalation without the
overlap tier. Every knob of the JAX pipeline that is not ported raises
NotImplementedError naming its ROADMAP.md item, so the port never returns
an answer that differs from JAX.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from kss_icp_torch.config import DEFAULT_CONFIG, KSSICPConfig
from kss_icp_torch.core.cloud import PointCloud
from kss_icp_torch.core.preshape import middle_align
from kss_icp_torch.core.transforms import Similarity, apply_similarity, compose, euler_xyz_matrix, rotate_points
from kss_icp_torch.models.coarse import CoarseResult, coarse_align
from kss_icp_torch.models.icp import ICPParams, icp
from kss_icp_torch.ops.nn import masked_quantile_threshold
from kss_icp_torch.ops.nn_cuda import nn1
from kss_icp_torch.ops.resample_cuda import fps

BIG = 1e30

# (test, knob, where the port of that knob is queued). `pair_only` knobs are
# read by register_pair alone, as in the JAX package.
_UNPORTED = (
    (lambda c: c.auto_escalate and c.overlap_escalate, "auto_escalate with overlap_escalate=True "
     "(pass overlap_escalate=False for escalation without the overlap tier)",
     "ROADMAP.md queue 1 item 11 (overlap tier)", True),
    (lambda c: c.overlap_mode, "overlap_mode=True", "ROADMAP.md queue 1 item 11 (overlap tier)", True),
    (lambda c: c.refine_polish_iterations != 0, "refine_polish_iterations != 0",
     "ROADMAP.md 'Not ported' (two-stage converge)", True),
    (lambda c: c.resampler != "fps", "resampler != 'fps'", "ROADMAP.md queue 1 item 13 (aivs)", True),
    (lambda c: bool(c.neighborhood_fracs), "neighborhood_fracs", "ROADMAP.md queue 1 item 13 (precision mode)", False),
    (lambda c: c.icp_variant != "point_to_point", "icp_variant != 'point_to_point'",
     "ROADMAP.md queue 1 item 13 (normals)", False),
    (lambda c: c.coarse_error_metric != "ave", "coarse_error_metric != 'ave'",
     "ROADMAP.md queue 1 items 11 and 13", False),
    (lambda c: c.icp_trim_fraction != 0, "icp_trim_fraction != 0", "ROADMAP.md queue 1 item 11 (overlap tier)", False),
    (lambda c: c.icp_estimate_scale, "icp_estimate_scale=True", "ROADMAP.md queue 1 item 11 (overlap tier)", False),
)


def check_supported(cfg: KSSICPConfig, pair: bool = False) -> None:
    """Raise NotImplementedError for a knob this slice of the port lacks."""
    for test, knob, where, pair_only in _UNPORTED:
        if (pair or not pair_only) and test(cfg):
            raise NotImplementedError(f"kss_icp_torch does not implement {knob} yet: {where}")


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


def _stage(timer: Optional[Timer], name: str):
    return timer(name) if timer is not None else contextlib.nullcontext()


def _prefix(points, mask, n):
    if n and n < points.shape[0]:
        return points[:n], mask[:n]
    return points, mask


def _lane(res, k: int):
    """(rotation, translation, scale) of lane k, kept as 1-lane batches."""
    return res.rotation[k:k + 1], res.translation[k:k + 1], res.scale[k:k + 1]


def _pose_tiebreak_select(
    fit: torch.Tensor,            # (K,) candidate fitnesses (1e30 = invalid)
    aligned: torch.Tensor,        # (K, P, 3) candidate-aligned source clouds
    source_mask: torch.Tensor,    # (P,)
    target_points: torch.Tensor,
    target_mask: torch.Tensor,
    cfg: KSSICPConfig,
) -> torch.Tensor:
    """Symmetric-pose tie-break (kss_icp_tpu/models/kss_icp.py:394-419): among
    the candidates whose fitness is within (1 + pose_tiebreak_margin) of the
    best, the one with the smallest pose_tiebreak_quantile of its 1-NN
    distances; first index on ties. A slid symmetric pose barely moves the
    mean squared distance but lifts the high quantile."""
    near = fit <= fit.min() * (1.0 + cfg.pose_tiebreak_margin)
    d2, _ = nn1(aligned.contiguous(), target_points[None].contiguous(), target_mask[None].contiguous())
    q = masked_quantile_threshold(torch.sqrt(d2), source_mask.expand(d2.shape), cfg.pose_tiebreak_quantile)
    return torch.argmin(torch.where(near, q, torch.full_like(q, BIG)))


def register_resampled(
    source_points: torch.Tensor,
    source_mask: torch.Tensor,
    target_points: torch.Tensor,
    target_mask: torch.Tensor,
    cfg: KSSICPConfig = DEFAULT_CONFIG,
    timer: Optional[Timer] = None,
) -> RegistrationResult:
    """Register two already-resampled padded clouds (steps 2-5 above).

    Shapes (P, 3)/(P,). `timer`, when given, is entered around each stage
    ("coarse", "screen", "refine") — a hook for measurement."""
    check_supported(cfg)
    dtype = source_points.dtype
    zero3 = torch.zeros((3,), dtype=dtype, device=source_points.device)
    params = ICPParams.from_config(cfg)
    gate = cfg.multistart_fitness_gate

    with _stage(timer, "coarse"):
        # 2. Kendall pre-shape normalization.
        sim0, _, _ = middle_align(source_points, source_mask, target_points, target_mask)
        src_aligned = apply_similarity(sim0, source_points)
        # 3. Rotation-grid coarse search on optional FPS prefixes.
        score_src, score_mask = _prefix(src_aligned, source_mask, cfg.coarse_points)
        score_tgt, score_tmask = _prefix(target_points, target_mask, cfg.coarse_target_points)
        coarse = coarse_align(
            score_src.contiguous(), score_mask, score_tgt, score_tmask,
            steps=cfg.rotation_steps, span=cfg.angle_span, radius=cfg.kernel_radius,
            max_candidates=cfg.max_candidates, error_metric=cfg.coarse_error_metric,
            method=cfg.coarse_method, precision=cfg.coarse_precision)
        r_cand = euler_xyz_matrix(coarse.candidate_angles)  # (K, 3, 3)
        rotated = rotate_points(r_cand, src_aligned[None]).contiguous()  # (K, P, 3)

    def result(res_lane, k_local, sel, judge, iterations, final_cap):
        """Compose ICP ∘ R_candidate ∘ preshape for local lane k_local."""
        choice = sel[k_local]
        icp_sim = Similarity(scale=res_lane.scale[k_local], rotation=res_lane.rotation[k_local],
                             translation=res_lane.translation[k_local])
        cand_sim = Similarity.from_rigid(r_cand[choice], zero3)
        return RegistrationResult(
            transform=compose(icp_sim, compose(cand_sim, sim0)),
            fitness=res_lane.fitness[k_local],
            judge_fitness=judge,
            used_multistart=judge > gate,
            chosen_candidate=choice,
            icp_iterations=iterations,
            refine_hit_cap=(res_lane.iterations[k_local] >= final_cap) & ~res_lane.converged[k_local],
            coarse=coarse,
        )

    def pick(fit, judge, res_lanes, lanes):
        """Lane 0 when the gate passes (KSS_ICP.hpp:99), else argmin fitness,
        or the pose tie-break among the near-tied lanes where it is on."""
        if bool(judge <= gate):
            return 0
        if not cfg.pose_tiebreak_margin:
            return int(torch.argmin(fit))
        aligned = (res_lanes.scale[:, None, None] * rotate_points(res_lanes.rotation, lanes)
                   + res_lanes.translation[:, None, :])
        return int(_pose_tiebreak_select(fit, aligned, source_mask, target_points, target_mask, cfg))

    refine_cap = params.max_iterations
    if cfg.refine_max_iterations:
        refine_cap = min(cfg.refine_max_iterations, cfg.max_icp_iterations)
    refine_params = params._replace(max_iterations=refine_cap)
    big = torch.full((), BIG, dtype=dtype, device=source_points.device)

    if cfg.multistart_mode != "two_phase":  # "full", as any other value is in JAX
        with _stage(timer, "refine"):
            sel = torch.arange(rotated.shape[0], device=rotated.device)
            res = icp(rotated, source_mask, target_points, target_mask, refine_params)
            fit = torch.where(coarse.candidate_mask, res.fitness, big)
            k = pick(fit, fit[0], res, rotated)
            out = result(res, k, sel, fit[0], res.iterations[k], refine_cap)
        return out._replace(fitness=fit[k])

    # Two-phase: screen every candidate with a short solve on the source's
    # first screen_points rows (an FPS prefix is a uniform subsample).
    with _stage(timer, "screen"):
        sp_n = min(cfg.screen_points, source_points.shape[0])
        screen_tgt, screen_tmask = _prefix(target_points, target_mask, cfg.screen_target_points)
        res1 = icp(rotated[:, :sp_n].contiguous(), source_mask[:sp_n], screen_tgt, screen_tmask,
                   params._replace(max_iterations=cfg.screen_iterations))
        fit1 = torch.where(coarse.candidate_mask, res1.fitness, big)
        # Candidate 0 (the best grid angle) always survives: the gate is defined on it.
        n_refine = min(cfg.refine_candidates, fit1.shape[0])
        fit1 = fit1.clone()
        fit1[0] = -float("inf")
        sel = torch.argsort(fit1, stable=True)[:n_refine]
        init = (res1.rotation[sel], res1.translation[sel], res1.scale[sel])

    with _stage(timer, "refine"):
        if not cfg.refine_tier_iterations:
            res = icp(rotated[sel], source_mask, target_points, target_mask, refine_params, *init)
            fit = torch.where(coarse.candidate_mask[sel], res.fitness, big)
            k = pick(fit, fit[0], res, rotated[sel])
            out = result(res, k, sel, fit[0], res.iterations[k], refine_cap)
            return out._replace(fitness=fit[k])

        # Two-tier refine: a capped solve on every selected lane ranks them,
        # then only the winner converges fully.
        cap_tgt, cap_tmask = _prefix(target_points, target_mask, cfg.refine_tier_target_points)
        res_a = icp(rotated[sel], source_mask, cap_tgt, cap_tmask,
                    params._replace(max_iterations=cfg.refine_tier_iterations), *init)
        fit_a = torch.where(coarse.candidate_mask[sel], res_a.fitness, big)
        judge_a = fit_a[0]
        if cap_tgt.shape[0] < target_points.shape[0]:
            # The gate is absolute and a prefix target inflates fitness:
            # re-evaluate candidate 0 on the full target (no ICP steps).
            probe = icp(rotated[sel[:1]], source_mask, target_points, target_mask,
                        params._replace(max_iterations=0), *_lane(res_a, 0))
            judge_a = torch.where(coarse.candidate_mask[sel[0]], probe.fitness[0], big)
        k = pick(fit_a, judge_a, res_a, rotated[sel])
        res = icp(rotated[sel[k:k + 1]], source_mask, target_points, target_mask, refine_params,
                  *_lane(res_a, k))
        return result(res, 0, sel[k:k + 1], judge_a, res_a.iterations[k] + res.iterations[0], refine_cap)


def resample_batch(
    points: torch.Tensor,
    mask: torch.Tensor,
    pnumber: torch.Tensor,
    cfg: KSSICPConfig = DEFAULT_CONFIG,
    pad: Optional[int] = None,
    steps: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """FPS-resample (B, N, 3) padded clouds to (B, resample_pad, 3), keeping
    pnumber[b] valid samples of cloud b (the `fps` kernel on CUDA).

    `steps`, a host int, makes only the first min(steps, pad) FPS picks: the
    slots past pnumber are masked and zeroed anyway and picks are
    prefix-stable, so with steps >= max(pnumber) the output is bit-identical
    to the full run's (and JAX's). A smaller `steps` keeps `steps` samples."""
    if cfg.resampler != "fps":
        raise NotImplementedError("kss_icp_torch does not implement resampler != 'fps' yet: "
                                  "ROADMAP.md queue 1 item 13 (aivs)")
    p = pad if pad is not None else cfg.resample_pad
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
):
    """Resample B source + target pairs (same padded N) as one 2B-cloud batch.
    Returns ((src_pts, src_mask), (tgt_pts, tgt_mask))."""
    pts = torch.cat([source_points, target_points], dim=0)
    msk = torch.cat([source_mask, target_mask], dim=0)
    rp, rm = resample_batch(pts, msk, torch.cat([pnumber, pnumber], dim=0), cfg, pad)
    b = source_points.shape[0]
    return (rp[:b], rm[:b]), (rp[b:], rm[b:])


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("register_pair(device='cuda') needs a CUDA device; pass device='cpu' for the plain path")
    return device


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
    escalation's uncapped finisher. Returns (transform, fitness, iterations)."""
    check_supported(cfg)
    current = apply_similarity(transform, source_points)
    cap = min(cfg.refine_polish_iterations or cfg.max_icp_iterations, cfg.max_icp_iterations)
    res = icp(current[None].contiguous(), source_mask, target_points, target_mask,
              ICPParams.from_config(cfg)._replace(max_iterations=cap))
    step = Similarity(scale=res.scale[0], rotation=res.rotation[0], translation=res.translation[0])
    return compose(step, transform), res.fitness[0], res.iterations[0]


def register_pair(
    source: Union[PointCloud, np.ndarray, torch.Tensor],
    target: Union[PointCloud, np.ndarray, torch.Tensor],
    cfg: KSSICPConfig = DEFAULT_CONFIG,
    device="cuda",
    timer: Optional[Timer] = None,
) -> RegistrationResult:
    """Single-pair registration (the reference `main` path) with escalation.

    Accepts (N, 3) arrays or padded PointClouds; resamples both by FPS and
    runs register_resampled on `device`. The returned transform maps the
    full-resolution source into the target frame: apply it with
    `apply_similarity` and measure with `metrics.registration_measure`.

    With cfg.auto_escalate, a pair whose fitness exceeds escalate_threshold
    or whose final converge hit its cap is re-solved on the same resampled
    clouds with cfg.escalation_config() and the better fitness wins; a
    result still at its cap is then finished by polish_resampled
    (kss_icp_tpu/models/kss_icp.py:905-937). The overlap tier that follows
    in the JAX package is not ported: auto_escalate needs
    overlap_escalate=False until ROADMAP.md queue 1 item 11.

    `timer` is entered around each stage: "resample", those of the base
    register_resampled, then "escalate" (the whole re-solve) when the pair
    is flagged and "finish" when the finisher runs. A result that the
    re-solve won carries its 16^3 `coarse` field."""
    check_supported(cfg, pair=True)
    device = _device(device)
    if not isinstance(source, PointCloud):
        source = PointCloud.from_points(source, device=device)
    if not isinstance(target, PointCloud):
        target = PointCloud.from_points(target, device=device)
    source, target = source.to(device), target.to(device)
    pnumber = cfg.resample_count(int(source.count), int(target.count))
    pn = torch.tensor([pnumber], device=device)
    with _stage(timer, "resample"):
        src_pts, src_mask = resample_batch(source.points[None], source.mask[None], pn, cfg, steps=pnumber)
        tgt_pts, tgt_mask = resample_batch(target.points[None], target.mask[None], pn, cfg, steps=pnumber)
    clouds = (src_pts[0], src_mask[0], tgt_pts[0], tgt_mask[0])
    res = register_resampled(*clouds, cfg, timer=timer)
    if not cfg.auto_escalate:
        return res
    from kss_icp_torch.escalate import escalate_rerun

    ecfg = cfg.escalation_config()

    def resolve(_sel):
        r2 = register_resampled(*clouds, ecfg)
        return r2, r2.fitness.reshape(1).cpu().numpy()

    # The hit-cap fold: a lane still unconverged after the capped final
    # converge is re-solved whatever its fitness.
    if float(res.fitness) > cfg.escalate_threshold or bool(res.refine_hit_cap):
        with _stage(timer, "escalate"):
            _, _, wins, _ = escalate_rerun(resolve, res.fitness.reshape(1).cpu().numpy(),
                                           cfg.escalate_threshold, pad_multiple=1, flags=np.asarray([True]))
        if wins:
            res = wins[-1][1]
    if bool(res.refine_hit_cap):
        # The escalation solve runs capped too: finish the kept lane uncapped.
        with _stage(timer, "finish"):
            total, fit2, _ = polish_resampled(*clouds, res.transform, ecfg)
            if float(fit2) < float(res.fitness):
                res = res._replace(transform=total, fitness=fit2)
            res = res._replace(refine_hit_cap=torch.zeros((), dtype=torch.bool, device=device))
    return res
