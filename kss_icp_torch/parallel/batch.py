"""Batched pair registration on one GPU (port of kss_icp_tpu/parallel/batch.py).

The sweep axis of the reference's Main_KSS_List loop: B independent
(source, target) pairs through one pipeline. JAX vmaps the single-pair
program and shards the pair axis over a device mesh; here every stage of
models/kss_icp.py takes the pair axis itself. One `fps` launch resamples all
2B clouds, each pair's fields are scored by their own launches, and each ICP
stage runs the lanes of all B pairs in one lockstep loop, each lane against
its own pair's target, so the host pays an iteration once for the batch.
A device mesh (multi-GPU) is not ported: ROADMAP.md queue 1 item 13.
The escalation ladder after the base pass is models/kss_icp.py::
escalation_ladder, which register_pair runs too.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from kss_icp_torch.config import DEFAULT_CONFIG, KSSICPConfig
from kss_icp_torch.core.transforms import Similarity, apply_similarity
from kss_icp_torch.metrics import registration_measure_padded
from kss_icp_torch.models import kss_icp as kss
from kss_icp_torch.models.kss_icp import RegistrationResult, Timer, _stage


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("kss_icp_torch runs on one GPU; a device mesh is not ported yet: "
                                  "ROADMAP.md queue 1 item 13 (multi-GPU)")


def register_batch(
    source_points: torch.Tensor,   # (B, P, 3)
    source_mask: torch.Tensor,     # (B, P)
    target_points: torch.Tensor,   # (B, P, 3)
    target_mask: torch.Tensor,     # (B, P)
    cfg: KSSICPConfig = DEFAULT_CONFIG,
    mesh=None,
    timer: Optional[Timer] = None,
) -> RegistrationResult:
    """Register B resampled pairs at once (kss_icp_tpu/parallel/batch.py:37-74):
    models/kss_icp.py::register_batch. `mesh` must be None."""
    _no_mesh(mesh)
    return kss.register_batch(source_points, source_mask, target_points, target_mask, cfg, timer)


def overlap_batch(
    source_points: torch.Tensor,
    source_mask: torch.Tensor,
    target_points: torch.Tensor,
    target_mask: torch.Tensor,
    baseline: Similarity,
    cfg: KSSICPConfig = DEFAULT_CONFIG,
    mesh=None,
    solver: str = "field",
):
    """The overlap tier's re-solve of B flagged pairs (batch.py:77-113):
    solver "field" (the 8^3 and 16^3 rungs, overlap_solve_batch) or "screen"
    (overlap_screen_solve_batch). Returns (transform, fit_std, tfit_new,
    tfit_old), each leading with B. `mesh` must be None."""
    _no_mesh(mesh)
    solve = kss.overlap_solve_batch if solver == "field" else kss.overlap_screen_solve_batch
    return solve(source_points, source_mask, target_points, target_mask, baseline, cfg)


def register_many(
    pairs,
    cfg: KSSICPConfig = DEFAULT_CONFIG,
    mesh=None,
    full_pad: int = 8192,
    escalate: Optional[bool] = None,
    escalate_threshold: Optional[float] = None,
    escalate_cfg: Optional[KSSICPConfig] = None,
    device="cuda",
    timer: Optional[Timer] = None,
):
    """Host-facing batched sweep (kss_icp_tpu/parallel/batch.py:116-345):
    [(source (Ns, 3), target (Nt, 3)), ...] raw variable-size clouds ->
    (RegistrationResult batch, {"mse", "rmse", "mae"} as (B,) numpy arrays).

    Pads every cloud to `full_pad` rows (truncating a larger one),
    FPS-resamples pair b to resample_count(Ns, Nt) points (one launch over
    the 2B clouds; AIVS with resampler="aivs", its boxes from the largest
    valid count of the batch), registers the batch (register_batch), continues
    the pairs whose capped final converge hit its cap with the two-stage
    converge (models/kss_icp.py::continue_capped; refine_polish_iterations
    and refine_max_iterations both set), applies
    each transform to its padded full-resolution source and measures it
    against its target (one nn1 launch). With escalation (cfg.auto_escalate by
    default), the batch climbs models/kss_icp.py::escalation_ladder at
    `escalate_threshold` and `escalate_cfg` (cfg.escalation_config()): the
    16^3 re-solve, the uncapped finisher and, with cfg.overlap_escalate, the
    three overlap rungs, overlap_threshold re-checked before each. With the
    two-stage converge, the cap no longer flags a pair for the re-solve, and
    a continued pair keeps its refine_hit_cap, so the finisher runs on it
    where the re-solve does not win (JAX batch.py:238-239). The returned
    result keeps the base pass's candidate fields; the transform, fitness
    and refine_hit_cap are the ladder's.

    `timer` is entered around each stage: "resample", "coarse", "screen",
    "refine", then "two_stage", "escalate", "finish", "overlap8",
    "overlap16" and "overlap_screen" when they run, and "metric". `mesh`
    raises NotImplementedError."""
    _no_mesh(mesh)
    device = kss._device(device)
    if escalate is None:
        escalate = cfg.auto_escalate

    def padded(clouds):
        pts = np.zeros((len(clouds), full_pad, 3), np.float32)
        mask = np.zeros((len(clouds), full_pad), bool)
        for b, c in enumerate(clouds):
            c = np.asarray(c, np.float32)[:full_pad]
            pts[b, :len(c)], mask[b, :len(c)] = c, True
        return torch.as_tensor(pts).to(device), torch.as_tensor(mask).to(device)

    s_pts, s_msk = padded([s for s, _ in pairs])
    t_pts, t_msk = padded([t for _, t in pairs])
    counts = [cfg.resample_count(min(len(s), full_pad), min(len(t), full_pad)) for s, t in pairs]
    cfg = kss._resolve_aivs_boxes(cfg, max(min(len(c), full_pad) for pair in pairs for c in pair))
    with _stage(timer, "resample"):
        (sp, sm), (tp, tm) = kss.resample_pairs(s_pts, s_msk, t_pts, t_msk, torch.tensor(counts, device=device),
                                                cfg, steps=max(counts))
    res = kss.register_batch(sp, sm, tp, tm, cfg, timer)
    res = kss.continue_capped(res, (sp, sm, tp, tm), cfg, timer)
    if escalate:
        res = kss.escalation_ladder(res, (sp, sm, tp, tm), cfg, escalate_threshold, escalate_cfg, timer)
    with _stage(timer, "metric"):
        metrics = registration_measure_padded(apply_similarity(res.transform, s_pts), s_msk, t_pts, t_msk)
    return res, {k: v.cpu().numpy() for k, v in metrics.items()}
