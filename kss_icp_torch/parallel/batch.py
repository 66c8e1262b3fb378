"""Batched pair registration, on one GPU or over a mesh's "pairs" axis (port
of kss_icp_tpu/parallel/batch.py).

The sweep axis of the reference's Main_KSS_List loop: B independent
(source, target) pairs through one pipeline. JAX vmaps the single-pair
program and shards the pair axis over a device mesh; here every stage of
models/kss_icp.py takes the pair axis itself. One `fps` launch resamples all
2B clouds, each pair's fields are scored by their own launches, and each ICP
stage runs the lanes of all B pairs in one lockstep loop, each lane against
its own pair's target, so the host pays an iteration once for the batch.
The escalation ladder after the base pass is models/kss_icp.py::
escalation_ladder, which register_pair runs too.

With a mesh (parallel/mesh.py), each rank runs the same on its contiguous
slice of the pairs and all-gathers every field of the result in rank order,
so every rank returns the whole batch. No collective crosses a pair. On the
CPU a pair's answer is the same bits whatever its batch-mates; on the card
a slice's batched reductions and 3 x 3 SVDs round by its lane count, so the
mesh's rows equal the unsharded batch's only within that rounding (ROADMAP
queue 3, "A batch's answers are not one pair's bits"). Where B does not divide
the axis, the batch is padded by repeating its last pair and the pads are
dropped after the gather (JAX falls back to a global program instead). Each
rank climbs the escalation ladder on its own pairs; JAX re-balances the
flagged pairs over the mesh, for the same answers.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from kss_icp_torch.config import DEFAULT_CONFIG, KSSICPConfig
from kss_icp_torch.core.transforms import Similarity, apply_similarity
from kss_icp_torch.escalate import tree_map
from kss_icp_torch.metrics import registration_measure_padded
from kss_icp_torch.models import kss_icp as kss
from kss_icp_torch.models.kss_icp import RegistrationResult, Timer
from kss_icp_torch.parallel.mesh import all_gather_rows, axis_rank
from kss_icp_torch.utils.profiling import span, spanned


def _over_pairs(mesh, b: int, run, timer: Optional[Timer] = None):
    """run(rows) on this rank's contiguous slice of b pairs along the mesh's
    "pairs" axis, `rows` their indices (the batch padded by repeating its
    last pair to a multiple of the axis size), then every rank's result tree
    all-gathered in rank order and the pads dropped: each rank returns the
    whole batch's. The slice runs in the span "mesh.slice" (and in
    `timer("mesh.slice")` where a timer is given), the gathers in
    "mesh.gather"."""
    size, rank = axis_rank(mesh, "pairs")
    per = -(-b // size)
    with span("mesh.slice", timer):
        out = run([min(i, b - 1) for i in range(rank * per, (rank + 1) * per)])
    group = mesh.get_group("pairs")
    with span("mesh.gather"):
        return tree_map(lambda x: all_gather_rows(x, group)[:b], out)


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
    models/kss_icp.py::register_batch, with a mesh on each rank's slice of
    the pairs along its "pairs" axis, the result gathered."""
    clouds = (source_points, source_mask, target_points, target_mask)
    if mesh is None:
        return kss.register_batch(*clouds, cfg, timer)
    return _over_pairs(mesh, source_points.shape[0],
                       lambda rows: kss.register_batch(*(x[rows] for x in clouds), cfg, timer))


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
    tfit_old), each leading with B; with a mesh, each rank solves its slice
    of the pairs along its "pairs" axis and the results are gathered."""
    solve = kss.overlap_solve_batch if solver == "field" else kss.overlap_screen_solve_batch
    args = (source_points, source_mask, target_points, target_mask, baseline)
    if mesh is None:
        return solve(*args, cfg)
    return _over_pairs(mesh, source_points.shape[0],
                       lambda rows: solve(*tree_map(lambda x: x[rows], args), cfg))


@spanned("register_many")
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
    "overlap16" and "overlap_screen" when they run, and "metric"; with a
    mesh, "mesh.slice" around all of these on the rank's own slice.

    With a mesh, each rank runs all of the above on its contiguous slice of
    the pairs along the mesh's "pairs" axis (its own ladder too), and every
    rank returns the whole batch, gathered. The AIVS boxes come from the
    whole batch, not from a rank's slice: on the CPU a pair's answer is the
    same bits on any rank; on the card, within the batch rounding of ROADMAP
    queue 3."""
    device = kss._device(device)
    if escalate is None:
        escalate = cfg.auto_escalate
    cfg = kss._resolve_aivs_boxes(cfg, max(min(len(c), full_pad) for pair in pairs for c in pair))

    def run(rows):
        return _register_many([pairs[i] for i in rows], cfg, full_pad, escalate, escalate_threshold, escalate_cfg,
                              device, timer)

    res, metrics = run(range(len(pairs))) if mesh is None else _over_pairs(mesh, len(pairs), run, timer)
    with span("sync.result"):
        return res, {k: v.cpu().numpy() for k, v in metrics.items()}


def _register_many(pairs, cfg, full_pad, escalate, escalate_threshold, escalate_cfg, device, timer):
    """register_many's body on one rank's pairs: (result, metrics as tensors)."""

    def padded(clouds):
        pts = np.zeros((len(clouds), full_pad, 3), np.float32)
        mask = np.zeros((len(clouds), full_pad), bool)
        for b, c in enumerate(clouds):
            c = np.asarray(c, np.float32)[:full_pad]
            pts[b, :len(c)], mask[b, :len(c)] = c, True
        with span("sync.upload"):
            return torch.as_tensor(pts).to(device), torch.as_tensor(mask).to(device)

    s_pts, s_msk = padded([s for s, _ in pairs])
    t_pts, t_msk = padded([t for _, t in pairs])
    counts = [cfg.resample_count(min(len(s), full_pad), min(len(t), full_pad)) for s, t in pairs]
    with span("resample", timer):
        with span("sync.resample"):
            pnumber = torch.tensor(counts, device=device)
        (sp, sm), (tp, tm) = kss.resample_pairs(s_pts, s_msk, t_pts, t_msk, pnumber, cfg, steps=max(counts))
    res = kss.register_batch(sp, sm, tp, tm, cfg, timer)
    res = kss.continue_capped(res, (sp, sm, tp, tm), cfg, timer)
    if escalate:
        res = kss.escalation_ladder(res, (sp, sm, tp, tm), cfg, escalate_threshold, escalate_cfg, timer)
    with span("metric", timer):
        metrics = registration_measure_padded(apply_similarity(res.transform, s_pts), s_msk, t_pts, t_msk)
    return res, metrics
