"""Fitness-gated escalation: flag -> re-solve on the finer grid -> keep-better.

Port of kss_icp_tpu/escalate.py (padded_selection, escalate_rerun,
overlap_rerun and polish_rerun), the host logic around the re-solves of the
escalation ladder. Reference intent: KSS_ICP.hpp:99-121 — when the fitness
gate fails, spend more work (here a 16^3 rotation grid with a wider candidate
budget) and keep the better answer per row.

The JAX version merges winning rows with jax.tree.map; here the trees are
the port's NamedTuples (or dicts, tuples and lists) of tensors or numpy
arrays. register_pair and register_many both climb
models/kss_icp.py::escalation_ladder, which calls these three, and both
continue a capped converge through polish_rerun (models/kss_icp.py::
continue_capped).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch


def padded_selection(flagged: np.ndarray, pad_multiple: int, cap: Optional[int] = None) -> np.ndarray:
    """Pad an index list by repeating its first entry up to a multiple of
    `pad_multiple` (optionally capped at `cap` rows)."""
    m = max(int(pad_multiple), 1)
    n = ((flagged.size + m - 1) // m) * m
    if cap is not None:
        n = max(min(n, cap), flagged.size)
    extra = max(n - flagged.size, 0)
    if extra == 0:
        return flagged
    return np.concatenate([flagged, np.repeat(flagged[:1], extra)])


def tree_map(fn, *trees):
    """fn over the leaves of NamedTuples, dicts, tuples and lists of arrays."""
    head = trees[0]
    if isinstance(head, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in head}
    if isinstance(head, tuple) and hasattr(head, "_fields"):
        return type(head)(*(tree_map(fn, *parts) for parts in zip(*trees)))
    if isinstance(head, (tuple, list)):
        return type(head)(tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def _copy(x):
    return x.clone() if isinstance(x, torch.Tensor) else np.array(x, copy=True)


def _set_row(full, new, gi: int, j: int):
    """full[gi] = new[j], across tensor and numpy leaves."""
    row = new[j]
    if isinstance(full, torch.Tensor):
        full[gi] = torch.as_tensor(row, dtype=full.dtype).to(full.device)
    else:
        full[gi] = row.cpu().numpy() if isinstance(row, torch.Tensor) else row
    return full


def escalate_rerun(
    resolve: Callable[[np.ndarray], Tuple[object, np.ndarray]],
    fitness: np.ndarray,
    threshold: Optional[float],
    pad_multiple: int,
    result=None,
    cap: Optional[int] = None,
    chunk: Optional[int] = None,
    flags: Optional[np.ndarray] = None,
    near_tie_margin: float = 0.0,
):
    """Run the flag -> padded re-solve -> keep-better pass.

    `resolve(sel) -> (result_tree, fitness2)` re-solves the rows indexed by
    `sel` at escalation settings, `fitness2` of shape (len(sel),). Rows with
    fitness > threshold are flagged, or the rows of `flags` where it is
    given. The selection is padded by repetition to a multiple of
    `pad_multiple` (at most `cap` rows, default B) and, with `chunk`,
    re-solved worst fitness first in chunks of that many rows. `result`, a
    tree with leading axis B, takes every row the re-solve improves
    (fit2 < fitness); pass only config-independent leaves (transform and
    fitness, not the coarse field, whose shape follows the grid).

    With `near_tie_margin`, a row adopts the re-solve where
    fit2 < fitness * (1 + near_tie_margin), not only where it is strictly
    better (kss_icp_tpu/escalate.py:49-55): the escalation's symmetric-pose
    tie-break may find the true pose at a slightly worse fitness than a slid
    impostor. The adopted row's fitness is always the re-solve's own. 0, the
    default, is strict keep-better.

    Returns (result, fitness, wins, n_flagged), `wins` a list of
    (global_index, chunk_result_tree, row_in_chunk) for every improved row."""
    fitness = np.asarray(fitness).copy()
    b = fitness.shape[0]
    if flags is not None:
        flagged = np.nonzero(np.asarray(flags))[0]
    else:
        flagged = np.nonzero(fitness > threshold)[0]
    if flagged.size == 0:
        return result, fitness, [], 0
    sel = padded_selection(flagged, pad_multiple, cap if cap is not None else b)
    if chunk and sel.size > chunk:
        # Worst-fitness rows first, so the easy chunks' lockstep loops exit early.
        sel = sel[np.argsort(-fitness[sel])]
    if result is not None:
        result = tree_map(_copy, result)
    step = chunk if chunk else sel.size
    wins = []
    for c0 in range(0, sel.size, step):
        csel = sel[c0:c0 + step]
        res2, fit2 = resolve(csel)
        fit2 = np.asarray(fit2)
        for j, gi in enumerate(csel):
            if fit2[j] < fitness[gi] * (1.0 + near_tie_margin):
                fitness[gi] = fit2[j]
                wins.append((int(gi), res2, j))
                if result is not None:
                    tree_map(lambda full, new, _gi=gi, _j=j: _set_row(full, new, _gi, _j), result, res2)
    return result, fitness, wins, int(flagged.size)


def overlap_rerun(
    resolve: Callable[[np.ndarray], Tuple[object, np.ndarray, np.ndarray, np.ndarray]],
    fitness: np.ndarray,
    threshold: Optional[float],
    pad_multiple: int,
    margin: float,
    result=None,
    cap: Optional[int] = None,
    chunk: Optional[int] = None,
    flags: Optional[np.ndarray] = None,
):
    """The overlap tier's rerun (kss_icp_tpu/escalate.py:130-194): rows with
    fitness > threshold, or the rows of `flags`, are re-solved by
    `resolve(sel) -> (result_tree, fit_std, tfit_new, tfit_old)`, where the
    trimmed fitnesses are the bidirectional ones of the overlap solve and of
    the incumbent. A row is adopted iff tfit_new < margin * tfit_old (a
    correct partial alignment has a worse untrimmed fitness than a wrong
    crop-biased one), once at most, and its fitness becomes fit_std.
    Selection, padding and chunks as in escalate_rerun (no worst-first
    order). Returns (result, fitness, wins, n_flagged)."""
    fitness = np.asarray(fitness).copy()
    b = fitness.shape[0]
    if flags is not None:
        flagged = np.nonzero(np.asarray(flags))[0]
    else:
        flagged = np.nonzero(fitness > threshold)[0]
    if flagged.size == 0:
        return result, fitness, [], 0
    sel = padded_selection(flagged, pad_multiple, cap if cap is not None else b)
    if result is not None:
        result = tree_map(_copy, result)
    step = chunk if chunk else sel.size
    wins, adopted = [], set()
    for c0 in range(0, sel.size, step):
        csel = sel[c0:c0 + step]
        res2, *scores = resolve(csel)
        fit_std, tf_new, tf_old = (x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in scores)
        for j, gi in enumerate(csel):
            if gi in adopted or not tf_new[j] < margin * tf_old[j]:
                continue
            adopted.add(int(gi))
            fitness[gi] = fit_std[j]
            wins.append((int(gi), res2, j))
            if result is not None:
                tree_map(lambda full, new, _gi=gi, _j=j: _set_row(full, new, _gi, _j), result, res2)
    return result, fitness, wins, int(flagged.size)


def polish_rerun(
    resolve: Callable[[np.ndarray], Tuple[object, np.ndarray]],
    hit_cap: np.ndarray,
    fitness: np.ndarray,
    pad_multiple: int,
    result=None,
    cap: Optional[int] = None,
    chunk: Optional[int] = None,
):
    """The finisher's rerun: rows whose final converge ran out of its
    iteration cap (RegistrationResult.refine_hit_cap) are re-launched through
    `resolve` (models/kss_icp.polish_resampled) and merged keep-better by
    fitness. escalate_rerun's mechanics, selected by the hit-cap flag."""
    return escalate_rerun(resolve, fitness, None, pad_multiple, result=result, cap=cap, chunk=chunk,
                          flags=np.asarray(hit_cap))
