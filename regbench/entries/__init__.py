"""Entries of the program that a mix drives, one module each, found by the
mix's `"entry"`. A module gives `prepare(config, mix, device)`, which
returns the call `(pairs, timer) -> [Answer]`, and `metric_rows(config,
pair)`, the valid rows of the pair's full-resolution metric. `counters()`
reads the program's counters for every entry.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np


class Answer(NamedTuple):
    """What the entry returned for one pair, on the host: the similarity
    x -> scale * rotation @ x + translation from the source to the target,
    and the RMSE and MAE of the aligned source against the target, in the
    frame the entry measured them in."""

    scale: float
    rotation: np.ndarray
    translation: np.ndarray
    rmse: float
    mae: float


def stage(timer, name: str):
    """The timer's span `name`, or nothing without a timer."""
    return timer(name) if timer is not None else contextlib.nullcontext()


def counters():
    """The program's counters that the per-layer metrics read, by name."""
    import importlib

    icp = importlib.import_module("kss_icp_torch.models.icp").icp
    return {"icp.lockstep_iterations": lambda: icp.lockstep_iterations}
