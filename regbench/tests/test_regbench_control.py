"""`correct` against its control and the faults a cell can have, at a small
size on the CPU: the sound program passes; the reference in TF32 in the
program's place fails; so does the program with its ICP returning its
starting pose, half of each batch left out and answered by the mean of the
rest, its metric's mean over half of the points, or its metric altered where
it is made. (The harness's look for a card is skipped: the
runs take the CPU device.) regbench/control.py reads the same on the card at
the cells' own sizes."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from regbench import control  # noqa: E402
from regbench.tests.small import small_spec  # noqa: E402

CELL = "objects.full-overlap.b64"
SEED = 2 ** 31 + 77


def _reading(what):
    return control.reading(CELL, SEED, 0.1, what, device="cpu", spec=small_spec(CELL))


def test_sound_run_is_correct():
    r = _reading("sound")
    assert r["correct"], r["compared"]
    assert r["compared"]["metric_gap"]["value"] < 1e-5


@pytest.mark.parametrize("what,number", [("control", "metric_gap"), ("state_unchanged", "pose_median"),
                                         ("half_batch", "over_bar"), ("half_mean", "metric_gap"),
                                         ("answer_altered", "metric_gap")])
def test_broken_run_is_not_correct(what, number):
    r = _reading(what)
    assert not r["correct"]
    assert r["compared"][number]["value"] > r["compared"][number]["limit"], r["compared"]


def test_control_places_the_pairs_where_the_truth_does():
    r = _reading("control")
    assert r["compared"]["pose_median"]["value"] < 1e-5
    assert r["failed"] == 0
    assert r["over_bar_pairs"] == 0


def test_one_lane_fault_moves_the_first_pair_of_each_call_only():
    sound, broken = _reading("sound"), _reading("one_lane")
    assert broken["over_bar_pairs"] > sound["over_bar_pairs"]
    assert broken["failed"] == sound["failed"] == 0
    assert broken["compared"]["metric_gap"]["value"] < 1e-5, broken["compared"]
