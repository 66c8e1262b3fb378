"""The port's own spans (kss_icp_torch/utils/profiling.py::span) on the CPU,
at small sizes: under torch.profiler each entry opens "kss.<entry>" around
the call, "kss.<stage>" for every stage its `timer=` hook reports, "kss.icp"
for each ICP call, one "kss.icp.step" a lockstep iteration (as many as
`icp.lockstep_iterations` grows) and "kss.sync.<site>" around each blocking
read, the stop test's inside its step; with no profiler recording, no
record_function is entered; and a timer sees the stages it saw before the
spans, in the same order (the lists below)."""

import contextlib
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import kss_icp_torch as kt
import kss_icp_torch.models.icp  # noqa: F401  (the module, behind models/__init__'s `icp`)
from kss_icp_torch.config import KSSICPConfig
from kss_icp_torch.models import kss_icp as tk
from kss_icp_torch.ops.simplify import octree_simplify
from kss_icp_torch.parallel import batch as tb
from kss_icp_torch.utils import profiling

torch.set_num_threads(1)
ti = sys.modules["kss_icp_torch.models.icp"]

FIXTURES = Path(__file__).resolve().parents[1] / "fixtures"
SMALL = KSSICPConfig(rotation_steps=6, max_candidates=8, max_resample_points=256, resample_pad=256,
                     max_icp_iterations=30, rotation_chunk=16, screen_points=64, refine_candidates=2,
                     escalate_rotation_steps=5, escalate_max_candidates=5, escalate_coarse_points=64,
                     escalate_coarse_target_points=64, overlap_screen_steps=4, overlap_screen_iters=4,
                     overlap_iterations=2)
CONFIGS = {
    # Every pair flagged and every overlap rung entered.
    "ladder": dataclasses.replace(SMALL, escalate_threshold=0.0, overlap_threshold=0.0, overlap_gate_ratio=1e9),
    # The two-stage converge and the pose tie-break.
    "two_stage": dataclasses.replace(SMALL, refine_max_iterations=3, refine_polish_iterations=10,
                                     pose_tiebreak_margin=0.5),
    "overlap_mode": dataclasses.replace(SMALL, overlap_mode=True),
}
LADDER = ["escalate", "finish", "overlap8", "overlap16", "overlap_screen"]
# (entry, config) -> the stages the timer saw before the spans, in order.
CASES = {
    ("register_many", "ladder"): ["resample", "coarse", "screen", "refine"] + LADDER + ["metric"],
    ("register_many", "two_stage"): ["resample", "coarse", "screen", "refine", "two_stage", "escalate", "finish",
                                     "metric"],
    ("register_pair", "ladder"): ["resample", "coarse", "screen", "refine"] + LADDER,
    ("register_pair", "two_stage"): ["resample", "coarse", "screen", "refine", "two_stage", "escalate", "overlap8"],
    ("register_pair", "overlap_mode"): ["resample", "overlap"],
    ("register_resampled", "ladder"): ["coarse", "screen", "refine"],
}

# (entry, config) -> the sites whose blocking reads the call makes.
SYNC_SITES = {
    ("register_many", "ladder"): {"upload", "resample", "icp_stop", "kabsch_svd", "two_stage", "ladder", "result"},
    ("register_many", "two_stage"): {"upload", "resample", "icp_stop", "kabsch_svd", "tiebreak", "two_stage", "ladder",
                                     "result"},
    ("register_pair", "ladder"): {"resample", "icp_stop", "kabsch_svd", "ladder"},
    ("register_pair", "two_stage"): {"resample", "icp_stop", "kabsch_svd", "tiebreak", "two_stage", "ladder"},
    ("register_pair", "overlap_mode"): {"resample", "icp_stop", "kabsch_svd"},
    ("register_resampled", "ladder"): {"icp_stop", "kabsch_svd"},
}


def _pairs():
    with np.load(FIXTURES / "remesh_transfer.npz") as z:
        return [(np.asarray(z[n + "_src"], np.float32), np.asarray(z[n + "_tgt"], np.float32))
                for n in ("Angelg", "Buddhag")]


def _call(entry, cfg, timer):
    pairs = _pairs()
    if entry == "register_many":
        return tb.register_many(pairs, cfg, full_pad=2048, device="cpu", timer=timer)
    if entry == "register_pair":
        return kt.register_pair(*pairs[0], cfg, device="cpu", timer=timer)
    clouds = [tk.resample_for_registration(torch.as_tensor(c), torch.ones(len(c), dtype=torch.bool), 200, cfg)
              for c in pairs[1]]
    return tk.register_resampled(*clouds[0], *clouds[1], cfg, timer=timer)


def _recorder():
    seen = []

    def timer(name):
        seen.append(name)
        return contextlib.nullcontext()
    return seen, timer


def _raise(*args, **kwargs):
    raise AssertionError("record_function entered with no profiler recording")


@pytest.fixture(scope="module", params=list(CASES), ids=lambda c: f"{c[0]}-{c[1]}")
def case(request):
    """The case's call twice: under a CPU profiler, and with no profiler and
    record_function made to raise. Returns the trace's kss. ranges as
    (name, start, end), the lockstep iterations of the traced call, and the
    stages each call's timer saw."""
    entry, cfg_name = request.param
    cfg = CONFIGS[cfg_name]
    traced_stages, timer = _recorder()
    before = ti.icp.lockstep_iterations
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _call(entry, cfg, timer)
    iterations = ti.icp.lockstep_iterations - before
    spans = sorted((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name.startswith("kss."))
    plain_stages, timer = _recorder()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", _raise)
        mp.setattr(torch.autograd.profiler, "record_function", _raise)
        _call(entry, cfg, timer)
    return {"entry": entry, "config": cfg_name, "expected": CASES[request.param], "spans": spans,
            "iterations": iterations, "traced_stages": traced_stages, "plain_stages": plain_stages}


def _named(case, name):
    return [(a, z) for n, a, z in case["spans"] if n == name]


def test_entry_span_holds_every_other_span(case):
    (outer,) = _named(case, f"kss.{case['entry']}")
    inner = [(a, z) for n, a, z in case["spans"] if n != f"kss.{case['entry']}"]
    assert inner and all(outer[0] <= a and z <= outer[1] for a, z in inner)


def test_every_stage_the_hook_reports_is_a_span(case):
    names = {n for n, _, _ in case["spans"]}
    assert {f"kss.{s}" for s in case["traced_stages"]} <= names
    assert "kss.icp" in names


def test_step_spans_count_the_lockstep_iterations(case):
    assert case["iterations"] > 0
    assert len(_named(case, "kss.icp.step")) == case["iterations"]


def test_every_stop_read_lies_inside_one_step(case):
    steps, stops = _named(case, "kss.icp.step"), _named(case, "kss.sync.icp_stop")
    assert len(stops) == len(steps)
    for (a, z), (sa, sz) in zip(steps, stops):
        assert a <= sa and sz <= z


def test_steps_lie_inside_icp_calls(case):
    calls = _named(case, "kss.icp")
    assert all(any(a <= sa and sz <= z for a, z in calls) for sa, sz in _named(case, "kss.icp.step"))


def test_timer_sees_the_same_stages_in_the_same_order(case):
    assert case["traced_stages"] == case["expected"]
    assert case["plain_stages"] == case["expected"]


def test_blocking_reads_are_sync_spans(case):
    names = {n for n, _, _ in case["spans"]}
    assert {f"kss.sync.{s}" for s in SYNC_SITES[case["entry"], case["config"]]} <= names
    # A sync span holds no other span: it is the read alone.
    for n, a, z in case["spans"]:
        if n.startswith("kss.sync."):
            assert not [m for m, b, y in case["spans"] if m != n and a <= b and y <= z and (b, y) != (a, z)]


def test_octree_is_a_span():
    pts = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, (4000, 3)).astype(np.float32))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        octree_simplify(pts, torch.ones(len(pts), dtype=torch.bool), 500)
    assert {"kss.octree", "kss.sync.octree"} <= {e.name for e in prof.events()}


def test_span_without_a_profiler_is_the_timer_or_nothing(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    assert isinstance(profiling.span("coarse"), contextlib.nullcontext)
    seen, timer = _recorder()
    with profiling.span("coarse", timer):
        pass
    assert seen == ["coarse"]


def test_span_under_a_profiler_opens_its_range_and_the_timer():
    entered = []

    @contextlib.contextmanager
    def timer(name):
        entered.append(name)
        try:
            yield
        finally:
            entered.append("exit " + name)

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError, match="body"):
            with profiling.span("screen", timer):
                torch.ones(4).sum()
                raise ValueError("body")
        with profiling.span("screen"):
            torch.ones(4).sum()
    assert entered == ["screen", "exit screen"]
    assert [e.name for e in prof.events() if e.name.startswith("kss.")] == ["kss.screen", "kss.screen"]


def test_spanned_keeps_the_function_and_its_counter():
    assert ti.icp.__wrapped__.__name__ == "icp" and ti.icp.__name__ == "icp"
    assert isinstance(ti.icp.lockstep_iterations, int)
    assert tb.register_many.__wrapped__.__doc__ == tb.register_many.__doc__
