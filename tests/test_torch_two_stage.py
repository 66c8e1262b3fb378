"""The two-stage converge (KSSICPConfig.refine_polish_iterations) of the port
against the JAX package on the CPU: a final converge capped at
refine_max_iterations, continued by a warm-started polish on the pairs that hit
the cap (models/kss_icp.py::continue_capped), through register_many
(kss_icp_tpu/parallel/batch.py:183-200, the cap no longer folded into the
escalation flags, :238-239) and register_pair (kss_icp_tpu/models/kss_icp.py:
895-904, refine_hit_cap cleared). The inputs are tests/test_escalate.py's
test_two_stage_converge_matches_single_stage pair."""

import contextlib
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import kss_icp_torch as kt
import kss_icp_torch.escalate as te
import kss_icp_tpu.escalate as je
from kss_icp_torch.config import DEFAULT_CONFIG, from_reference
from kss_icp_torch.ladder_log import LadderLog
from kss_icp_torch.models import kss_icp as tk
from kss_icp_tpu.config import KSSICPConfig
from kss_icp_tpu.models import kss_icp as jk
from kss_icp_tpu.parallel.batch import register_many as jax_register_many
from kss_icp_tpu.stress import rot_xyz

torch.set_num_threads(1)

# tests/test_escalate.py:83-90: the single-stage config and its two-stage twin.
SINGLE = KSSICPConfig(max_candidates=6, coarse_points=256, refine_candidates=2, max_resample_points=400,
                      resample_pad=512, screen_points=256, refine_tier_iterations=6, refine_max_iterations=40)
TWO_STAGE = dataclasses.replace(SINGLE, refine_max_iterations=4, refine_polish_iterations=40)
FULL_PAD = 1024
FIXTURES = Path(__file__).resolve().parents[1] / "fixtures"


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(3)
    base = rng.uniform(-1, 1, (800, 3)).astype(np.float32)
    base[:, 2] = 0.3 * np.sin(3 * base[:, 0]) * np.cos(2 * base[:, 1])
    base += 0.15 * np.sin(2 * base[:, [1, 2, 0]])  # break planarity
    return ((base @ rot_xyz(0.9, 0.4, 1.3).T) * 1.3 + 0.2).astype(np.float32), base


def _same_result(got, want, atol=1e-4):
    """Transform within atol, fitness within 1e-7 absolute: the pair is an
    exact copy, so both fitnesses sit at their float32 floors, JAX's
    expansion-form NN at ~1e-8 and the port's exact differences at ~1e-12."""
    np.testing.assert_allclose(np.asarray(got.fitness, np.float64), np.asarray(want.fitness, np.float64), atol=1e-7)
    for f in ("scale", "rotation", "translation"):
        np.testing.assert_allclose(getattr(got.transform, f).numpy(), np.asarray(getattr(want.transform, f)),
                                   atol=atol)


@pytest.mark.parametrize("escalate", [False, True])
def test_register_many_two_stage_matches_jax(pair, escalate):
    """The capped lane is continued in both packages and kept; with escalation
    the cap no longer flags it for the 16^3 re-solve, and, its refine_hit_cap
    kept, the uncapped finisher runs on it (JAX's order)."""
    with LadderLog(je, 1) as jl:
        jres, jm = jax_register_many([pair], TWO_STAGE, full_pad=FULL_PAD, escalate=escalate)
    stages = []
    with LadderLog(te, 1) as tl:
        tres, tm = kt.register_many([pair], from_reference(TWO_STAGE), full_pad=FULL_PAD, escalate=escalate,
                                    device="cpu", timer=lambda s: stages.append(s) or contextlib.nullcontext())
    assert jl.continued.tolist() == tl.continued.tolist() == [True]
    for key in ("escalated", "won", "finisher"):
        assert getattr(tl, key).tolist() == getattr(jl, key).tolist(), key
    assert tl.finisher.tolist() == [escalate] and not tl.escalated.any()
    assert stages.count("two_stage") == 1 and stages.index("two_stage") == stages.index("refine") + 1
    assert bool(tres.refine_hit_cap[0]) == bool(jres.refine_hit_cap[0]) == (not escalate)
    _same_result(tres, jres)


def test_two_stage_reaches_the_single_stage_answer(pair):
    """tests/test_escalate.py::test_two_stage_converge_matches_single_stage in
    the port: cap 4 + polish 40 lands where one uncapped converge of 40 does
    (correspondences depend only on the current positions)."""
    _, m1 = kt.register_many([pair], from_reference(SINGLE), full_pad=FULL_PAD, escalate=False, device="cpu")
    _, m2 = kt.register_many([pair], from_reference(TWO_STAGE), full_pad=FULL_PAD, escalate=False, device="cpu")
    assert abs(float(m1["rmse"][0]) - float(m2["rmse"][0])) < 2e-3, (m1["rmse"], m2["rmse"])


@pytest.mark.parametrize("auto_escalate", [False, True])
def test_register_pair_two_stage_matches_jax(pair, monkeypatch, auto_escalate):
    """register_pair continues the capped pair with one polish_resampled at
    the base config, keeps the lower fitness and clears refine_hit_cap, in
    both packages; with escalation on, neither flags it (fitness under the
    threshold, the cap cleared), so no re-solve and no finisher runs."""
    cfg = dataclasses.replace(TWO_STAGE, auto_escalate=auto_escalate)
    calls = {"jax": [], "torch": []}
    for tag, mod in (("jax", jk), ("torch", tk)):
        orig = mod.polish_resampled
        monkeypatch.setattr(mod, "polish_resampled",
                            lambda *a, _o=orig, _t=tag, **kw: calls[_t].append(a[-1].refine_polish_iterations)
                            or _o(*a, **kw))
    want = jk.register_pair(*pair, cfg)
    stages = []
    got = tk.register_pair(*pair, from_reference(cfg), device="cpu",
                           timer=lambda s: stages.append(s) or contextlib.nullcontext())
    assert calls["torch"] == calls["jax"] == [40]
    assert "two_stage" in stages and "escalate" not in stages and "finish" not in stages
    assert not bool(got.refine_hit_cap) and not bool(want.refine_hit_cap)
    # The pair is an exact copy: several lanes reach its pose at their
    # fitness floors, so the chosen index is a near-tie (ROADMAP.md queue 3)
    # and the pose is compared.
    _same_result(got, want)


def test_uncapped_pair_is_not_continued(pair):
    """A converge that ends under its cap is left alone: no two_stage stage,
    the single-stage answer."""
    cfg = dataclasses.replace(SINGLE, refine_polish_iterations=40)
    stages = []
    res = tk.register_pair(*pair, from_reference(cfg), device="cpu",
                           timer=lambda s: stages.append(s) or contextlib.nullcontext())
    base = tk.register_pair(*pair, from_reference(SINGLE), device="cpu")
    assert "two_stage" not in stages and not bool(res.refine_hit_cap)
    assert float(res.fitness) == float(base.fitness)


RECORD = json.loads((FIXTURES / "torch_port_expected_two_stage.json").read_text())
RECORD_CFG = dataclasses.replace(DEFAULT_CONFIG, **RECORD["knobs"])


def _remesh(name):
    with np.load(FIXTURES / "remesh_transfer.npz") as z:
        return z[name + "_src"], z[name + "_tgt"]


def _record_case(exp):
    """register_pair at the record's config on one remesh pair: the RMSE
    within JAX's + 0.006, and continued and escalated as JAX."""
    calls = []
    orig = tk.polish_resampled

    def polish(*a, **kw):
        calls.append(a[-1].refine_polish_iterations)
        return orig(*a, **kw)

    src, tgt = _remesh(exp["name"])
    with pytest.MonkeyPatch.context() as mp, LadderLog(te, 1) as ladder:
        mp.setattr(tk, "polish_resampled", polish)
        res = tk.register_pair(src, tgt, RECORD_CFG, device="cpu")
    rmse = kt.registration_measure(kt.apply_similarity(res.transform, torch.as_tensor(src)), tgt,
                                   device="cpu")["rmse"]
    assert np.isfinite(rmse) and rmse <= exp["rmse"] + RECORD["rmse_band"], (rmse, exp["rmse"])
    assert (RECORD_CFG.refine_polish_iterations in calls) == exp["continued"]
    assert bool(ladder.escalated[0]) == exp["escalated"]


@pytest.mark.slow
@pytest.mark.parametrize("index", range(len(RECORD["pairs"])))
def test_remesh_pair_two_stage_matches_the_record(index):
    """Every remesh pair at the record's config (giraffew is the one JAX
    continues): about a minute a pair on one CPU thread, so slow.
    chip_smoke.py phase 4k holds the card to the same record."""
    _record_case(RECORD["pairs"][index])
