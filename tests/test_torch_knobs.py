"""register_many with each register_pair knob of the port's last slice
(resampler="aivs", icp_variant="point_to_plane", coarse_error_metric "max"
and "diff") against the JAX package's register_many on the same pairs at a
tiny config: the same pairs escalated, the same pose within 1e-4 and the RMSE
within JAX's + 1e-4 (the register_pair cases are
tests/test_torch_import.py::test_unported_knobs_raise). The pairs are
rotated copies of wavy surfaces (tests/test_register_many.py:19-27) and noisy
targets, whose candidate lanes reach one pose, so the chosen index is not
compared."""

import dataclasses

import numpy as np
import pytest
import torch

import kss_icp_torch.escalate as te
import kss_icp_tpu.escalate as je
from helpers import random_cloud
from kss_icp_torch.config import from_reference
from kss_icp_torch.ladder_log import LadderLog
from kss_icp_torch.parallel import batch as tb
from kss_icp_tpu.config import KSSICPConfig
from kss_icp_tpu.parallel import batch as jb

torch.set_num_threads(1)

# tests/test_register_many.py:13-16, escalating every pair above 1e-6.
MANY = KSSICPConfig(rotation_steps=8, max_candidates=8, max_resample_points=256, resample_pad=256,
                    max_icp_iterations=100, rotation_chunk=64, screen_points=128, escalate_threshold=1e-6,
                    escalate_rotation_steps=9, escalate_max_candidates=9, overlap_escalate=False)
KNOBS = {"aivs": dict(resampler="aivs"), "point_to_plane": dict(icp_variant="point_to_plane"),
         "max": dict(coarse_error_metric="max"), "diff": dict(coarse_error_metric="diff")}


def _pairs(rng, n_pairs=3):
    pairs = []
    for i in range(n_pairs):
        tgt = random_cloud(rng, 400 + 50 * i)
        ang = 0.3 + 0.2 * i
        c, s = np.cos(ang), np.sin(ang)
        r = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        noisy = tgt + rng.normal(0, 0.005, size=tgt.shape)  # a fitness above the threshold: every pair escalates
        pairs.append(((tgt @ r.T).astype(np.float32), noisy.astype(np.float32)))
    return pairs


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_register_many_with_knob_matches_jax(knob):
    cfg = dataclasses.replace(MANY, **KNOBS[knob])
    pairs = _pairs(np.random.default_rng(7))
    with LadderLog(je, len(pairs)) as jl:
        jr, jm = jb.register_many(pairs, cfg, full_pad=512)
    with LadderLog(te, len(pairs)) as tl:
        tr, tm = tb.register_many(pairs, from_reference(cfg), full_pad=512, device="cpu")
    # Which of the base and the re-solve is kept is not compared: both reach
    # one pose, their fitnesses ulps apart (the keep-better knife edge,
    # ROADMAP.md queue 3).
    for f in ("escalated", "finisher"):
        assert getattr(tl, f).tolist() == getattr(jl, f).tolist(), f
    assert jl.escalated.all()  # the escalation's 9^3 grid ran with the knob too
    for f in ("scale", "rotation", "translation"):
        np.testing.assert_allclose(getattr(tr.transform, f).numpy(), np.asarray(getattr(jr.transform, f)), atol=1e-4)
    assert (tm["rmse"] <= np.asarray(jm["rmse"]) + 1e-4).all(), (tm["rmse"], jm["rmse"])
