"""Precision mode (KSSICPConfig.neighborhood_fracs, the CLI's --precise) in
the port against the JAX package on the CPU: the winner-neighborhood
restarts of kss_icp_torch/models/kss_icp.py::neighborhood_polish on the
three return paths of register_batch (full, two-phase, two-tier), through
register_many, and inside an escalated re-solve, at tiny configs shaped like
__graft_entry__._tiny_config, on the narrow-basin surface of
tests/test_neighborhood_polish.py at three seeds. The transform within 1e-4,
the fitness at rtol 1e-5 and refine_hit_cap equal (JAX keeps the capped base
solve's flag)."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import kss_icp_torch as kt
from kss_icp_torch.config import from_reference
from kss_icp_torch.models import kss_icp as tk
from kss_icp_tpu.config import KSSICPConfig
from kss_icp_tpu.models import kss_icp as jk
from kss_icp_tpu.stress import rot_xyz

torch.set_num_threads(1)

FRACS = (0.25, 0.5)  # the CLI's --precise
TINY = KSSICPConfig(rotation_steps=4, max_candidates=4, max_resample_points=128, resample_pad=128,
                    max_icp_iterations=40, rotation_chunk=16, auto_escalate=False, neighborhood_fracs=FRACS)
CONFIGS = {
    "two_phase": dataclasses.replace(TINY, screen_points=64, refine_candidates=2),
    "full": dataclasses.replace(TINY, multistart_mode="full"),
    # bench.bench_config's shape: two-tier refine on prefixes, a capped final converge.
    "two_tier": dataclasses.replace(TINY, coarse_points=64, coarse_target_points=64, refine_candidates=2,
                                    refine_tier_iterations=3, refine_tier_target_points=64,
                                    refine_max_iterations=4),
}
SEEDS = (3, 5, 11)


def _pair(n=600, seed=3):
    """tests/test_neighborhood_polish.py::_pair: a wavy sheet and its rigid copy."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-1, 1, n)
    v = rng.uniform(-1, 1, n)
    z = 0.35 * np.sin(2.2 * u) * np.cos(1.7 * v)
    tgt = np.stack([u, v, z], -1).astype(np.float32)
    src = (tgt @ rot_xyz(0.8, 0.4, 1.2).T + np.array([0.2, -0.1, 0.3])).astype(np.float32)
    return src, tgt


def _assert_matches(tr, jr):
    for f in ("scale", "rotation", "translation"):
        np.testing.assert_allclose(getattr(tr.transform, f).numpy(), np.asarray(getattr(jr.transform, f)), atol=1e-4)
    np.testing.assert_allclose(float(tr.fitness), float(jr.fitness), rtol=1e-5)
    assert bool(tr.refine_hit_cap) == bool(jr.refine_hit_cap)
    assert int(tr.chosen_candidate) == int(jr.chosen_candidate)


@pytest.mark.parametrize("mode", sorted(CONFIGS))
@pytest.mark.parametrize("seed", SEEDS)
def test_register_pair_precise_matches_jax(seed, mode):
    src, tgt = _pair(seed=seed)
    cfg = CONFIGS[mode]
    _assert_matches(tk.register_pair(src, tgt, from_reference(cfg), device="cpu"), jk.register_pair(src, tgt, cfg))


@pytest.mark.parametrize("mode", sorted(CONFIGS))
def test_polish_is_never_worse_and_off_changes_nothing(mode):
    """fracs=() runs no polish stage and gives the knob-less run's bits; the
    polish never raises a pair's fitness, and on these pairs it lowers it."""
    cfg = from_reference(CONFIGS[mode])
    off = dataclasses.replace(cfg, neighborhood_fracs=())
    for seed in SEEDS:
        src, tgt = _pair(seed=seed)
        stages = []
        base = tk.register_pair(src, tgt, off, device="cpu",
                                timer=lambda s: stages.append(s) or contextlib.nullcontext())
        assert "polish" not in stages
        again = tk.register_pair(src, tgt, dataclasses.replace(off, neighborhood_fracs=()), device="cpu")
        assert torch.equal(again.transform.rotation, base.transform.rotation)
        assert torch.equal(again.fitness, base.fitness)
        stages.clear()
        prec = tk.register_pair(src, tgt, cfg, device="cpu",
                                timer=lambda s: stages.append(s) or contextlib.nullcontext())
        assert stages.count("polish") == 1
        assert float(prec.fitness) < float(base.fitness)
        # JAX's rule: the flag is the capped base solve's, whatever the polish did.
        assert bool(prec.refine_hit_cap) == bool(base.refine_hit_cap)
        assert int(prec.chosen_candidate) == int(base.chosen_candidate)


def test_neighborhood_polish_lanes_and_offsets(monkeypatch):
    """One lockstep ICP of 12 lanes a pair at the uncapped params, lane_ref =
    the pair, the offsets in JAX's order; a lane is kept only when strictly
    better."""
    calls = []
    icp = tk.icp

    def recorded(source, smask, tgt, tmask, params, *a, **kw):
        calls.append((source.shape, params.max_iterations, kw.get("lane_ref")))
        return icp(source, smask, tgt, tmask, params, *a, **kw)

    monkeypatch.setattr(tk, "icp", recorded)
    rng = np.random.default_rng(0)
    pts = torch.as_tensor(rng.uniform(-1, 1, (2, 64, 3)).astype(np.float32))
    mask = torch.ones((2, 64), dtype=torch.bool)
    cfg = from_reference(dataclasses.replace(TINY, max_icp_iterations=7))
    eye = kt.Similarity(torch.ones(2), torch.eye(3).expand(2, 3, 3), torch.zeros(2, 3))
    params = tk.ICPParams.from_config(cfg)
    # An incumbent fitness of 0 can never be beaten: the transform stays.
    total, fit = tk.neighborhood_polish(eye, torch.zeros(2), pts, mask, pts.flip(1), mask, params, cfg)
    assert torch.equal(total.rotation, eye.rotation) and torch.equal(fit, torch.zeros(2))
    (shape, cap, lane_ref), = calls
    assert shape == (24, 64, 3) and cap == 7
    assert lane_ref.tolist() == [0] * 12 + [1] * 12
    # The offsets: fracs outermost, then the axis, then the sign (-1 first).
    step = cfg.angle_span / cfg.rotation_steps
    offs = torch.tensor([[s * f * step if a == ax else 0.0 for a in range(3)]
                         for f in FRACS for ax in range(3) for s in (-1.0, 1.0)], dtype=torch.float32)
    first = tk.euler_xyz_matrix(offs)[0]
    cur = tk.apply_similarity(kt.Similarity(torch.ones(()), first, torch.zeros(3)), pts[0])
    calls.clear()
    monkeypatch.setattr(tk, "icp", lambda source, *a, **kw: calls.append(source) or icp(source, *a, **kw))
    tk.neighborhood_polish(eye, torch.full((2,), 1e30), pts, mask, pts.flip(1), mask, params, cfg)
    assert torch.equal(calls[0][0], cur)


def test_register_many_rows_equal_register_pair():
    cfg = from_reference(CONFIGS["two_phase"])
    pairs = [_pair(seed=s) for s in SEEDS]
    res, metrics = kt.register_many(pairs, cfg, full_pad=640, device="cpu")
    for b, (src, tgt) in enumerate(pairs):
        one = tk.register_pair(src, tgt, cfg, device="cpu")
        for f in ("scale", "rotation", "translation"):
            np.testing.assert_allclose(getattr(res.transform, f)[b].numpy(), getattr(one.transform, f).numpy(),
                                       rtol=0, atol=1e-6)
        np.testing.assert_allclose(float(res.fitness[b]), float(one.fitness), rtol=1e-6)
        assert int(res.chosen_candidate[b]) == int(one.chosen_candidate)
        assert np.isfinite(metrics["rmse"][b])


def test_escalated_pair_polishes_like_jax():
    """escalation_config() keeps neighborhood_fracs, so the 16^3 re-solve
    (here 6^3) polishes too; the pair is flagged by a threshold of 1e-9."""
    cfg = dataclasses.replace(CONFIGS["two_phase"], auto_escalate=True, escalate_threshold=1e-9,
                              overlap_escalate=False, escalate_rotation_steps=6, escalate_max_candidates=6,
                              escalate_coarse_points=64, escalate_coarse_target_points=64)
    src, tgt = _pair(seed=5)
    # Jittered, so that the best pose leaves a fitness well above rounding.
    src = src + np.random.default_rng(5).normal(0, 0.01, src.shape).astype(np.float32)
    stages = []
    tr = tk.register_pair(src, tgt, from_reference(cfg), device="cpu",
                          timer=lambda s: stages.append(s) or contextlib.nullcontext())
    assert "escalate" in stages
    _assert_matches(tr, jk.register_pair(src, tgt, cfg))


def test_overlap_mode_polishes_like_jax():
    """overlap_config() keeps neighborhood_fracs too, so JAX's overlap solve
    (register_resampled at the overlap config) polishes its every solve, with
    the trimmed similarity ICP; the port's register_batch does the same."""
    cfg = dataclasses.replace(CONFIGS["two_phase"], overlap_mode=True, overlap_iterations=2)
    src, tgt = _pair(seed=3)
    tr = tk.register_pair(src, tgt, from_reference(cfg), device="cpu")
    jr = jk.register_pair(src, tgt, cfg)
    for f in ("scale", "rotation", "translation"):
        np.testing.assert_allclose(getattr(tr.transform, f).numpy(), np.asarray(getattr(jr.transform, f)), atol=1e-4)
    np.testing.assert_allclose(float(tr.fitness), float(jr.fitness), rtol=1e-5)
