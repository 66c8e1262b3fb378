"""The port's slice end to end — register_pair -> apply_similarity ->
registration_measure (kss_icp_torch) — against the JAX package on the CPU,
at small configs shaped like __graft_entry__._tiny_config with escalation
off: the same chosen candidate, and RMSE within JAX + 0.006 (the multi-start
band of tests/test_parity_vs_oracle.py:28-30)."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import kss_icp_torch as kt
from kss_icp_torch.config import from_reference
from kss_icp_torch.ops.coarse_cuda import field_ave
from kss_icp_torch.ops.nn_cuda import nn1
from kss_icp_torch.ops.resample_cuda import fps
from kss_icp_tpu.config import KSSICPConfig
from kss_icp_tpu.core.transforms import apply_similarity
from kss_icp_tpu.metrics import registration_measure
from kss_icp_tpu.models.kss_icp import register_pair

torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parents[1] / "fixtures"
RMSE_BAND = 0.006

TINY = KSSICPConfig(rotation_steps=4, max_candidates=4, max_resample_points=128, resample_pad=128,
                    max_icp_iterations=8, rotation_chunk=16, auto_escalate=False)
CONFIGS = {
    "two_phase": dataclasses.replace(TINY, screen_points=64, refine_candidates=2),
    "full": dataclasses.replace(TINY, multistart_mode="full"),
    # bench.bench_config's shape: two-tier refine on prefixes, capped final converge.
    "two_tier": dataclasses.replace(TINY, max_candidates=4, coarse_points=64, coarse_target_points=64,
                                    refine_candidates=2, refine_tier_iterations=3,
                                    refine_tier_target_points=64, refine_max_iterations=4,
                                    max_icp_iterations=20),
}


def _remesh(name):
    with np.load(FIXTURES / "remesh_transfer.npz") as z:
        return np.asarray(z[name + "_src"], np.float32), np.asarray(z[name + "_tgt"], np.float32)


def _pairs():
    names = [r["name"] for r in json.loads((FIXTURES / "remesh_transfer.json").read_text())]
    return {n: _remesh(n) for n in (names[0], names[7], names[18])}


PAIRS = _pairs()


def _both(name, cfg):
    src, tgt = PAIRS[name]
    jr = register_pair(src, tgt, cfg)
    j_rmse = registration_measure(np.asarray(apply_similarity(jr.transform, src)), tgt)["rmse"]
    tr = kt.register_pair(src, tgt, from_reference(cfg), device="cpu")
    aligned = kt.apply_similarity(tr.transform, torch.as_tensor(src))
    t_rmse = kt.registration_measure(aligned, tgt, device="cpu")["rmse"]
    return jr, j_rmse, tr, t_rmse, aligned


@pytest.mark.parametrize("mode", sorted(CONFIGS))
@pytest.mark.parametrize("name", sorted(PAIRS))
def test_register_pair_matches_jax(name, mode):
    jr, j_rmse, tr, t_rmse, aligned = _both(name, CONFIGS[mode])
    assert aligned.shape == PAIRS[name][0].shape and bool(torch.isfinite(aligned).all())
    assert int(tr.chosen_candidate) == int(jr.chosen_candidate)
    assert bool(tr.used_multistart) == bool(jr.used_multistart)
    assert t_rmse <= j_rmse + RMSE_BAND, (t_rmse, j_rmse)
    np.testing.assert_allclose(float(tr.fitness), float(jr.fitness), rtol=1e-3)


def test_two_tier_reports_the_hit_cap_like_jax():
    cfg = CONFIGS["two_tier"]
    flags = []
    for name in sorted(PAIRS):
        jr, _, tr, _, _ = _both(name, cfg)
        assert bool(tr.refine_hit_cap) == bool(jr.refine_hit_cap)
        flags.append(bool(jr.refine_hit_cap))
    assert any(flags), "the capped final converge should cut at least one pair short"


def test_cpu_run_launches_no_kernel():
    before = (nn1.launches, fps.launches, field_ave.launches)
    src, tgt = PAIRS[sorted(PAIRS)[0]]
    kt.register_pair(src, tgt, from_reference(CONFIGS["two_phase"]), device="cpu")
    assert (nn1.launches, fps.launches, field_ave.launches) == before
