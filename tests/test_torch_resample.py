"""The port's farthest-point sampling (kss_icp_torch/ops/resample.py,
ops/resample_cuda.py) against the JAX FPS: the Pallas kernel in interpret
mode and the XLA loop, index for index, and resample_batch against JAX's.
The FPS kernel itself is tested on the card in tests/test_torch_card.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import random_cloud
from kss_icp_torch.config import from_reference
from kss_icp_torch.models import kss_icp as tk
from kss_icp_torch.ops.resample import farthest_point_sampling as t_fps
from kss_icp_torch.ops.resample_cuda import fps
from kss_icp_tpu.config import KSSICPConfig
from kss_icp_tpu.models import kss_icp as jk
from kss_icp_tpu.ops.resample import farthest_point_sampling
from kss_icp_tpu.ops.resample_pallas import fps_batch_pallas

torch.set_num_threads(1)


def _clouds(rng, b, p, short=None):
    pts = np.stack([random_cloud(rng, p) for _ in range(b)]).astype(np.float32)
    mask = np.ones((b, p), bool)
    for row, n in (short or {}).items():
        mask[row, n:] = False
    return pts, mask


def _xla_batch(points, mask, s):
    f = jax.vmap(lambda p, m: farthest_point_sampling(p, m, s))
    return f(jnp.asarray(points), jnp.asarray(mask))


@pytest.mark.parametrize("b, p, s, short", [
    (3, 400, 150, {1: 320}),   # tests/test_resample_pallas.py:18-28
    (2, 64, 100, {0: 40}),     # fewer valid points than samples (:31-46)
    (1, 512, 32, None),
])
def test_plain_matches_pallas_kernel(rng, b, p, s, short):
    pts, mask = _clouds(rng, b, p, short)
    idx_j, sm_j = fps_batch_pallas(jnp.asarray(pts), jnp.asarray(mask), s, interpret=True)
    idx, sm = fps(torch.as_tensor(pts), torch.as_tensor(mask), s)
    np.testing.assert_array_equal(sm.numpy(), np.asarray(sm_j))
    # Picks past the valid count repeat index 0 in both; compare every row whole.
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))


def test_plain_matches_xla_loop(rng):
    pts, mask = _clouds(rng, 3, 400, {2: 257})
    idx_j, sm_j = _xla_batch(pts, mask, 150)
    idx, sm = t_fps(torch.as_tensor(pts), torch.as_tensor(mask), 150)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(sm.numpy(), np.asarray(sm_j))


def test_all_invalid_cloud_picks_index_zero(rng):
    pts, mask = _clouds(rng, 1, 64, {0: 0})
    idx_j, sm_j = _xla_batch(pts, mask, 8)
    idx, sm = fps(torch.as_tensor(pts), torch.as_tensor(mask), 8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    assert not sm.any()


_CFG = KSSICPConfig(max_resample_points=96, resample_pad=128, auto_escalate=False)


def test_resample_batch_matches_jax(rng):
    pts, mask = _clouds(rng, 2, 256, {1: 190})
    pn = np.array([96, 80])
    rp_j, rm_j = jk.resample_batch(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(pn), _CFG)
    rp, rm = tk.resample_batch(torch.as_tensor(pts), torch.as_tensor(mask), torch.as_tensor(pn),
                               from_reference(_CFG))
    np.testing.assert_array_equal(rm.numpy(), np.asarray(rm_j))
    np.testing.assert_array_equal(rp.numpy(), np.asarray(rp_j))


@pytest.mark.parametrize("steps", [0, 1, 37, 150])
def test_plain_steps_are_the_full_runs_prefix(rng, steps):
    pts, mask = _clouds(rng, 3, 400, {1: 120, 2: 0})
    full, sm_full = t_fps(torch.as_tensor(pts), torch.as_tensor(mask), 150)
    idx, sm = fps(torch.as_tensor(pts), torch.as_tensor(mask), 150, steps)
    assert torch.equal(idx[:, :steps], full[:, :steps])
    assert not idx[:, steps:].any()
    assert torch.equal(sm, sm_full & (torch.arange(150) < steps))


@pytest.mark.parametrize("steps", [-1, 151])
def test_fps_refuses_steps_outside_the_samples(rng, steps):
    pts, mask = _clouds(rng, 1, 64)
    with pytest.raises(ValueError, match="steps"):
        fps(torch.as_tensor(pts), torch.as_tensor(mask), 150, steps)


@pytest.mark.parametrize("steps", [96, 97, 128, 500])
def test_resample_batch_steps_cut_is_bit_identical(rng, steps):
    """Stopping FPS after max(pnumber) picks changes no bit of the output: the
    slots past pnumber are masked and zeroed (steps past the pad clamp to it)."""
    pts, mask = _clouds(rng, 2, 256, {1: 190})
    pn = np.array([96, 80])
    args = (torch.as_tensor(pts), torch.as_tensor(mask), torch.as_tensor(pn), from_reference(_CFG))
    rp, rm = tk.resample_batch(*args)
    rp_s, rm_s = tk.resample_batch(*args, steps=steps)
    rp_j, rm_j = jk.resample_batch(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(pn), _CFG)
    for got, want in ((rp_s, rp), (rm_s, rm)):
        assert torch.equal(got, want)
    np.testing.assert_array_equal(rm_s.numpy(), np.asarray(rm_j))
    np.testing.assert_array_equal(rp_s.numpy(), np.asarray(rp_j))


def test_register_pair_stops_fps_after_pnumber_picks(monkeypatch):
    calls, inner = [], tk.fps
    monkeypatch.setattr(tk, "fps", lambda *a: calls.append(a[2:]) or inner(*a))
    rng = np.random.default_rng(4)
    src, tgt = random_cloud(rng, 150).astype(np.float32), random_cloud(rng, 300).astype(np.float32)
    cfg = dataclasses.replace(from_reference(_CFG), rotation_steps=2, max_candidates=2, max_icp_iterations=2)
    tk.register_pair(src, tgt, cfg, device="cpu")
    assert calls == [(128, 75), (128, 75)]  # pnumber = min(150, 300) // 2


def test_resample_pairs_matches_jax(rng):
    src, smask = _clouds(rng, 2, 256, {0: 200})
    tgt, tmask = _clouds(rng, 2, 256, {1: 222})
    pn = np.array([90, 64])
    (sp_j, sm_j), (tp_j, tm_j) = jk.resample_pairs(
        jnp.asarray(src), jnp.asarray(smask), jnp.asarray(tgt), jnp.asarray(tmask), jnp.asarray(pn), _CFG)
    (sp, sm), (tp, tm) = tk.resample_pairs(
        torch.as_tensor(src), torch.as_tensor(smask), torch.as_tensor(tgt), torch.as_tensor(tmask),
        torch.as_tensor(pn), from_reference(_CFG))
    for got, want in ((sp, sp_j), (sm, sm_j), (tp, tp_j), (tm, tm_j)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_aivs_resampler_is_not_ported(rng):
    """Once refused, resampler="aivs" now gives JAX's resample_batch bit for
    bit: the AIVS picks packed in pick-round order, each cloud's pnumber
    prefix, the box ladder from the padded size (and from a resolved knob)."""
    pts, mask = _clouds(rng, 3, 320, {1: 250})
    pn = np.array([100, 64, 128])
    for boxes in (0, 5):
        cfg = dataclasses.replace(_CFG, resampler="aivs", aivs_boxes_per_axis=boxes)
        want = jk.resample_batch(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(pn), cfg)
        got = tk.resample_batch(torch.as_tensor(pts), torch.as_tensor(mask), torch.as_tensor(pn), from_reference(cfg))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
