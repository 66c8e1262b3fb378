"""The port's coarse search (kss_icp_torch/models/coarse.py, ops/coarse_cuda.py)
against JAX: the "ave" field of both methods against the Pallas field kernels
in interpret mode, the bf16 "default" dot against a numpy reference, and the
local-minima mask and candidate ranking against kss_icp_tpu/models/coarse.py
on identical fields, ties included. The field kernels themselves are tested
on the card in tests/test_torch_card.py."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from helpers import random_cloud
from kss_icp_torch.core.transforms import euler_xyz_matrix as t_euler
from kss_icp_torch.models import coarse as tc
from kss_icp_torch.ops.coarse_cuda import field_ave, field_dot
from kss_icp_tpu.core.transforms import euler_xyz_matrix
from kss_icp_tpu.models import coarse as jc
from kss_icp_tpu.ops.coarse_pallas import rotation_scores_pallas

torch.set_num_threads(1)


def _clouds(rng, p=130, t=100, steps=3, t_valid=None, s_valid=None, scatter=False):
    src = random_cloud(rng, p).astype(np.float32)
    tgt = random_cloud(rng, t).astype(np.float32)
    smask = np.ones((p,), bool)
    tmask = np.ones((t,), bool)
    if scatter:  # a random third of each cloud's rows masked
        smask = rng.uniform(size=p) < 2 / 3
        tmask = rng.uniform(size=t) < 2 / 3
    if t_valid is not None:
        tmask[t_valid:] = False
    if s_valid is not None:
        smask[s_valid:] = False
        src[s_valid:] = 1e6  # garbage in the masked tail must not count
    return src, smask, tgt, tmask, np.array(jc.rotation_grid(steps, 6.3, jnp.float32))


def _field_case(rng, method="vpu", precision="highest", **kw):
    src, smask, tgt, tmask, angles = _clouds(rng, **kw)
    want = rotation_scores_pallas(jnp.asarray(src), jnp.asarray(smask), jnp.asarray(tgt), jnp.asarray(tmask),
                                  euler_xyz_matrix(jnp.asarray(angles)), tile_q=128, interpret=True,
                                  method=method, precision=precision)
    args = tuple(torch.as_tensor(x) for x in (src, smask, tgt, tmask)) + (t_euler(torch.as_tensor(angles)),)
    got = field_ave(*args) if method == "vpu" else field_dot(*args, precision=precision)
    return got.numpy(), np.asarray(want)


# Fully valid; suffix masks (padded clouds, as register_pair pads both);
# scattered masks; a fully masked target (the kernels' biased path) and source.
FIELD_CASES = [{}, {"t_valid": 40}, {"p": 256, "t": 128, "steps": 2, "s_valid": 77},
               {"p": 300, "t": 280, "s_valid": 150, "t_valid": 120}, {"scatter": True}, {"t_valid": 0},
               {"s_valid": 0}]


@pytest.mark.parametrize("kw", FIELD_CASES)
def test_field_matches_pallas_vpu_kernel(rng, kw):
    got, want = _field_case(rng, **kw)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("kw", FIELD_CASES)
def test_field_dot_matches_pallas_dot_kernel(rng, kw, precision):
    got, want = _field_case(rng, method="dot", precision=precision, **kw)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


def _bf16_dot_field(src, smask, tgt, tmask, rots):
    """numpy reference of the "default" dot: rotated source and augmented
    target rounded to bfloat16, exact products, float32 sums in the kernel's
    order, |q|² from the unrotated float32 source."""
    f32 = np.float32
    rotated = (rots[:, None, :, 0] * src[None, :, 0, None] + rots[:, None, :, 1] * src[None, :, 1, None]) \
        + rots[:, None, :, 2] * src[None, :, 2, None]  # (C, P, 3), rotate_points' order
    t2 = np.where(tmask, (tgt[:, 0] * tgt[:, 0] + tgt[:, 1] * tgt[:, 1]) + tgt[:, 2] * tgt[:, 2], f32(1e30))
    ra = np.concatenate([(f32(-2.0) * tgt) * tmask[:, None].astype(f32), t2[:, None]], axis=1)
    q = rotated.astype(ml_dtypes.bfloat16).astype(f32)
    a = ra.astype(ml_dtypes.bfloat16).astype(f32)
    rel = ((q[:, :, None, 0] * a[:, 0] + q[:, :, None, 1] * a[:, 1]) + q[:, :, None, 2] * a[:, 2]) + a[:, 3]
    q2 = (src[:, 0] * src[:, 0] + src[:, 1] * src[:, 1]) + src[:, 2] * src[:, 2]
    d = np.sqrt(np.maximum(rel.min(axis=-1) + q2, f32(0)))
    return (d.astype(np.float64) * smask).sum(axis=-1) / max(smask.sum(), 1)


@pytest.mark.parametrize("kw", FIELD_CASES)
def test_field_dot_default_is_one_bf16_pass(rng, kw):
    src, smask, tgt, tmask, angles = _clouds(rng, **kw)
    rots = t_euler(torch.as_tensor(angles))
    args = tuple(torch.as_tensor(x) for x in (src, smask, tgt, tmask)) + (rots,)
    got = field_dot(*args, precision="default").numpy()
    want = _bf16_dot_field(src, smask, tgt, tmask, rots.numpy())
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
    exact = field_dot(*args, precision="highest").numpy()
    if smask.any():
        assert np.abs(got - exact).max() > 1e-5 * np.abs(exact).max()  # the rounding is really there
    else:
        assert not got.any() and not exact.any()  # a fully masked source scores 0 at any precision


def test_field_dot_refuses_unknown_precision_and_method():
    x, m = torch.zeros((4, 3)), torch.ones((4,), dtype=torch.bool)
    with pytest.raises(ValueError, match="precision"):
        field_dot(x, m, x, m, torch.eye(3)[None], precision="tf32")
    with pytest.raises(ValueError, match="method"):
        tc.score_rotation_field(x, m, x, m, steps=2, method="mxu")


def test_rotation_grid_and_matrices_match_jax():
    a_j = np.asarray(jc.rotation_grid(4, 6.3, jnp.float32))
    a_t = tc.rotation_grid(4, 6.3)
    np.testing.assert_allclose(a_t.numpy(), a_j, rtol=1e-7)
    np.testing.assert_allclose(t_euler(a_t).numpy(), np.asarray(euler_xyz_matrix(jnp.asarray(a_j))), atol=1e-6)


def _tied_field(rng, steps):
    # Quantized values: plateaus of equal minima and equal errors across minima.
    return (np.round(rng.uniform(0, 1, size=(steps,) * 3) * 6) / 6).astype(np.float32)


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("steps, radius", [(6, 2), (8, 1)])
def test_local_minima_mask_matches_jax(rng, tied, steps, radius):
    field = _tied_field(rng, steps) if tied else rng.uniform(0, 1, size=(steps,) * 3).astype(np.float32)
    want = np.asarray(jc.local_minima_mask(jnp.asarray(field), radius))
    got = tc.local_minima_mask(torch.as_tensor(field), radius).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tied", [False, True])
def test_candidates_match_jax_on_the_same_field(rng, monkeypatch, tied):
    steps, k = 6, 12
    field = _tied_field(rng, steps) if tied else rng.uniform(0, 1, size=(steps,) * 3).astype(np.float32)
    monkeypatch.setattr(jc, "score_rotation_field", lambda *a, **kw: jnp.asarray(field))
    monkeypatch.setattr(tc, "score_rotation_field", lambda *a, **kw: torch.as_tensor(field))
    dummy = np.zeros((4, 3), np.float32)
    m = np.ones((4,), bool)
    want = jc.coarse_align.__wrapped__(jnp.asarray(dummy), jnp.asarray(m), jnp.asarray(dummy), jnp.asarray(m),
                                       steps=steps, radius=2, max_candidates=k)
    got = tc.coarse_align(torch.as_tensor(dummy), torch.as_tensor(m), torch.as_tensor(dummy),
                          torch.as_tensor(m), steps=steps, radius=2, max_candidates=k)
    for name in ("candidate_angles", "candidate_mask", "candidate_errors", "best_angles"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)


def test_coarse_align_from_points_matches_jax(rng):
    src = random_cloud(rng, 200).astype(np.float32)
    tgt = random_cloud(rng, 180).astype(np.float32)
    sm, tm = np.ones(200, bool), np.ones(180, bool)
    want = jc.coarse_align(jnp.asarray(src), jnp.asarray(sm), jnp.asarray(tgt), jnp.asarray(tm),
                           steps=4, max_candidates=4, backend="xla", precision="highest")
    got = tc.coarse_align(*(torch.as_tensor(x) for x in (src, sm, tgt, tm)), steps=4, max_candidates=4)
    np.testing.assert_allclose(got.field.numpy(), np.asarray(want.field), rtol=2e-5, atol=2e-6)
    np.testing.assert_array_equal(got.candidate_mask.numpy(), np.asarray(want.candidate_mask))
    np.testing.assert_allclose(got.candidate_angles.numpy(), np.asarray(want.candidate_angles), rtol=1e-6)


def test_coarse_align_dot_method_matches_jax(rng):
    """coarse_method="dot" end to end through coarse_align. JAX on the CPU
    scores on its XLA path whatever the method (models/coarse.py:65-68,106)."""
    src = random_cloud(rng, 200).astype(np.float32)
    tgt = random_cloud(rng, 180).astype(np.float32)
    sm, tm = np.ones(200, bool), np.ones(180, bool)
    tm[170:] = False
    want = jc.coarse_align(jnp.asarray(src), jnp.asarray(sm), jnp.asarray(tgt), jnp.asarray(tm),
                           steps=4, max_candidates=4, method="dot", precision="highest")
    got = tc.coarse_align(*(torch.as_tensor(x) for x in (src, sm, tgt, tm)), steps=4, max_candidates=4,
                          method="dot", precision="high")
    np.testing.assert_allclose(got.field.numpy(), np.asarray(want.field), rtol=2e-5, atol=2e-6)
    np.testing.assert_array_equal(got.candidate_mask.numpy(), np.asarray(want.candidate_mask))
    np.testing.assert_allclose(got.candidate_angles.numpy(), np.asarray(want.candidate_angles), rtol=1e-6)


def test_other_field_metrics_are_not_ported(rng):
    x = torch.zeros((4, 3))
    m = torch.ones((4,), dtype=torch.bool)
    with pytest.raises(NotImplementedError):
        tc.score_rotation_field(x, m, x, m, steps=2, error_metric="trim")
