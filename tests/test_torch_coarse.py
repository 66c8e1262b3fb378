"""The port's coarse search (kss_icp_torch/models/coarse.py, ops/coarse_cuda.py)
against JAX: the "ave" field against the Pallas field kernel in interpret
mode, and the local-minima mask and candidate ranking against
kss_icp_tpu/models/coarse.py on identical fields, ties included. The field
kernel itself is tested on the card in tests/test_torch_card.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import random_cloud
from kss_icp_torch.core.transforms import euler_xyz_matrix as t_euler
from kss_icp_torch.models import coarse as tc
from kss_icp_torch.ops.coarse_cuda import field_ave
from kss_icp_tpu.core.transforms import euler_xyz_matrix
from kss_icp_tpu.models import coarse as jc
from kss_icp_tpu.ops.coarse_pallas import rotation_scores_pallas

torch.set_num_threads(1)


def _field_case(rng, p=130, t=100, steps=3, t_valid=None, s_valid=None):
    src = random_cloud(rng, p).astype(np.float32)
    tgt = random_cloud(rng, t).astype(np.float32)
    smask = np.ones((p,), bool)
    tmask = np.ones((t,), bool)
    if t_valid is not None:
        tmask[t_valid:] = False
    if s_valid is not None:
        smask[s_valid:] = False
        src[s_valid:] = 1e6  # garbage in the masked tail must not count
    angles = np.array(jc.rotation_grid(steps, 6.3, jnp.float32))
    want = rotation_scores_pallas(jnp.asarray(src), jnp.asarray(smask), jnp.asarray(tgt), jnp.asarray(tmask),
                                  euler_xyz_matrix(jnp.asarray(angles)), tile_q=128, interpret=True)
    got = field_ave(*(torch.as_tensor(x) for x in (src, smask, tgt, tmask)), t_euler(torch.as_tensor(angles)))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("kw", [{}, {"t_valid": 40}, {"p": 256, "t": 128, "steps": 2, "s_valid": 77}])
def test_field_matches_pallas_vpu_kernel(rng, kw):
    got, want = _field_case(rng, **kw)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


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


def test_other_field_metrics_are_not_ported(rng):
    x = torch.zeros((4, 3))
    m = torch.ones((4,), dtype=torch.bool)
    with pytest.raises(NotImplementedError):
        tc.score_rotation_field(x, m, x, m, steps=2, error_metric="trim")
