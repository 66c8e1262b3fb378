"""The port's 1-NN (kss_icp_torch/ops/nn.py, ops/nn_cuda.py) against the JAX
Pallas 1-NN kernels run in interpret mode, with the same float32 inputs.
On the CPU the `nn1` wrapper runs its plain version; the kernel itself is
tested on the card in tests/test_torch_card.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import random_cloud
from kss_icp_torch.ops import nn as tnn
from kss_icp_torch.ops.nn_cuda import nn1
from kss_icp_tpu.ops.nn import masked_mean_nn_sqdist, masked_quantile_threshold
from kss_icp_tpu.ops.nn_pallas import nearest_neighbor_pallas, nearest_neighbor_vpu

torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def test_plain_matches_vpu_kernel(rng):
    q = random_cloud(rng, 300).astype(np.float32)
    r = random_cloud(rng, 391).astype(np.float32)
    mask = np.ones((391,), bool)
    mask[350:] = False
    d2_j, idx_j = nearest_neighbor_vpu(jnp.asarray(q), jnp.asarray(r), jnp.asarray(mask),
                                       tile_q=128, interpret=True)
    d2, idx = nn1(_t(q), _t(r), _t(mask))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(d2.numpy(), np.asarray(d2_j), rtol=1e-5)


def test_plain_matches_tiled_pallas_kernel(rng):
    q = random_cloud(rng, 300).astype(np.float32)
    r = random_cloud(rng, 500).astype(np.float32)
    mask = np.ones((500,), bool)
    mask[480:] = False
    d2_j, idx_j = nearest_neighbor_pallas(jnp.asarray(q), jnp.asarray(r), jnp.asarray(mask),
                                          tile_q=128, tile_r=256, interpret=True)
    d2, idx = nn1(_t(q), _t(r), _t(mask))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(d2.numpy(), np.asarray(d2_j), atol=1e-5)


def test_masked_tail_never_wins(rng):
    q = random_cloud(rng, 64).astype(np.float32)
    r = np.concatenate([random_cloud(rng, 100), q[:10] + 1e-4]).astype(np.float32)
    mask = np.ones((110,), bool)
    mask[100:] = False
    d2, idx = nn1(_t(q), _t(r), _t(mask))
    d = np.linalg.norm(q.astype(np.float64)[:, None] - r.astype(np.float64)[None, :100], axis=-1) ** 2
    np.testing.assert_array_equal(idx.numpy(), d.argmin(axis=1))
    np.testing.assert_allclose(d2.numpy(), d.min(axis=1), rtol=1e-5, atol=1e-7)


def test_fully_masked_reference_reports_big(rng):
    q = random_cloud(rng, 16).astype(np.float32)
    r = random_cloud(rng, 32).astype(np.float32)
    mask = np.zeros((32,), bool)
    d2_j, idx_j = nearest_neighbor_vpu(jnp.asarray(q), jnp.asarray(r), jnp.asarray(mask),
                                       tile_q=128, interpret=True)
    d2, idx = nn1(_t(q), _t(r), _t(mask))
    assert np.all(d2.numpy() == np.float32(1e30))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(d2_j))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))


def test_ties_break_to_first_index():
    q = np.zeros((8, 3), np.float32)
    r = np.zeros((256, 3), np.float32)
    mask = np.ones((256,), bool)
    mask[:3] = False  # the first valid row is 3
    _, idx_j = nearest_neighbor_vpu(jnp.asarray(q), jnp.asarray(r), jnp.asarray(mask),
                                    tile_q=128, interpret=True)
    _, idx = nn1(_t(q), _t(r), _t(mask))
    np.testing.assert_array_equal(idx.numpy(), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))


def test_lane_ref_batch_matches_per_lane_loop(rng):
    lanes, groups = 5, 2
    q = np.stack([random_cloud(rng, 70) for _ in range(lanes)]).astype(np.float32)
    r = np.stack([random_cloud(rng, 90) for _ in range(groups)]).astype(np.float32)
    mask = np.ones((groups, 90), bool)
    mask[1, 60:] = False
    lane_ref = np.array([1, 0, 1, 1, 0], np.int32)
    d2, idx = nn1(_t(q), _t(r), _t(mask), _t(lane_ref))
    for l in range(lanes):
        g = lane_ref[l]
        d2_j, idx_j = nearest_neighbor_vpu(jnp.asarray(q[l]), jnp.asarray(r[g]), jnp.asarray(mask[g]),
                                           tile_q=128, interpret=True)
        np.testing.assert_array_equal(idx[l].numpy(), np.asarray(idx_j))
        np.testing.assert_allclose(d2[l].numpy(), np.asarray(d2_j), rtol=1e-5)


def test_lane_ref_required_when_ambiguous(rng):
    q = torch.zeros((3, 4, 3))
    r = torch.zeros((2, 5, 3))
    with pytest.raises(ValueError, match="lane_ref"):
        nn1(q, r, torch.ones((2, 5), dtype=torch.bool))


def test_masked_mean_nn_sqdist_matches_jax(rng):
    q = random_cloud(rng, 120).astype(np.float32)
    r = random_cloud(rng, 150).astype(np.float32)
    qm = np.ones((120,), bool)
    qm[100:] = False
    rm = np.ones((150,), bool)
    rm[140:] = False
    want = masked_mean_nn_sqdist(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(r), jnp.asarray(rm))
    got = tnn.masked_mean_nn_sqdist(_t(q), _t(qm), _t(r), _t(rm))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_query_chunking_is_invisible(rng, monkeypatch):
    q = random_cloud(rng, 257).astype(np.float32)
    r = random_cloud(rng, 64).astype(np.float32)
    mask = np.ones((64,), bool)
    whole = tnn.nearest_neighbor(_t(q), _t(r), _t(mask))
    monkeypatch.setattr(tnn, "_BLOCK_ELEMS", 64 * 10)  # 10 query rows per block
    chunked = tnn.nearest_neighbor(_t(q), _t(r), _t(mask))
    assert torch.equal(whole[0], chunked[0]) and torch.equal(whole[1], chunked[1])


def _quantile_rows(rng):
    """Rows with ties and with 0, 1, some and all of 40 entries valid."""
    vals = np.round(rng.uniform(0, 1, size=(6, 40)) * 8).astype(np.float32) / 8  # many ties
    mask = np.ones((6, 40), bool)
    mask[0] = False              # n_valid 0
    mask[1, 1:] = False          # n_valid 1
    mask[2, 10:] = False
    mask[3, ::3] = False
    mask[4, 20:] = False
    vals[4, 20:] = -5.0          # invalid entries must never rank
    return vals, mask            # row 5: all valid


@pytest.mark.parametrize("q", [0.7, 0.95, 1.0, 0.0])
def test_masked_quantile_threshold_matches_jax(rng, q):
    vals, mask = _quantile_rows(rng)
    want = np.asarray(masked_quantile_threshold(jnp.asarray(vals), jnp.asarray(mask), q))
    got = tnn.masked_quantile_threshold(_t(vals), _t(mask), q).numpy()
    np.testing.assert_array_equal(got, want)


def test_trim_count_keeps_exact_integer_ranks():
    n = torch.tensor([1000, 10, 7, 8191], dtype=torch.int32)
    assert tnn._trim_count(n, 0.7).tolist() == [700, 7, 5, 5734]
    # float32(0.3) * 50 = 15.000001: without the 1e-3 guard the rank would be 16.
    assert tnn._trim_count(torch.tensor([50], dtype=torch.int32), 0.3).tolist() == [15]


def test_masked_quantile_threshold_refuses_8192_wide_rows():
    tnn.masked_quantile_threshold(torch.zeros((2, 8191)), torch.ones((2, 8191), dtype=torch.bool), 0.9)
    with pytest.raises(ValueError, match="8192"):
        tnn.masked_quantile_threshold(torch.zeros((1, 8192)), torch.ones((1, 8192), dtype=torch.bool), 0.9)


@pytest.mark.parametrize("masked", [0, 40])
def test_nn_sqdistances_match_jax_min(rng, masked):
    """The squared per-point values of the "max" and "diff" fields: JAX's
    min over where(ref_mask, d², 1e30) (kss_icp_tpu/ops/nn.py:183-186; its
    expansion form, rtol 1e-5), 0 at a masked query point, rows of a batch."""
    from kss_icp_tpu.ops.nn import pairwise_sqdist

    q = np.stack([random_cloud(rng, 150) for _ in range(3)]).astype(np.float32)
    r = random_cloud(rng, 200).astype(np.float32)
    qmask = rng.uniform(size=150) > 0.2
    rmask = np.arange(200) < 200 - masked
    d2 = np.asarray(pairwise_sqdist(jnp.asarray(q), jnp.asarray(r)[None]))
    want = np.where(rmask, d2, 1e30).min(axis=-1)
    got = tnn.nn_sqdistances(_t(q), _t(qmask), _t(r), _t(rmask)).numpy()
    np.testing.assert_allclose(got[:, qmask], want[:, qmask], rtol=1e-5, atol=1e-6)
    assert not got[:, ~qmask].any()


def test_knn_blocks_bound_the_memory_across_clouds(rng, monkeypatch):
    """knn's row blocks count the leading axes: a batch of clouds through
    blocks of a few rows gives the one-block answer."""
    q = np.stack([random_cloud(rng, 90) for _ in range(4)]).astype(np.float32)
    mask = rng.uniform(size=(4, 90)) > 0.3
    whole = tnn.knn(_t(q), _t(q), _t(mask), 5)
    monkeypatch.setattr(tnn, "_KNN_BLOCK_ELEMS", 4 * 90 * 7)  # 7 rows a block
    blocked = tnn.knn(_t(q), _t(q), _t(mask), 5)
    assert torch.equal(whole[0], blocked[0]) and torch.equal(whole[1], blocked[1])
