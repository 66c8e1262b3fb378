"""The port's voxel grid and AIVS resampler (kss_icp_torch/ops/spatial.py,
ops/aivs.py) against the JAX package's jitted functions
(kss_icp_tpu/ops/spatial.py, ops/aivs.py) on the same float32 inputs, every
answer equal: random surface clouds, and probes of XLA's CPU rounding.

* Face probes: points a few ulps either side of the faces of a grid whose
  extent is not a multiple of its reciprocal's rounding, so that a box edge
  computed as extent / n (eager float32) and as extent * (1 / n) (XLA's
  rewrite inside the jitted build_voxel_grid) put some of them in other
  boxes.
* Swap probes: each box holds g ± (a, b, e) and g ± (b, a, e) about its
  centre g, which is also the four points' centroid, exactly. The squared
  distances a² + b² + e² and b² + a² + e² tie when each square rounds on its
  own and need not when XLA fuses them, fma(e, e, fma(b, b, a²)), so the
  nearest-to-centre point and the first FPS pick follow the rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import random_cloud
from kss_icp_torch.ops import aivs as ta
from kss_icp_torch.ops import spatial as ts
from kss_icp_tpu.ops import aivs as ja
from kss_icp_tpu.ops import spatial as js

torch.set_num_threads(1)


def _t(*xs):
    return [torch.as_tensor(np.array(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _surface(rng, n=700, valid=650):
    pts = random_cloud(rng, n).astype(np.float32)
    mask = np.arange(n) < valid
    return pts, mask, 10


def _face_probe(rng):
    """Points within 3 ulps of the box faces of a 10-box grid over an extent
    whose edge rounds differently as a division and as a product by the
    reciprocal."""
    while True:
        ext = np.float32(rng.uniform(0.3, 3.0))
        if ext / np.float32(10) != ext * (np.float32(1) / np.float32(10)):
            break
    unit = ext * (np.float32(1) / np.float32(10))
    faces = (np.arange(1, 10) * unit.astype(np.float64)).astype(np.float32)
    near = np.concatenate([np.nextafter(faces, np.float32(k * np.inf)) if k else faces for k in (-1, 0, 1)])
    for _ in range(2):
        near = np.concatenate([near, np.nextafter(near, np.float32(np.inf)), np.nextafter(near, np.float32(-np.inf))])
    coords = rng.choice(np.unique(near), size=(600, 3))
    corners = np.float32([[0, 0, 0], [ext, ext, ext]])
    return np.concatenate([corners, coords]).astype(np.float32), np.ones(602, bool), 10


def _swap_probe(rng):
    """Four points g ± (a, b, e), g ± (b, a, e) in each box of a 4-box grid
    over [0, 1]^3; a, b, e multiples of 2^-22 below 1/8, so each point, the
    box's sums and its centroid are exact and the squares round."""
    nb, unit = 4, 0.25
    rows = [np.float32([[0, 0, 0], [1, 1, 1]])]
    for i in range(nb):
        for j in range(nb):
            for k in range(nb):
                g = (np.array([i, j, k]) + 0.5) * unit
                a, b, e = rng.integers(1, 2 ** 19, size=3) * 2.0 ** -22
                rows.append(np.float32([g + (a, b, e), g + (b, a, e), g - (a, b, e), g - (b, a, e)]))
    pts = np.concatenate(rows).astype(np.float32)
    return pts, np.ones(len(pts), bool), nb


CASES = {"surface": _surface, "face probe": _face_probe, "swap probe": _swap_probe}


def test_estimate_box_scale_matches_jax():
    for n in (1, 9_999, 10_000, 49_999, 50_000, 99_999, 100_000, 499_999, 500_000, 999_999, 1_000_000, 8_000_000):
        assert ts.estimate_box_scale(n) == js.estimate_box_scale(n)


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_voxel_grid_matches_jax(rng, case):
    pts, mask, nb = CASES[case](rng)
    want = js.build_voxel_grid(*_j(pts, mask), nb)
    got = ts.build_voxel_grid(*_t(pts, mask), nb)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    assert got.num_boxes == nb ** 3
    if case == "swap probe":  # the fused rounding shows: some box's nearest point is its second, the swapped one
        offset = (got.center_point.numpy() - 2) % 4
        assert set(offset.tolist()) <= {0, 1} and (offset == 1).any()


def test_voxel_grid_batch_rows_equal_single_calls(rng):
    clouds = [_surface(rng)[:2] for _ in range(3)]
    clouds[1][1][400:] = False
    pts, mask = (torch.as_tensor(np.stack([c[i] for c in clouds])) for i in (0, 1))
    batch = ts.build_voxel_grid(pts, mask, 6)
    for b in range(3):
        one = ts.build_voxel_grid(pts[b], mask[b], 6)
        for f in one._fields:
            assert torch.equal(getattr(batch, f)[b], getattr(one, f)), f


def test_stencils_and_neighbourhoods_match_jax(rng):
    for nb in (1, 3, 5):
        np.testing.assert_array_equal(ts.box_coloring(nb).numpy(), np.asarray(js.box_coloring(nb)))
        np.testing.assert_array_equal(ts.neighbor_box_ids(nb).numpy(), np.asarray(js.neighbor_box_ids(nb)))
    pts, mask, _ = _surface(rng)
    gj, gt = js.build_voxel_grid(*_j(pts, mask), 5), ts.build_voxel_grid(*_t(pts, mask), 5)
    for box in (0, 31, 62, 124):
        np.testing.assert_array_equal(ts.points_in_neighborhood(gt, 5, box).numpy(),
                                      np.asarray(js.points_in_neighborhood(gj, 5, box)))
    dj, ij = js.knn_cache(*_j(pts, mask), 6)
    dt, it = ts.knn_cache(*_t(pts, mask), 6)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    # JAX's squared distances are the expansion form's, off by ~|p|² eps.
    np.testing.assert_allclose(dt.numpy() ** 2, np.asarray(dj) ** 2, rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("samples", [1, 90, 333, 2000])
def test_box_quotas_match_jax(rng, samples):
    counts = rng.integers(0, 40, size=(64,)).astype(np.int32)
    rates = rng.choice([1.0, 3.0, 7.0, 2.5], size=64).astype(np.float32)
    for r in (None, rates):
        want = ja.box_quotas(jnp.asarray(counts), samples, None if r is None else jnp.asarray(r))
        got = ta.box_quotas(torch.as_tensor(counts), samples, None if r is None else torch.as_tensor(r))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", sorted(CASES))
def test_stratified_fps_matches_jax(rng, case):
    """The selection and each point's pick round; the port's loop stops at
    the largest quota, JAX's at max_rounds."""
    pts, mask, nb = CASES[case](rng)
    grid = js.build_voxel_grid(*_j(pts, mask), nb)
    samples = 3 * len(pts) // 4 if case == "swap probe" else 300
    quotas = ja.box_quotas(grid.counts, samples)
    want = ja.stratified_fps(*_j(pts, mask), grid.box_id, quotas, max_rounds=64)
    got = ta.stratified_fps(*_t(pts, mask, grid.box_id, quotas), 64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if case == "swap probe":  # some box's first pick is not its first point
        first = got[1].numpy().reshape(-1)[2:].reshape(-1, 4).argmin(axis=1)
        assert (first != 0).any()


@pytest.mark.parametrize("n", [700, 1500])
def test_accurate_cut_matches_jax(rng, n):
    """On random surfaces. The cut's 3-NN distances are exact differences
    here and the expansion form in JAX, so clouds with tied pair distances
    (the probes' lattices) can lose another member of a pair (ROADMAP.md
    queue 3)."""
    pts, mask, nb = _surface(rng, n, n - 50)
    grid = js.build_voxel_grid(*_j(pts, mask), nb)
    quotas = ja.box_quotas(grid.counts, 250)
    sel, _ = ja.stratified_fps(*_j(pts, mask), grid.box_id, quotas, max_rounds=64)
    target = int(sel.sum()) - 17
    want = ja.accurate_cut(jnp.asarray(pts), sel, target, max_cuts=64)
    got = ta.accurate_cut(*_t(pts, sel), target, 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) == target
    # A budget below the slack leaves the count above the target, as in JAX.
    want = ja.accurate_cut(jnp.asarray(pts), sel, target, max_cuts=8)
    got = ta.accurate_cut(*_t(pts, sel), target, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_aivs_resample_packed_matches_jax(rng):
    """Three clouds in one call (box ids offset by the cloud), each row JAX's
    single-cloud answer; pad above and below the cloud size."""
    clouds = [_surface(rng)[:2] for _ in range(3)]
    clouds[1][1][500:] = False
    pts, mask = (np.stack([c[i] for c in clouds]) for i in (0, 1))
    samples = np.array([200, 120, 333])
    for pad in (256, 1024):
        got = ta.aivs_resample_packed(*_t(pts, mask, samples), pad, 10)
        for b in range(3):
            want = ja.aivs_resample_packed(*_j(pts[b], mask[b]), int(samples[b]), pad, 10)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))


@pytest.mark.parametrize("normals", [False, True])
def test_aivs_resample_matches_jax(rng, normals):
    """The host-facing AIVS (`simplify -m aivs`): exactly num_samples picks,
    JAX's; with normals, the curvature classes raise the curved boxes'
    quotas."""
    pts, mask, _ = _surface(rng, 900, 880)
    nrm = None
    if normals:
        from kss_icp_tpu.ops.normals import estimate_normals

        nrm = np.array(estimate_normals(*_j(pts, mask)))
    want = ja.aivs_resample(*_j(pts, mask), 300, normals=None if nrm is None else jnp.asarray(nrm))
    got = ta.aivs_resample(*_t(pts, mask), 300, normals=None if nrm is None else torch.as_tensor(nrm))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[1].sum()) == 300


def test_curvature_classes_match_jax(rng):
    pts, mask, _ = _surface(rng)
    nrm = rng.normal(size=pts.shape).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm[::3] = [0, 0, 1]  # flat patches among random directions: every class occurs
    cls = ta.classify_curvature(*_t(nrm, pts, mask))
    np.testing.assert_array_equal(cls.numpy(), np.asarray(ja.classify_curvature(*_j(nrm, pts, mask))))
    assert set(cls[torch.as_tensor(mask)].tolist()) == {0, 1, 2} or len(set(cls.tolist())) > 1
    grid = js.build_voxel_grid(*_j(pts, mask), 4)
    want = ja.class_rate_per_box(jnp.asarray(cls.numpy()), grid.box_id, jnp.asarray(mask), 64)
    got = ta.class_rate_per_box(cls, torch.as_tensor(np.asarray(grid.box_id)), torch.as_tensor(mask), 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
