"""simplification_measure (kss_icp_torch/measure_resample.py) against JAX's
jitted function on the same seeded float32 clouds: the sampling rate equal,
and the average and largest displacement within rtol 1e-4 given the same
normals. Each package's default normals are PCA eigenvectors whose signs are
its eigensolver's choice, and the MLS blend follows them (ROADMAP.md queue
3): shown here by flipping signs in JAX's own normals. The properties of
tests/test_measure_resample.py hold on the port's own normals."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import random_cloud
from kss_icp_torch.measure_resample import simplification_measure
from kss_icp_torch.ops.nn import knn, knn_kth_sqdist
from kss_icp_torch.ops.resample import fps_points
from kss_icp_tpu import measure_resample as jm
from kss_icp_tpu.ops.normals import estimate_normals as jax_normals
from kss_icp_tpu.ops.resample import fps_points as jax_fps_points

torch.set_num_threads(1)

RTOL = 1e-4


def _inputs(n, s, seed=0):
    """An original of n points and its JAX FPS resample to s (all of it when
    s == n), as numpy float32 and bool."""
    pts = random_cloud(np.random.default_rng(seed), n).astype(np.float32)
    mask = np.ones(n, bool)
    if s == n:
        return pts, mask, pts, mask
    sp, sm = jax_fps_points(jnp.asarray(pts), jnp.asarray(mask), s)
    return pts, mask, np.array(sp), np.array(sm)


def _port(args, **kw):
    return {k: float(v) for k, v in simplification_measure(*(torch.as_tensor(a) for a in args), **kw).items()}


def _jax(args, **kw):
    return {k: float(v) for k, v in jm.simplification_measure(*(jnp.asarray(a) for a in args), **kw).items()}


@pytest.mark.parametrize("n, s", [(400, 400), (2000, 64), (2000, 512), (1000, 250)])
def test_measure_matches_jax_given_its_normals(n, s):
    """With JAX's PCA normals of the simplified cloud the port's projection
    gives JAX's displacements at rtol 1e-4; the sampling rate is equal."""
    args = _inputs(n, s)
    want = _jax(args)
    normals = torch.as_tensor(np.array(jax_normals(jnp.asarray(args[2]), jnp.asarray(args[3]), k=12)))
    got = _port(args, normals=normals)
    assert got["sampling_rate"] == want["sampling_rate"]
    for key in ("avg_displacement", "max_displacement"):
        assert got[key] == pytest.approx(want[key], rel=RTOL), key


def test_measure_follows_the_normals_signs():
    """JAX's own measure moves when the signs of some of its normals flip
    (what another eigensolver does to a fifth of them): by far more than the
    bar. So each package's default measure is its eigensolver's; the port's
    with its own normals is reported beside JAX's, not held to it."""
    args = _inputs(2000, 512)
    normals = np.array(jax_normals(jnp.asarray(args[2]), jnp.asarray(args[3]), k=12))
    flip = np.where(np.random.default_rng(1).uniform(size=(512, 1)) < 0.2, -1.0, 1.0).astype(np.float32)
    base = _port(args, normals=torch.as_tensor(normals))
    flipped = _port(args, normals=torch.as_tensor(normals * flip))
    assert abs(flipped["avg_displacement"] / base["avg_displacement"] - 1.0) > 100 * RTOL
    own = _port(args)
    assert own["sampling_rate"] == base["sampling_rate"]
    assert own["avg_displacement"] == pytest.approx(base["avg_displacement"], rel=0.5)  # the same scale


def test_measure_radius_is_the_12nn_radius():
    """The default support radius (the largest 12-NN distance of the
    simplified cloud) through knn_kth_sqdist equals knn's 13th column, and
    passing it explicitly gives the same measure."""
    args = _inputs(1000, 250)
    s, sm = torch.as_tensor(args[2]), torch.as_tensor(args[3])
    kth = knn_kth_sqdist(s, s, sm, 13)
    assert torch.equal(kth, knn(s, s, sm, 13)[0][:, -1])
    radius = float(torch.sqrt(kth).max())
    assert _port(args) == _port(args, radius=radius)


def test_measure_row_blocks_give_one_blocks_answer(monkeypatch):
    import kss_icp_torch.measure_resample as tm

    args = _inputs(600, 150)
    whole = _port(args)
    monkeypatch.setattr(tm, "_BLOCK_ELEMS", 13 * 150)
    assert _port(args) == whole


# The properties of tests/test_measure_resample.py, on the port's own normals.

def test_identity_simplification_small_error():
    m = _port(_inputs(400, 400))
    assert m["avg_displacement"] < 0.06
    assert abs(m["sampling_rate"] - 1.0) < 1e-6


def test_denser_simplification_is_better():
    pts = torch.as_tensor(random_cloud(np.random.default_rng(0), 2000).astype(np.float32))
    mask = torch.ones(2000, dtype=torch.bool)
    e = {}
    for s in (64, 512):
        sp, sm = fps_points(pts, mask, s)
        e[s] = {k: float(v) for k, v in simplification_measure(pts, mask, sp, sm).items()}
    assert e[512]["avg_displacement"] < e[64]["avg_displacement"]
    np.testing.assert_allclose(e[512]["sampling_rate"], 512 / 2000, rtol=1e-5)


def test_displacement_bounded_by_spacing():
    m = _port(_inputs(1000, 250))
    assert m["avg_displacement"] < 0.1
    assert m["max_displacement"] < 1.0
