"""The port's core (kss_icp_torch/core: transforms, padded clouds, Kendall
pre-shape) against kss_icp_tpu/core on the same float32 inputs."""

import jax.numpy as jnp
import numpy as np
import torch

from helpers import random_cloud
from kss_icp_torch.core import cloud as tcl
from kss_icp_torch.core import preshape as tps
from kss_icp_torch.core import transforms as ttf
from kss_icp_tpu.core import cloud as jcl
from kss_icp_tpu.core import preshape as jps
from kss_icp_tpu.core import transforms as jtf

torch.set_num_threads(1)


def _sims(rng, batch=()):
    angles = rng.uniform(-3, 3, size=batch + (3,)).astype(np.float32)
    scale = rng.uniform(0.5, 2, size=batch).astype(np.float32)
    trans = rng.uniform(-1, 1, size=batch + (3,)).astype(np.float32)
    j = jtf.Similarity(jnp.asarray(scale), jtf.euler_xyz_matrix(jnp.asarray(angles)), jnp.asarray(trans))
    t = ttf.Similarity(torch.as_tensor(scale), ttf.euler_xyz_matrix(torch.as_tensor(angles)),
                       torch.as_tensor(trans))
    return j, t


def test_axis_rotations_and_euler_match_jax(rng):
    a = rng.uniform(-3, 3, size=(5,)).astype(np.float32)
    for jf, tf in ((jtf.rot_x, ttf.rot_x), (jtf.rot_y, ttf.rot_y), (jtf.rot_z, ttf.rot_z)):
        np.testing.assert_allclose(tf(torch.as_tensor(a)).numpy(), np.asarray(jf(jnp.asarray(a))), atol=1e-6)
    j, t = _sims(rng, (4,))
    np.testing.assert_allclose(t.rotation.numpy(), np.asarray(j.rotation), atol=1e-6)


def test_apply_and_compose_match_jax(rng):
    (ja, ta), (jb, tb) = _sims(rng), _sims(rng)
    pts = random_cloud(rng, 50).astype(np.float32)
    np.testing.assert_allclose(ttf.apply_similarity(ta, torch.as_tensor(pts)).numpy(),
                               np.asarray(jtf.apply_similarity(ja, jnp.asarray(pts))), atol=1e-5)
    jc, tc = jtf.compose(ja, jb), ttf.compose(ta, tb)
    for name in ("scale", "rotation", "translation"):
        np.testing.assert_allclose(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)), atol=1e-5)
    # compose(outer, inner) applies inner first.
    np.testing.assert_allclose(ttf.apply_similarity(tc, torch.as_tensor(pts)).numpy(),
                               ttf.apply_similarity(ta, ttf.apply_similarity(tb, torch.as_tensor(pts))).numpy(),
                               atol=1e-5)


def test_point_cloud_padding_matches_jax(rng):
    pts = random_cloud(rng, 300).astype(np.float32)
    j, t = jcl.PointCloud.from_points(pts), tcl.PointCloud.from_points(pts)
    assert t.padded_size == j.padded_size == 512
    np.testing.assert_array_equal(t.points.numpy(), np.asarray(j.points))
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    assert int(t.count) == 300
    np.testing.assert_array_equal(t.to_numpy(), pts)


def test_middle_align_matches_jax(rng):
    src = (random_cloud(rng, 200) * 2.5 + 0.7).astype(np.float32)
    tgt = random_cloud(rng, 256).astype(np.float32)
    sm = np.ones(200, bool)
    sm[180:] = False
    tm = np.ones(256, bool)
    tm[250:] = False
    js, jct, jsc = jps.middle_align(*(jnp.asarray(x) for x in (src, sm, tgt, tm)))
    ts, tct, tsc = tps.middle_align(*(torch.as_tensor(x) for x in (src, sm, tgt, tm)))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=1e-6)
    np.testing.assert_allclose(tct.numpy(), np.asarray(jct), atol=1e-6)
    np.testing.assert_allclose(ts.translation.numpy(), np.asarray(js.translation), atol=1e-6)
    np.testing.assert_array_equal(ts.rotation.numpy(), np.eye(3, dtype=np.float32))
