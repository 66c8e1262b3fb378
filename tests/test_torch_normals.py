"""The port's normals (kss_icp_torch/ops/normals.py) against the JAX package's
(kss_icp_tpu/ops/normals.py) on the same float32 inputs: PCA normals to
|n · n_JAX| >= 1 - 1e-5 on clouds with a clear eigengap (an eigenvector is
defined up to sign, and not at all where the two smallest eigenvalues tie),
pad rows exactly [0, 0, 1], a batch's rows equal to single calls, the
orientation's signs equal when both are fed JAX's normals, and the mesh
normals and error measures at rtol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import random_cloud
from kss_icp_torch.ops import normals as tn
from kss_icp_tpu.ops import normals as jn

torch.set_num_threads(1)


def _plane(rng, n):
    p = rng.uniform(-1, 1, size=(n, 3))
    p[:, 2] = 0.2 * p[:, 0] - 0.1 * p[:, 1]
    return p


def _sphere(rng, n):
    p = rng.normal(size=(n, 3))
    return p / np.linalg.norm(p, axis=1, keepdims=True)


def _noisy(rng, n):
    return random_cloud(rng, n) + rng.normal(0, 0.005, size=(n, 3))


CLOUDS = {"plane": _plane, "sphere": _sphere, "noisy surface": _noisy}


def _cloud(rng, kind, n=320, valid=300):
    pts = CLOUDS[kind](rng, n).astype(np.float32)
    mask = np.arange(n) < valid
    return pts, mask


@pytest.mark.parametrize("kind", sorted(CLOUDS))
def test_estimate_normals_matches_jax(rng, kind):
    pts, mask = _cloud(rng, kind)
    want = np.asarray(jn.estimate_normals(jnp.asarray(pts), jnp.asarray(mask)))
    got = tn.estimate_normals(torch.as_tensor(pts), torch.as_tensor(mask)).numpy()
    assert np.abs((got * want).sum(-1))[mask].min() >= 1 - 1e-5
    np.testing.assert_array_equal(got[~mask], np.tile(np.float32([0, 0, 1]), ((~mask).sum(), 1)))
    np.testing.assert_allclose(np.linalg.norm(got[mask], axis=1), 1.0, rtol=1e-6)


def test_estimate_normals_batch_rows_equal_single_calls(rng):
    """A batch's targets take one knn and one batched eigh; each row is the
    single call's, bit for bit."""
    clouds = [_cloud(rng, kind) for kind in sorted(CLOUDS)]
    pts = torch.as_tensor(np.stack([c[0] for c in clouds]))
    mask = torch.as_tensor(np.stack([c[1] for c in clouds]))
    batch = tn.estimate_normals(pts, mask)
    for b in range(len(clouds)):
        assert torch.equal(batch[b], tn.estimate_normals(pts[b], mask[b]))


def test_estimate_normals_eigh_chunks_are_invisible(rng, monkeypatch):
    """The eigh calls of EIGH_BATCH matrices (cuSOLVER's batch limit) give
    the one-call answer."""
    pts, mask = (torch.as_tensor(np.stack(x)) for x in zip(*[_cloud(rng, "noisy surface") for _ in range(2)]))
    whole = tn.estimate_normals(pts, mask)
    monkeypatch.setattr(tn, "EIGH_BATCH", 77)
    assert torch.equal(tn.estimate_normals(pts, mask), whole)


@pytest.mark.parametrize("kind", ["sphere", "noisy surface"])
def test_orient_normals_matches_jax(rng, kind):
    """Fed JAX's own normals, the propagation flips the same points."""
    pts, mask = _cloud(rng, kind)
    normals = np.asarray(jn.estimate_normals(jnp.asarray(pts), jnp.asarray(mask)))
    want = np.asarray(jn.orient_normals(jnp.asarray(pts), jnp.asarray(normals), jnp.asarray(mask)))
    got = tn.orient_normals(*(torch.as_tensor(np.array(x)) for x in (pts, normals, mask))).numpy()
    np.testing.assert_array_equal(np.sign(got), np.sign(want))
    np.testing.assert_array_equal(got, want)
    assert (np.sign(want) != np.sign(normals)).any()  # some point was flipped


def test_estimate_oriented_normals_matches_jax(rng):
    pts, mask = _cloud(rng, "sphere")
    want = np.asarray(jn.estimate_oriented_normals(jnp.asarray(pts), jnp.asarray(mask)))
    got = tn.estimate_oriented_normals(torch.as_tensor(pts), torch.as_tensor(mask)).numpy()
    # Oriented: the same vectors, sign included, up to rounding.
    assert (got * want).sum(-1)[mask].min() >= 1 - 1e-5


def _mesh(rng):
    """A jittered 6 x 6 grid of vertices, two triangles a cell, and one
    vertex no face touches."""
    g = np.stack(np.meshgrid(np.arange(6), np.arange(6), indexing="ij"), -1).reshape(-1, 2).astype(np.float32)
    z = 0.3 * np.sin(g[:, :1]) * np.cos(0.5 * g[:, 1:])
    verts = np.concatenate([g + rng.uniform(-0.2, 0.2, g.shape), z], axis=1).astype(np.float32)
    verts = np.concatenate([verts, np.float32([[9, 9, 9]])])
    faces = []
    for i in range(5):
        for j in range(5):
            a, b, c, d = i * 6 + j, i * 6 + j + 1, (i + 1) * 6 + j, (i + 1) * 6 + j + 1
            faces += [(a, b, c), (b, d, c)]
    return verts, np.asarray(faces, np.int32)


@pytest.mark.parametrize("area_weighted", [True, False])
def test_mesh_normals_match_jax(rng, area_weighted):
    verts, faces = _mesh(rng)
    np.testing.assert_allclose(tn.facet_normals(torch.as_tensor(verts), torch.as_tensor(faces)).numpy(),
                               np.asarray(jn.facet_normals(verts, faces)), rtol=1e-5, atol=1e-7)
    want = np.asarray(jn.vertex_normals_from_mesh(verts, faces, area_weighted))
    got = tn.vertex_normals_from_mesh(torch.as_tensor(verts), torch.as_tensor(faces), area_weighted).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert not got[-1].any()  # the vertex no face touches


def test_normal_error_measure_matches_jax(rng):
    pts, mask = _cloud(rng, "noisy surface")
    est = np.array(jn.estimate_normals(jnp.asarray(pts), jnp.asarray(mask)))
    ref = (est + rng.normal(0, 0.05, est.shape)).astype(np.float32)
    ref[:5] = 0.0  # "single points": left out of the reductions
    ref[5:40] *= -1  # the measure does not see the sign
    want = jn.normal_error_measure(est, ref)
    got = tn.normal_error_measure(torch.as_tensor(est), torch.as_tensor(ref))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
    angle, valid = tn.normal_angle_errors(torch.as_tensor(est), torch.as_tensor(ref))
    np.testing.assert_allclose(angle.numpy(), np.asarray(jn.normal_angle_errors(est, ref)[0]), rtol=1e-5, atol=1e-6)
    assert int(valid.sum()) == len(est) - 5
