"""The port's batched lockstep ICP (kss_icp_torch/models/icp.py) against JAX's
vmapped `icp` (kss_icp_tpu/models/icp.py) on the same float32 lanes: per-lane
iterations and converged flags equal, R and t within 1e-4."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import random_cloud
from kss_icp_torch.config import from_reference
import kss_icp_torch.models.icp
from kss_icp_tpu.config import KSSICPConfig
from kss_icp_tpu.core.transforms import euler_xyz_matrix
import kss_icp_tpu.models.icp

torch.set_num_threads(1)
# The packages' models/__init__ re-export the function `icp` over the module name.
ti = sys.modules["kss_icp_torch.models.icp"]
ji = sys.modules["kss_icp_tpu.models.icp"]


def _lanes(rng, lanes=5, n=128, t=160):
    tgt = random_cloud(rng, t).astype(np.float32)
    base = (tgt[rng.permutation(t)[:n]] + rng.normal(0, 0.01, size=(n, 3))).astype(np.float32)
    angles = rng.uniform(-0.4, 0.4, size=(lanes, 3)).astype(np.float32)
    r = np.asarray(euler_xyz_matrix(jnp.asarray(angles)))
    src = (np.einsum("lij,nj->lni", r, base) + rng.uniform(-0.1, 0.1, size=(lanes, 1, 3))).astype(np.float32)
    smask = np.ones((n,), bool)
    smask[n - 9:] = False
    tmask = np.ones((t,), bool)
    tmask[t - 7:] = False
    return src, smask, tgt, tmask


def _jax_icp(src, smask, tgt, tmask, cfg, max_iterations, init=None):
    params = ji.ICPParams.from_config(cfg, jnp.float32)._replace(
        max_iterations=jnp.asarray(max_iterations, jnp.int32))
    if init is None:
        f = jax.vmap(ji.icp, in_axes=(0, None, None, None, None))
        return f(jnp.asarray(src), jnp.asarray(smask), jnp.asarray(tgt), jnp.asarray(tmask), params)
    f = jax.vmap(ji.icp, in_axes=(0, None, None, None, None, 0, 0, 0))
    return f(jnp.asarray(src), jnp.asarray(smask), jnp.asarray(tgt), jnp.asarray(tmask), params,
             *(jnp.asarray(x) for x in init))


def _torch_icp(src, smask, tgt, tmask, cfg, max_iterations, init=None, device="cpu"):
    params = ti.ICPParams.from_config(from_reference(cfg))._replace(max_iterations=max_iterations)
    args = [torch.as_tensor(x, device=device) for x in (src, smask, tgt, tmask)]
    init = [] if init is None else [torch.as_tensor(np.array(x), device=device) for x in init]
    return ti.icp(*args, params, *init)


def _assert_same(got, want):
    np.testing.assert_array_equal(got.iterations.cpu().numpy(), np.asarray(want.iterations))
    np.testing.assert_array_equal(got.converged.cpu().numpy(), np.asarray(want.converged))
    np.testing.assert_allclose(got.rotation.cpu().numpy(), np.asarray(want.rotation), atol=1e-4)
    np.testing.assert_allclose(got.translation.cpu().numpy(), np.asarray(want.translation), atol=1e-4)
    np.testing.assert_allclose(got.fitness.cpu().numpy(), np.asarray(want.fitness), rtol=1e-4, atol=1e-7)


def test_kabsch_matches_jax(rng):
    a = random_cloud(rng, 64).astype(np.float32)
    r = np.asarray(euler_xyz_matrix(jnp.asarray([0.3, -0.2, 1.1], jnp.float32)))
    b = (a @ r.T + np.array([0.1, -0.3, 0.2]) + rng.normal(0, 0.01, size=a.shape)).astype(np.float32)
    w = (rng.uniform(size=64) > 0.2).astype(np.float32)
    r_j, t_j = ji.kabsch(jnp.asarray(a), jnp.asarray(b), jnp.asarray(w))
    r_t, t_t = ti.kabsch(torch.as_tensor(a)[None], torch.as_tensor(b)[None], torch.as_tensor(w)[None])
    np.testing.assert_allclose(r_t[0].numpy(), np.asarray(r_j), atol=1e-5)
    np.testing.assert_allclose(t_t[0].numpy(), np.asarray(t_j), atol=1e-5)
    assert abs(float(torch.linalg.det(r_t[0])) - 1.0) < 1e-5


def test_kabsch_reflection_is_corrected(rng):
    a = random_cloud(rng, 50).astype(np.float32)
    b = a * np.array([1.0, 1.0, -1.0], np.float32)  # a mirror image: best orthogonal fit is a reflection
    w = np.ones(50, np.float32)
    r_j, _ = ji.kabsch(jnp.asarray(a), jnp.asarray(b), jnp.asarray(w))
    r_t, _ = ti.kabsch(torch.as_tensor(a)[None], torch.as_tensor(b)[None], torch.as_tensor(w)[None])
    np.testing.assert_allclose(r_t[0].numpy(), np.asarray(r_j), atol=1e-5)
    assert float(torch.linalg.det(r_t[0])) > 0


@pytest.mark.parametrize("max_iterations, cfg", [
    (30, KSSICPConfig()),                                            # converges by the relative MSE gate
    (3, KSSICPConfig()),                                             # some lanes hit the cap
    (40, KSSICPConfig(euclidean_fitness_epsilon=1e-6, transformation_epsilon=1e-8)),  # mixed exits
    (25, KSSICPConfig(fitness_epsilon_mode="absolute")),
])
def test_batched_icp_matches_vmapped_jax(rng, max_iterations, cfg):
    src, smask, tgt, tmask = _lanes(rng)
    want = _jax_icp(src, smask, tgt, tmask, cfg, max_iterations)
    got = _torch_icp(src, smask, tgt, tmask, cfg, max_iterations)
    _assert_same(got, want)


def _warm_case(rng):
    src, smask, tgt, tmask = _lanes(rng, lanes=3)
    first = _jax_icp(src, smask, tgt, tmask, KSSICPConfig(), 2)
    return (src, smask, tgt, tmask), (first.rotation, first.translation, first.scale)


def test_warm_started_icp_matches_jax(rng):
    # The rotation gate is off here: see test_rotation_gate_is_a_float32_knife_edge.
    args, init = _warm_case(rng)
    cfg = KSSICPConfig(rotation_epsilon=-1.0)
    _assert_same(_torch_icp(*args, cfg, 30, init), _jax_icp(*args, cfg, 30, init))


def test_rotation_gate_is_a_float32_knife_edge(rng):
    """PCL's rotation test, (1 - cos) < 1e-10 with cos = (trace(dR) - 1) / 2,
    holds in float32 only once trace(dR) rounds to 3.0 or above, so the
    iteration where it first holds depends on the last bit of the 3x3 SVD,
    which differs between LAPACK and XLA. On this case one lane stops one
    iteration earlier than in JAX; every lane still lands on the same pose."""
    args, init = _warm_case(rng)
    cfg = KSSICPConfig()
    got, want = _torch_icp(*args, cfg, 30, init), _jax_icp(*args, cfg, 30, init)
    delta = got.iterations.numpy() - np.asarray(want.iterations)
    assert np.abs(delta).max() <= 1
    assert np.asarray(got.converged).all() and np.asarray(want.converged).all()
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(want.rotation), atol=1e-4)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation), atol=1e-4)


def test_zero_iterations_evaluates_fitness_only(rng):
    src, smask, tgt, tmask = _lanes(rng, lanes=2)
    cfg = KSSICPConfig()
    want = _jax_icp(src, smask, tgt, tmask, cfg, 0)
    got = _torch_icp(src, smask, tgt, tmask, cfg, 0)
    assert not got.iterations.any()
    _assert_same(got, want)


# --- point-to-plane (icp_variant="point_to_plane") ---

def _plane_step_inputs(rng, lanes=3, n=96):
    src = random_cloud(rng, n).astype(np.float32)
    tgt = np.stack([src + rng.normal(0, 0.02, size=src.shape) for _ in range(lanes)]).astype(np.float32)
    src = np.stack([src] * lanes)
    normals = rng.normal(size=tgt.shape).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    w = (rng.uniform(size=(lanes, n)) > 0.2).astype(np.float32)
    return src, tgt, normals, w


def test_point_to_plane_step_matches_jax(rng):
    """R and t of each lane within 1e-5 of JAX's point_to_plane_step."""
    src, tgt, normals, w = _plane_step_inputs(rng)
    r, t = ti.point_to_plane_step(*(torch.as_tensor(x) for x in (src, tgt, normals, w)))
    for lane in range(src.shape[0]):
        rj, tj = ji.point_to_plane_step(*(jnp.asarray(x[lane]) for x in (src, tgt, normals, w)))
        np.testing.assert_allclose(r[lane].numpy(), np.asarray(rj), atol=1e-5)
        np.testing.assert_allclose(t[lane].numpy(), np.asarray(tj), atol=1e-5)
    # Rodrigues: the identity below 1e-12 rad, JAX's rotation above it.
    omega = np.float32([[0, 0, 0], [1e-13, 0, 0], [0.1, -0.2, 0.3]])
    want = np.stack([np.asarray(ji._rodrigues(jnp.asarray(o))) for o in omega])
    np.testing.assert_allclose(ti._rodrigues(torch.as_tensor(omega)).numpy(), want, atol=1e-6)


def test_point_to_plane_step_ignores_the_normals_sign(rng):
    """Negating a normal negates its row of A and its residual: AᵀA and Aᵀb,
    and so R and t, keep their bits, so unoriented PCA normals do."""
    src, tgt, normals, w = _plane_step_inputs(rng)
    flip = np.where(rng.uniform(size=normals.shape[:2] + (1,)) < 0.5, -1.0, 1.0).astype(np.float32)
    a = ti.point_to_plane_step(*(torch.as_tensor(x) for x in (src, tgt, normals, w)))
    b = ti.point_to_plane_step(*(torch.as_tensor(x) for x in (src, tgt, normals * flip, w)))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("scale", [False, True])
def test_point_to_plane_lanes_match_jax(rng, scale):
    """Point-to-plane lanes against the target's PCA normals: per-lane
    iterations equal, the pose within 1e-4. With estimate_scale the step is
    still point-to-plane and solves no scale, as JAX's `if variant ... elif
    estimate_scale` does."""
    from kss_icp_tpu.ops.normals import estimate_normals

    src, smask, tgt, tmask = _lanes(rng)
    normals = np.array(estimate_normals(jnp.asarray(tgt), jnp.asarray(tmask)))
    cfg = KSSICPConfig()
    params = ji.ICPParams.from_config(cfg, jnp.float32)._replace(max_iterations=jnp.asarray(30, jnp.int32))
    f = jax.vmap(lambda s: ji.icp(s, jnp.asarray(smask), jnp.asarray(tgt), jnp.asarray(tmask), params,
                                  variant="point_to_plane", target_normals=jnp.asarray(normals),
                                  estimate_scale=scale))
    want = f(jnp.asarray(src))
    got = ti.icp(*(torch.as_tensor(x) for x in (src, smask, tgt, tmask)),
                 ti.ICPParams.from_config(from_reference(cfg))._replace(max_iterations=30),
                 variant="point_to_plane", target_normals=torch.as_tensor(normals), estimate_scale=scale)
    _assert_same(got, want)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation), atol=1e-4)
    np.testing.assert_array_equal(got.scale.numpy(), np.ones(src.shape[0], np.float32))
    np.testing.assert_allclose(got.fitness.numpy(), np.asarray(want.fitness), rtol=1e-4)
    with pytest.raises(ValueError, match="target_normals"):
        ti.icp(*(torch.as_tensor(x) for x in (src, smask, tgt, tmask)), ti.ICPParams.from_config(from_reference(cfg)),
               variant="point_to_plane")


# --- the card's Kabsch solve (ops/icp_cuda.py::svd3_jacobi) and the CPU dispatch ---

def _rotation(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.sign(np.linalg.det(q))


def _svd_case(case, rng, n=64):
    """(n, 3, 3) float64 H of one kind, and whether Kabsch's R is unique there."""
    if case == "random":
        return rng.normal(size=(n, 3, 3)), True
    if case == "reflected":  # det(H) < 0: the sign fix flips the smallest singular direction
        h = rng.normal(size=(n, 3, 3))
        return np.where(np.linalg.det(h)[:, None, None] < 0, h, h * np.array([1.0, 1.0, -1.0])), True
    if case == "planar":  # rank 2: coplanar points; u3 and v3 come from the cross products
        return np.einsum("nik,njk->nij", rng.normal(size=(n, 3, 2)), rng.normal(size=(n, 3, 2))), True
    if case == "collinear":  # rank 1: any proper rotation that aligns the one direction is optimal
        return np.einsum("ni,nj->nij", rng.normal(size=(n, 3)), rng.normal(size=(n, 3))), False
    if case == "zero":
        return np.zeros((n, 3, 3)), False
    if case == "repeated":  # sigma (2, 1, 1) and (1, 1, 1), det > 0: the polar factor is unique
        sig = np.where(np.arange(n)[:, None] % 2 == 0, [2.0, 1.0, 1.0], [1.0, 1.0, 1.0])
        u, v = (np.stack([_rotation(rng) for _ in range(n)]) for _ in range(2))
        return np.einsum("nij,nj,nkj->nik", u, sig, v), True
    raise ValueError(case)


@pytest.mark.parametrize("case", ["random", "reflected", "planar", "collinear", "zero", "repeated"])
def test_svd3_jacobi_matches_torch_svd_kabsch(rng, case):
    """The kernel's float64 Jacobi solve: R proper and orthonormal to 1e-12
    everywhere, within 1e-10 of torch.linalg.svd's Kabsch rotation and its
    Umeyama trace wherever the SVD decides R, and R = I at H = 0."""
    from kss_icp_torch.ops.icp_cuda import svd3_jacobi

    h, unique = _svd_case(case, rng)
    h = torch.as_tensor(h, dtype=torch.float64)
    r, trace_ds = svd3_jacobi(h)
    eye = torch.eye(3, dtype=torch.float64)
    assert float((r @ r.transpose(-1, -2) - eye).abs().max()) <= 1e-12
    assert float((torch.linalg.det(r) - 1.0).abs().max()) <= 1e-12
    u, sv, vh = torch.linalg.svd(h)
    det = torch.linalg.det(vh.transpose(-1, -2) @ u.transpose(-1, -2))
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    want = (vh.transpose(-1, -2) * d[..., None, :]) @ u.transpose(-1, -2)
    if case == "zero":
        assert torch.equal(r, eye.expand_as(r)) and not trace_ds.any()
    if unique:
        assert float((r - want).abs().max()) <= 1e-10
        np.testing.assert_allclose(trace_ds.numpy(), (sv * d).sum(-1).numpy(), rtol=1e-10, atol=1e-12)
    if case == "collinear":  # R still turns the source's one direction onto the target's
        np.testing.assert_allclose((r @ u[..., :, 0, None])[..., 0].numpy(), vh[..., 0, :].numpy(), atol=1e-10)


def test_icp_on_the_cpu_runs_the_plain_step(rng):
    """On CPU tensors icp steps through icp_update_plain: no fused step is
    counted, and icp_update routes CPU tensors to the plain version, whose
    answer it returns unchanged."""
    from kss_icp_torch.ops.icp_cuda import ICPState, icp_update, icp_update_plain, positions
    from kss_icp_torch.ops.nn_cuda import nn1

    src, smask, tgt, tmask = _lanes(rng, lanes=3)
    cfg = KSSICPConfig()
    before, steps = ti.icp.fused_steps, ti.icp.lockstep_iterations
    got = _torch_icp(src, smask, tgt, tmask, cfg, 10)
    assert ti.icp.fused_steps == before and ti.icp.lockstep_iterations > steps
    assert int(got.iterations.max()) > 0
    params = ti.ICPParams.from_config(from_reference(cfg))._replace(max_iterations=10)
    source = torch.as_tensor(src)
    lanes = source.shape[0]
    state = ICPState(torch.eye(3).expand(lanes, 3, 3).clone(), torch.zeros(lanes, 3), torch.ones(lanes),
                     torch.full((lanes,), 1e30), torch.zeros(lanes, dtype=torch.int32),
                     torch.zeros(lanes, dtype=torch.bool), torch.ones(lanes, dtype=torch.bool))
    cur = positions(source, *state[:3])
    d2, idx = nn1(cur, torch.as_tensor(tgt)[None], torch.as_tensor(tmask)[None])
    args = (cur, d2, idx, source, torch.as_tensor(smask).expand(lanes, -1), torch.as_tensor(tgt)[None],
            torch.zeros(lanes, dtype=torch.int32), state, params)
    a, b = icp_update(*args), icp_update_plain(*args)
    for x, y in zip(a[0] + a[1:], b[0] + b[1:]):
        assert torch.equal(x, y)
