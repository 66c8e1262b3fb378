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
# scattered masks, also on 64 rotations; a fully masked target (the kernels'
# biased path) and source.
FIELD_CASES = [{}, {"t_valid": 40}, {"p": 256, "t": 128, "steps": 2, "s_valid": 77},
               {"p": 300, "t": 280, "s_valid": 150, "t_valid": 120}, {"scatter": True},
               {"p": 256, "t": 200, "steps": 4, "scatter": True}, {"t_valid": 0}, {"s_valid": 0}]


@pytest.mark.parametrize("kw", FIELD_CASES)
def test_field_matches_pallas_vpu_kernel(rng, kw):
    """field_ave's mean, a float64 sum rounded once (the culling kernel's
    "ave" statistic and its plain version), against JAX's Pallas "vpu"
    kernel's float32 partial sums in interpret mode: within rtol 2e-5,
    no absolute slack."""
    got, want = _field_case(rng, **kw)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=0.0)


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


# The K layout of csrc/field_dot.cu at "highest": each float32 operand split
# into three bf16 parts, x = hi + mid + lo; lane t of a quad carries
# coordinate t, in words of two bf16 values.
BF16 = ml_dtypes.bfloat16
SPLIT_MIN_EXP, SPLIT_MAX_EXP = -110, 126  # hi + mid + lo == x for 2^-110 <= |x| < 2^127


def _split3(x: np.ndarray):
    """csrc/field_dot.cu::split3 in numpy: hi = rn_bf16(x), mid = rn_bf16(x - hi),
    lo = x - hi - mid (float32, each remainder exact), as float32 arrays."""
    x = np.asarray(x, np.float32)
    hi = x.astype(BF16).astype(np.float32)
    r = (x - hi).astype(np.float32)
    mid = r.astype(BF16).astype(np.float32)
    return hi, mid, (r - mid).astype(np.float32)


@pytest.mark.parametrize("lo_exp, hi_exp", [(SPLIT_MIN_EXP, -100), (-100, -60), (-60, -20), (-20, -1), (-1, 1),
                                            (1, 20), (20, 60), (60, 100), (100, SPLIT_MAX_EXP + 1)])
def test_bf16_split_is_exact(lo_exp, hi_exp):
    """hi + mid + lo == x bit for bit and lo is a bf16 value (the kernel
    rounds it to bf16 when it packs it), for float32 values of both signs
    with exponents in [lo_exp, hi_exp): the fields see |x| from about 1e-8
    (coincident points' squares) to 1e30 (a masked row's |t|², in the last
    band). Below 2^-110 lo is subnormal in bf16; from 2^127 hi rounds to inf."""
    rng = np.random.default_rng(lo_exp + 200)
    x = (rng.uniform(1, 2, 20000) * 2.0 ** rng.integers(lo_exp, hi_exp, 20000)).astype(np.float32)
    x = np.concatenate([x, -x, np.float32([0.0, 1.0, -2.0, 1e30, -1e30])]).astype(np.float32)
    hi, mid, lo = _split3(x)
    np.testing.assert_array_equal(lo.astype(BF16).astype(np.float32), lo)
    np.testing.assert_array_equal(((hi.astype(np.float64) + mid) + lo).astype(np.float32), x)
    assert (np.abs(mid) <= 2.0 ** -8 * np.abs(x)).all() and (np.abs(lo) <= 2.0 ** -16 * np.abs(x)).all()


# (source word, target word, accumulator) of each product a tile takes, as
# csrc/field_dot.cu's scan takes them: at "highest" the head hh and the tail
# hm + mh, hl + mm, lh; at "default" one product.
DOT_PRODUCTS_OF = {3: [(0, 0, "head"), (1, 1, "tail"), (1, 2, "tail"), (2, 0, "tail")], 1: [(0, 0, "head")]}


def _k_words(x, source: bool, steps: int) -> np.ndarray:
    """(..., steps, 2) float32: the bf16 pairs (lower, upper) of one operand
    coordinate in each word, as csrc/field_dot.cu::words packs them."""
    z = np.zeros_like(np.asarray(x, np.float32))
    if steps == 1:
        return np.stack([np.asarray(x, np.float32).astype(BF16).astype(np.float32), z], -1)[..., None, :]
    h, m, lo = _split3(x)
    pairs = [(h, z), (h, m), (lo, z)] if source else [(h, z), (m, h), (lo, m)]
    return np.stack([np.stack(p, -1) for p in pairs], -2)


def _kernel_rel(q: np.ndarray, a: np.ndarray, steps: int) -> np.ndarray:
    """rel(p, n) = head + tail, each the sum over its products of the 8
    columns of one word (4 coordinates x 2 bf16 values; bf16 products are
    exact in float64), with the target's words stored at
    csrc/field_dot.cu::word_at and read back as the m16n8k8 B fragment
    reads them (lane 4 (n % 8) + t holds column pair t of row n), and the
    source's column k of a word coordinate k // 2's value k % 2."""
    rows = a.shape[0]
    padded = -(-rows // 64) * 64
    staged = np.zeros((padded * 4 * steps, 2))  # words (two bf16 values each)
    aw = _k_words(np.concatenate([a, np.repeat(a[:1], padded - rows, 0)]), False, steps)  # (n, 4, steps, 2)
    for n in range(padded):
        for t in range(4):
            for m in range(steps):
                staged[((n >> 3) * 32 + (n & 7) * 4 + t) * steps + m] = aw[n, t, m]
    qw = _k_words(np.concatenate([q, np.ones((len(q), 1), np.float32)], 1), True, steps)  # (p, 4, steps, 2)
    n_idx = np.arange(padded)
    acc = {"head": 0.0, "tail": 0.0}
    for sw, tw, name in DOT_PRODUCTS_OF[steps]:
        A = np.stack([qw[:, k // 2, sw, k % 2] for k in range(8)], 1).astype(np.float64)  # (p, 8)
        B = np.stack([staged[((n_idx >> 3) * 32 + (n_idx & 7) * 4 + k // 2) * steps + tw, k % 2] for k in range(8)])
        acc[name] = acc[name] + A @ B
    return (acc["head"] + acc["tail"])[:, :rows]


@pytest.mark.parametrize("case", ["wavy clouds", "coincident points", "masked rows"])
def test_six_product_sum_is_within_its_bound_of_the_float32_expansion(case):
    """The kernel's word layout, read back as its products read it, gives
    the six-product sum hh + hm + mh + hl + mm + lh of each coordinate
    (emulated in float64), which is within 2^-20 x sum_i |q_i a_i| of the
    plain version's float32 expansion ((qx ax + qy ay) + qz az) + aw: the
    dropped products are below 2^-23 |q_i a_i|, the expansion's own rounding
    below 2^-22 of the same sum. A masked row (1e30) comes through whole. At
    "default" the layout gives the bf16 operands' exact products."""
    rng = np.random.default_rng(30)
    src, tgt = random_cloud(rng, 40).astype(np.float32), random_cloud(rng, 70).astype(np.float32)
    if case == "coincident points":
        tgt[:40] = src
    tmask = np.ones(70, bool)
    if case == "masked rows":
        tmask[::3] = False
    rots = np.asarray(t_euler(tc.rotation_grid(2, 6.3)))
    f32 = np.float32
    q = ((rots[3, None, :, 0] * src[:, 0, None] + rots[3, None, :, 1] * src[:, 1, None])
         + rots[3, None, :, 2] * src[:, 2, None]).astype(f32)  # rotate_points' order
    t2 = np.where(tmask, (tgt[:, 0] * tgt[:, 0] + tgt[:, 1] * tgt[:, 1]) + tgt[:, 2] * tgt[:, 2], f32(1e30))
    a = np.concatenate([(f32(-2.0) * tgt) * tmask[:, None].astype(f32), t2[:, None]], 1).astype(f32)
    qa = np.concatenate([q, np.ones((len(q), 1), f32)], 1)
    expansion = ((q[:, None, 0] * a[:, 0] + q[:, None, 1] * a[:, 1]) + q[:, None, 2] * a[:, 2]) + a[:, 3]
    scale = np.abs(qa[:, None, :].astype(np.float64) * a[None]).sum(-1)
    six = _kernel_rel(q, a, 3)
    assert (np.abs(six - expansion) <= 2.0 ** -20 * scale).all()
    assert (np.abs(six - qa.astype(np.float64) @ a.T.astype(np.float64)) <= 2.0 ** -23 * scale).all()
    assert (six[:, ~tmask] == np.float64(f32(1e30))).all()
    one = _kernel_rel(q, a, 1)
    qb, ab = qa.astype(BF16).astype(np.float64), a.astype(BF16).astype(np.float64)
    np.testing.assert_array_equal(one, qb @ ab.T)


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
    """The "max" and "diff" fields, once refused, now held to JAX's XLA
    field (kss_icp_tpu/models/coarse.py:113-131, its expansion form; the
    port's exact differences) at rtol 1e-5, atol 1e-6, with the same
    candidates on clouds without near ties; an unknown metric still raises.
    ("trim" is tests/test_torch_overlap.py's.)"""
    src, smask, tgt, tmask, _ = _clouds(rng, p=150, t=120, t_valid=110, s_valid=140)
    for metric in ("max", "diff"):
        want = jc.coarse_align(*(jnp.asarray(x) for x in (src, smask, tgt, tmask)), steps=4, max_candidates=5,
                               backend="xla", error_metric=metric)
        got = tc.coarse_align(*(torch.as_tensor(x) for x in (src, smask, tgt, tmask)), steps=4, max_candidates=5,
                              error_metric=metric, method="dot")  # the method means nothing here, as in JAX
        np.testing.assert_allclose(got.field.numpy(), np.asarray(want.field), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got.candidate_mask.numpy(), np.asarray(want.candidate_mask))
        np.testing.assert_allclose(got.candidate_angles.numpy(), np.asarray(want.candidate_angles), atol=1e-6)
    x = torch.zeros((4, 3))
    m = torch.ones((4,), dtype=torch.bool)
    with pytest.raises(ValueError):
        tc.score_rotation_field(x, m, x, m, steps=2, error_metric="no such metric")
