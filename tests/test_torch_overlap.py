"""The port's overlap tier against the JAX package on the same inputs, at tiny
sizes: the trimmed statistics (kss_icp_torch/ops/nn.py), the trimmed scaled
ICP (models/icp.py), the trimmed field and its `field_trim` plain version
(models/coarse.py, ops/coarse_cuda.py), the overlap solvers and
register_pair's ladder (models/kss_icp.py)."""

import contextlib
import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kss_icp_torch.ladder_log import RungLog
from helpers import random_cloud
import kss_icp_torch.models.icp
import kss_icp_tpu.models.icp
from kss_icp_torch.challenge import partial_corpus
from kss_icp_torch.config import from_reference
from kss_icp_torch.core.transforms import Similarity as TSim
from kss_icp_torch.models import coarse as tc
from kss_icp_torch.models import kss_icp as tk
from kss_icp_torch.ops import coarse_cuda
from kss_icp_torch.ops import nn as tn
from kss_icp_tpu.config import KSSICPConfig
from kss_icp_tpu.core.transforms import Similarity as JSim
from kss_icp_tpu.core.transforms import euler_xyz_matrix
from kss_icp_tpu.models import coarse as jc
from kss_icp_tpu.models import kss_icp as jk
from kss_icp_tpu.ops import nn as jn

torch.set_num_threads(1)
# The packages' models/__init__ re-export the function `icp` over the module name.
ti = sys.modules["kss_icp_torch.models.icp"]
ji = sys.modules["kss_icp_tpu.models.icp"]


def _t(*xs):
    return [torch.as_tensor(np.array(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


# --- trimmed statistics ---

@pytest.mark.parametrize("n, masked", [(40, 0), (1000, 123), (257, 256), (64, 64)])
def test_trimmed_masked_mean_matches_jax(rng, n, masked):
    values = rng.uniform(0, 2, size=(3, n)).astype(np.float32)
    mask = np.ones((3, n), bool)
    mask[1, rng.permutation(n)[:masked]] = False  # scattered
    mask[2, n - masked:] = False                  # a padded tail
    for q in (0.7, 0.5, 1.0):
        want = np.asarray(jn.trimmed_masked_mean(*_j(values, mask), q))
        got = tn.trimmed_masked_mean(*_t(values, mask), q).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_trimmed_masked_mean_refuses_wide_rows():
    with pytest.raises(ValueError, match="8192"):
        tn.trimmed_masked_mean(torch.zeros(8192), torch.ones(8192, dtype=torch.bool), 0.7)


def _clouds(rng, n=96, t=128, tail=7):
    src = random_cloud(rng, n).astype(np.float32)
    tgt = (random_cloud(rng, t) + 0.05).astype(np.float32)
    smask, tmask = np.ones(n, bool), np.ones(t, bool)
    smask[rng.permutation(n)[:11]] = False
    tmask[t - tail:] = False
    return src, smask, tgt, tmask


@pytest.mark.parametrize("metric", ["trim", "ave"])
def test_masked_nn_error_matches_jax(rng, metric):
    src, smask, tgt, tmask = _clouds(rng)
    want = float(jn.masked_nn_error(*_j(src, smask, tgt, tmask), metric=metric, trim_fraction=0.7))
    got = float(tn.masked_nn_error(*_t(src, smask, tgt, tmask), metric=metric, trim_fraction=0.7))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("metric", ["max", "diff"])
def test_masked_nn_error_unported_metrics_raise(rng, metric):
    """Once refused, "max" (the largest squared 1-NN distance) and "diff"
    (the largest distance less the mean) now match JAX's (its expansion
    form, the port's exact differences) at rtol 1e-5, atol 1e-6, one row and
    a batch of rows."""
    src, smask, tgt, tmask = _clouds(rng)
    want = float(jn.masked_nn_error(*_j(src, smask, tgt, tmask), metric=metric))
    got = float(tn.masked_nn_error(*_t(src, smask, tgt, tmask), metric=metric))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    rows = np.stack([src, src * 1.1, src[::-1]])
    want = np.asarray(jn.masked_nn_error(*_j(rows, smask[None], tgt[None], tmask[None]), metric=metric))
    got = tn.masked_nn_error(*_t(rows, smask, tgt, tmask), metric=metric).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# --- trimmed, scaled ICP ---

def test_kabsch_with_scale_matches_jax(rng):
    a = random_cloud(rng, 64).astype(np.float32)
    r = np.asarray(euler_xyz_matrix(jnp.asarray([0.3, -0.2, 1.1], jnp.float32)))
    b = (1.7 * a @ r.T + np.array([0.1, -0.3, 0.2]) + rng.normal(0, 0.01, size=a.shape)).astype(np.float32)
    w = (rng.uniform(size=64) > 0.2).astype(np.float32)
    r_j, t_j, s_j = ji.kabsch(*_j(a, b, w), estimate_scale=True)
    r_t, t_t, s_t = ti.kabsch(*(x[None] for x in _t(a, b, w)), estimate_scale=True)
    np.testing.assert_allclose(r_t[0].numpy(), np.asarray(r_j), atol=1e-5)
    np.testing.assert_allclose(t_t[0].numpy(), np.asarray(t_j), atol=1e-5)
    np.testing.assert_allclose(float(s_t[0]), float(s_j), atol=1e-5)
    assert abs(float(s_t[0]) - 1.7) < 0.02


def _icp_lanes(rng, lanes=4, n=128, t=160):
    tgt = random_cloud(rng, t).astype(np.float32)
    base = (tgt[rng.permutation(t)[:n]] + rng.normal(0, 0.01, size=(n, 3))).astype(np.float32)
    base[: n // 5] += 0.4  # a fifth of the source has no counterpart: the trim's work
    angles = rng.uniform(-0.3, 0.3, size=(lanes, 3)).astype(np.float32)
    r = np.asarray(euler_xyz_matrix(jnp.asarray(angles)))
    scale = rng.uniform(0.85, 1.15, size=(lanes, 1, 1))
    src = (scale * np.einsum("lij,nj->lni", r, base) + rng.uniform(-0.1, 0.1, size=(lanes, 1, 3))).astype(np.float32)
    smask, tmask = np.ones((n,), bool), np.ones((t,), bool)
    smask[n - 9:] = False
    tmask[t - 7:] = False
    return src, smask, tgt, tmask


@pytest.mark.parametrize("max_iterations, trim, scale", [(30, 0.7, True), (4, 0.7, True), (30, 0.7, False),
                                                          (30, 0.0, True)])
def test_trimmed_scaled_icp_matches_jax(rng, max_iterations, trim, scale):
    src, smask, tgt, tmask = _icp_lanes(rng)
    cfg = KSSICPConfig(rotation_epsilon=-1.0)  # the rotation gate's knife edge: tests/test_torch_icp.py
    params = ji.ICPParams.from_config(cfg, jnp.float32)._replace(max_iterations=jnp.asarray(max_iterations))
    want = jax_vmap_icp(src, smask, tgt, tmask, params, trim, scale)
    got = ti.icp(*_t(src, smask, tgt, tmask), ti.ICPParams.from_config(from_reference(cfg))._replace(
        max_iterations=max_iterations), trim_fraction=trim, estimate_scale=scale)
    np.testing.assert_array_equal(got.iterations.numpy(), np.asarray(want.iterations))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(want.rotation), atol=1e-5)
    np.testing.assert_allclose(got.translation.numpy(), np.asarray(want.translation), atol=1e-5)
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale), atol=1e-5)
    np.testing.assert_allclose(got.fitness.numpy(), np.asarray(want.fitness), rtol=1e-4, atol=1e-7)


def jax_vmap_icp(src, smask, tgt, tmask, params, trim, scale):
    import jax

    f = jax.vmap(lambda s: ji.icp(s, *_j(smask, tgt, tmask), params, trim_fraction=trim, estimate_scale=scale))
    return f(jnp.asarray(src))


# --- the trimmed field ---

def _field_clouds(rng, case):
    """Padded, scattered or fully masked clouds at the field's tiny sizes."""
    src = random_cloud(rng, 80).astype(np.float32)
    tgt = random_cloud(rng, 96).astype(np.float32)
    smask, tmask = np.ones(80, bool), np.ones(96, bool)
    if case == "padded":
        smask[60:], tmask[70:] = False, False
    elif case == "scattered":
        smask[rng.permutation(80)[:24]] = False
        tmask[rng.permutation(96)[:30]] = False
    elif case == "no target":
        tmask[:] = False
    return src, smask, tgt, tmask


@pytest.mark.parametrize("case", ["padded", "scattered", "no target"])
def test_trimmed_field_matches_jax_xla(rng, case):
    src, smask, tgt, tmask = _field_clouds(rng, case)
    want = np.asarray(jc.score_rotation_field(*_j(src, smask, tgt, tmask), steps=4, backend="xla",
                                              error_metric="trim", trim_fraction=0.7))
    got = tc.score_rotation_field(*_t(src, smask, tgt, tmask), steps=4, error_metric="trim", trim_fraction=0.7)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5)
    if case != "no target":
        jr = jc.coarse_align(*_j(src, smask, tgt, tmask), steps=4, max_candidates=6, backend="xla",
                             error_metric="trim", trim_fraction=0.7)
        tr = tc.coarse_align(*_t(src, smask, tgt, tmask), steps=4, max_candidates=6, error_metric="trim",
                             trim_fraction=0.7)
        np.testing.assert_array_equal(tr.candidate_mask.numpy(), np.asarray(jr.candidate_mask))
        np.testing.assert_allclose(tr.candidate_angles.numpy(), np.asarray(jr.candidate_angles), atol=1e-6)


@pytest.mark.parametrize("case", ["padded", "scattered", "no target"])
def test_field_trim_plain_version_matches_jax(rng, case):
    src, smask, tgt, tmask = _field_clouds(rng, case)
    rots = np.asarray(euler_xyz_matrix(jc.rotation_grid(3, 6.3, jnp.float32)))
    want = np.asarray(jc.score_rotation_field(*_j(src, smask, tgt, tmask), steps=3, backend="xla",
                                              error_metric="trim", trim_fraction=0.6)).reshape(-1)
    args = _t(src, smask, tgt, tmask, rots)
    got = coarse_cuda.field_trim(*args, trim_fraction=0.6)
    assert torch.equal(got, coarse_cuda.field_trim_plain(*args, trim_fraction=0.6))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5)
    # The per-point values: 0 at masked source points, 1e15 against a fully masked target.
    d = tn.nn_distances(coarse_cuda.rotate_sources(args[4], args[0]), *args[1:4])
    assert d.shape == (27, 80) and not d[:, ~args[1]].any()
    if case == "no target":
        assert torch.all(d[:, args[1]] == 1e15)


@pytest.mark.parametrize("case", ["padded", "scattered", "no target"])
def test_coarse_metrics_max_and_diff_still_raise(rng, case):
    """Once refused, the "max" and "diff" fields now match JAX's XLA field
    (rtol 1e-5, atol 1e-6) through `field_sq`, whose CPU path is its plain
    version; the per-point squared distances are 0 at a masked source point
    and 1e30 against a fully masked target, where "diff" is the float32
    rounding of 1e15 less its mean and not compared."""
    src, smask, tgt, tmask = _field_clouds(rng, case)
    rots = np.asarray(euler_xyz_matrix(jc.rotation_grid(3, 6.3, jnp.float32)))
    args = _t(src, smask, tgt, tmask, rots)
    for metric in ("max", "diff") if case != "no target" else ("max",):
        want = np.asarray(jc.score_rotation_field(*_j(src, smask, tgt, tmask), steps=3, backend="xla",
                                                  error_metric=metric)).reshape(-1)
        got = coarse_cuda.field_sq(*args, metric)
        assert torch.equal(got, coarse_cuda.SQ_PLAIN[metric](*args))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    d2 = tn.nn_sqdistances(coarse_cuda.rotate_sources(args[4], args[0]), *args[1:4])
    assert d2.shape == (27, 80) and not d2[:, ~args[1]].any()
    if case == "no target":
        assert torch.all(d2[:, args[1]] == 1e30)


# --- the overlap solvers ---

TINY = KSSICPConfig(rotation_steps=4, max_candidates=4, max_resample_points=160, resample_pad=192,
                    max_icp_iterations=12, rotation_chunk=16, screen_points=64, refine_candidates=2,
                    escalate_rotation_steps=5, escalate_max_candidates=5, escalate_coarse_points=64,
                    escalate_coarse_target_points=64, overlap_screen_steps=4, overlap_screen_iters=4,
                    overlap_iterations=2)


def _partial_pair(index):
    """A pair of the partial board (5000-point clouds), resampled by both
    packages' FPS to TINY's size: the same clouds bit for bit."""
    name, src, tgt, gt = partial_corpus(n_points=1500)[index]
    pn = TINY.resample_count(len(src), len(tgt))
    clouds = []
    for pts in (src, tgt):
        p, m = jk.resample_batch(jnp.asarray(pts)[None], jnp.ones((1, len(pts)), bool), jnp.asarray([pn]), TINY)
        clouds += [np.asarray(p[0]), np.asarray(m[0])]
    return name, clouds


PAIRS = [0, 3]


@pytest.mark.parametrize("index", PAIRS)
def test_trimmed_fitness_matches_jax(index):
    _, (sp, sm, tp, tmk) = _partial_pair(index)
    rot = np.asarray(euler_xyz_matrix(jnp.asarray([0.2, -0.4, 0.1], jnp.float32)))
    sim = (np.float32(1.1), rot, np.array([0.03, -0.02, 0.01], np.float32))
    for bidirectional in (True, False):
        want = float(jk.trimmed_fitness(JSim(*_j(*sim)), *_j(sp, sm, tp, tmk), 0.7, bidirectional))
        got = float(tk.trimmed_fitness(TSim(*_t(*sim)), *_t(sp, sm, tp, tmk), 0.7, bidirectional))
        np.testing.assert_allclose(got, want, rtol=1e-5)


def _same_solve(got, want, atol=1e-4):
    assert int(got.chosen_candidate) == int(want.chosen_candidate)
    np.testing.assert_allclose(float(got.fitness), float(want.fitness), rtol=1e-3)
    for f in ("scale", "rotation", "translation"):
        np.testing.assert_allclose(getattr(got.transform, f).numpy(), np.asarray(getattr(want.transform, f)),
                                   atol=atol)


@pytest.mark.parametrize("index", PAIRS)
def test_register_overlap_resampled_matches_jax(index):
    _, clouds = _partial_pair(index)
    want = jk.register_overlap_resampled(*_j(*clouds), TINY)
    got = tk.register_overlap_resampled(*_t(*clouds), from_reference(TINY))
    _same_solve(got, want)
    np.testing.assert_allclose(got.coarse.candidate_angles.numpy(), np.asarray(want.coarse.candidate_angles),
                               atol=1e-6)


@pytest.mark.parametrize("index", PAIRS)
def test_register_overlap_screen_resampled_matches_jax(index):
    _, clouds = _partial_pair(index)
    want = jk.register_overlap_screen_resampled(*_j(*clouds), TINY)
    got = tk.register_overlap_screen_resampled(*_t(*clouds), from_reference(TINY))
    # The same top set, in order, and the same chosen lane.
    np.testing.assert_allclose(got.coarse.candidate_angles.numpy(), np.asarray(want.coarse.candidate_angles),
                               atol=1e-6)
    _same_solve(got, want)
    assert int(got.icp_iterations) == int(want.icp_iterations)


def test_screen_answers_do_not_depend_on_the_batch_knob():
    _, clouds = _partial_pair(0)
    a = tk.register_overlap_screen_resampled(*_t(*clouds), from_reference(TINY))
    b = tk.register_overlap_screen_resampled(*_t(*clouds), from_reference(dataclasses.replace(TINY,
                                                                                              overlap_screen_batch=3)))
    assert torch.equal(a.transform.rotation, b.transform.rotation) and torch.equal(a.fitness, b.fitness)


# --- the ladder in register_pair ---

LADDER = dataclasses.replace(TINY, escalate_threshold=1e-9, overlap_threshold=1e-9)
# (partial pair, knobs, JAX's rungs): at these sizes no rung clears the
# shipped 0.7 margin, so a looser one shows adoption, and a low gate ratio
# the crop-signature skip.
LADDER_CASES = [
    (0, {}, ["ran", "ran", "ran"]),
    (2, dict(overlap_adopt_margin=0.8), ["adopted", "ran", "ran"]),
    (7, dict(overlap_adopt_margin=0.8), ["ran", "adopted", "ran"]),
    (7, dict(overlap_adopt_margin=0.8, overlap_gate_ratio=0.5), ["skipped", "skipped", "skipped"]),
]


@pytest.mark.parametrize("index, knobs, rungs", LADDER_CASES)
def test_register_pair_ladder_matches_jax(index, knobs, rungs):
    """Every rung reached, skipped, run and adopted as in JAX, and the same pose."""
    cfg = dataclasses.replace(LADDER, **knobs)
    name, src, tgt, _ = partial_corpus(n_points=1500)[index]
    with RungLog(jk, cfg.overlap_adopt_margin) as jr_rungs:
        jr = jk.register_pair(src, tgt, cfg)
    stages = []
    with RungLog(tk, cfg.overlap_adopt_margin) as tr_rungs:
        tr = tk.register_pair(src, tgt, from_reference(cfg), device="cpu",
                              timer=lambda s: stages.append(s) or contextlib.nullcontext())
    assert jr_rungs.outcomes() == rungs and tr_rungs.outcomes() == rungs

    def fits(log):
        return np.array([[r["tf_old"], r["tf_new"]] for r in log.rungs], dtype=float)

    np.testing.assert_allclose(fits(tr_rungs), fits(jr_rungs), rtol=1e-3)
    ran = [s for s, o in zip(("overlap8", "overlap16", "overlap_screen"), rungs) if o != "skipped"]
    assert [s for s in stages if s.startswith("overlap")] == ran
    _same_solve(tr, jr)


@pytest.mark.parametrize("as_cli", [False, True])
def test_overlap_mode_matches_jax(as_cli):
    """overlap_mode=True on its own, and as the JAX CLI's --overlap sets it
    (cfg.overlap_config(): the trimmed field and ICP)."""
    name, src, tgt, _ = partial_corpus(n_points=1500)[0]
    cfg = TINY.overlap_config() if as_cli else dataclasses.replace(TINY, overlap_mode=True)
    jr = jk.register_pair(src, tgt, cfg)
    tr = tk.register_pair(src, tgt, from_reference(cfg), device="cpu")
    _same_solve(tr, jr)
