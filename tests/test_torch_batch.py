"""The port's batched path against the JAX package on the CPU, at tiny sizes:
`icp` with a target a lane (kss_icp_torch/models/icp.py), `register_batch`
(models/kss_icp.py, JAX's vmapped register_resampled), `register_many` and
its escalation and overlap ladder (parallel/batch.py, escalate.py), and the
batched metric (metrics.py). Each JAX run sits in a module-scoped fixture.

The register_batch pairs are remesh fixture pairs whose chosen lanes differ
(Buddhag's winner is lane 1 or 2, the others' lane 0), so a gather that took
a pair's winner from another pair's row would show; like the single-pair
tests (tests/test_torch_pipeline.py), they avoid the pairs whose lanes are
near-tied at these sizes (ROADMAP.md queue 3)."""

import dataclasses
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kss_icp_torch as kt
import kss_icp_torch.escalate as te
import kss_icp_torch.models.icp  # noqa: F401  (the module, behind models/__init__'s `icp`)
import kss_icp_tpu.escalate as je
from kss_icp_torch.ladder_log import LadderLog, RungLog
from helpers import random_cloud
from kss_icp_torch.challenge import partial_corpus
from kss_icp_torch.config import from_reference
from kss_icp_torch.core.transforms import Similarity as TSim
from kss_icp_torch.core.transforms import euler_xyz_matrix
from kss_icp_torch.metrics import registration_measure_padded
from kss_icp_torch.models import kss_icp as tk
from kss_icp_torch.parallel import batch as tb
from kss_icp_tpu.config import KSSICPConfig
from kss_icp_tpu.core.transforms import Similarity as JSim
from kss_icp_tpu.models import kss_icp as jk
from kss_icp_tpu.parallel import batch as jb

torch.set_num_threads(1)
ti = sys.modules["kss_icp_torch.models.icp"]

FIXTURES = Path(__file__).resolve().parents[1] / "fixtures"
TINY = KSSICPConfig(rotation_steps=4, max_candidates=4, max_resample_points=128, resample_pad=128,
                    max_icp_iterations=8, rotation_chunk=16, auto_escalate=False)
MODES = {
    "two_phase": dataclasses.replace(TINY, screen_points=64, refine_candidates=2),
    "full": dataclasses.replace(TINY, multistart_mode="full"),
    "two_tier": dataclasses.replace(TINY, max_candidates=4, coarse_points=64, coarse_target_points=64,
                                    refine_candidates=2, refine_tier_iterations=3, refine_tier_target_points=64,
                                    refine_max_iterations=4, max_icp_iterations=20),
}
# tests/test_register_many.py:13-16.
MANY = KSSICPConfig(rotation_steps=8, max_candidates=8, max_resample_points=256, resample_pad=256,
                    max_icp_iterations=100, rotation_chunk=64, screen_points=128)
NAMES = ("Angelg", "Buddhag", "Catg", "centuarw")


def _t(*xs):
    return [torch.as_tensor(np.asarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _remesh_batch(cfg):
    """The NAMES pairs resampled by JAX's FPS, stacked: the same clouds in
    both packages."""
    with np.load(FIXTURES / "remesh_transfer.npz") as z:
        return _resampled([(np.asarray(z[n + "_src"], np.float32), np.asarray(z[n + "_tgt"], np.float32))
                           for n in NAMES], cfg)


def _resampled(pairs, cfg):
    """[(source, target)] resampled by JAX's FPS, stacked (source points,
    mask, target points, mask)."""
    rows = []
    for src, tgt in pairs:
        pn = jnp.asarray([cfg.resample_count(len(src), len(tgt))])
        row = []
        for pts in (src, tgt):
            p, m = jk.resample_batch(jnp.asarray(pts)[None], jnp.ones((1, len(pts)), bool), pn, cfg)
            row += [np.asarray(p[0]), np.asarray(m[0])]
        rows.append(row)
    return [np.stack([r[i] for r in rows]) for i in range(4)]


def _many_pairs(rng, n_pairs=4):
    """tests/test_register_many.py:19-27: rotated copies of clouds of 400-550 points."""
    pairs = []
    for i in range(n_pairs):
        tgt = random_cloud(rng, 400 + 50 * i)
        ang = 0.3 + 0.2 * i
        c, s = np.cos(ang), np.sin(ang)
        r = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        pairs.append(((tgt @ r.T).astype(np.float32), tgt.astype(np.float32)))
    return pairs


def _same_transform(got: TSim, want, atol=1e-4):
    for f in ("scale", "rotation", "translation"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)), atol=atol)


# --- icp with a target a lane ---

def test_icp_with_per_lane_targets_equals_separate_calls():
    """Three pairs' lanes in one loop against their own targets give each
    pair's separate answer bit for bit."""
    rng = np.random.default_rng(1)
    params = ti.ICPParams.from_config(from_reference(TINY))._replace(max_iterations=30)
    targets, sources, masks = [], [], []
    for k in range(3):
        tgt = random_cloud(rng, 160 + 10 * k).astype(np.float32)[:160]
        base = tgt[rng.permutation(160)[:96]] + rng.normal(0, 0.01, size=(96, 3)).astype(np.float32)
        r = euler_xyz_matrix(torch.as_tensor(rng.uniform(-0.4, 0.4, size=(4, 3)), dtype=torch.float32))
        sources.append(torch.einsum("lij,nj->lni", r, torch.as_tensor(base)) + 0.05 * k)
        targets.append(torch.as_tensor(tgt))
        m = torch.ones(160, dtype=torch.bool)
        m[150 - 10 * k:] = False
        masks.append(m)
    smask = torch.ones(96, dtype=torch.bool)
    smask[90:] = False
    for trim, scale in ((0.0, False), (0.7, True)):
        alone = [ti.icp(sources[k], smask, targets[k], masks[k], params, trim_fraction=trim, estimate_scale=scale)
                 for k in range(3)]
        lane_ref = torch.arange(3, dtype=torch.int32).repeat_interleave(4)
        both = ti.icp(torch.cat(sources), smask, torch.stack(targets), torch.stack(masks), params,
                      trim_fraction=trim, estimate_scale=scale, lane_ref=lane_ref)
        for f in both._fields:
            assert torch.equal(getattr(both, f), torch.cat([getattr(a, f) for a in alone])), f
        assert len({int(a.iterations.max()) for a in alone}) > 1  # the pairs converge in different iterations


# --- register_batch ---

@pytest.fixture(scope="module")
def batch_runs():
    """JAX's register_batch on the NAMES pairs in every mode, and the clouds."""
    out = {}
    for mode, cfg in MODES.items():
        clouds = _remesh_batch(cfg)
        out[mode] = clouds, jb.register_batch(*_j(*clouds), cfg)
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
def test_register_batch_matches_jax(batch_runs, mode):
    clouds, want = batch_runs[mode]
    got = tk.register_batch(*_t(*clouds), from_reference(MODES[mode]))
    assert got.chosen_candidate.numpy().tolist() == np.asarray(want.chosen_candidate).tolist()
    assert len(set(got.chosen_candidate.tolist())) > 1  # pairs that choose different lanes
    for f in ("icp_iterations", "refine_hit_cap", "used_multistart"):
        assert getattr(got, f).numpy().tolist() == np.asarray(getattr(want, f)).tolist(), f
    _same_transform(got.transform, want.transform)
    np.testing.assert_allclose(got.fitness.numpy(), np.asarray(want.fitness), rtol=1e-4)
    np.testing.assert_allclose(got.coarse.candidate_angles.numpy(), np.asarray(want.coarse.candidate_angles),
                               atol=1e-6)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_register_batch_rows_equal_single_pair_calls(batch_runs, mode):
    clouds, _ = batch_runs[mode]
    cfg = from_reference(MODES[mode])
    batch = tk.register_batch(*_t(*clouds), cfg)
    for b in range(len(NAMES)):
        one = tk.register_resampled(*_t(*(x[b] for x in clouds)), cfg)
        flat = te.tree_map(lambda x: x[b], batch)
        for got, want in zip(jax_free_leaves(flat), jax_free_leaves(one)):
            assert torch.equal(got, want)


def jax_free_leaves(tree):
    leaves = []
    te.tree_map(lambda x: leaves.append(x), tree)
    return leaves


# --- register_many ---

def _many(package, pairs, cfg, **kw):
    """register_many of either package, with its ladder recorded."""
    esc = je if package == "jax" else te
    with LadderLog(esc, len(pairs)) as ladder:
        if package == "jax":
            res, m = jb.register_many(pairs, cfg, **kw)
        else:
            if "escalate_cfg" in kw:
                kw["escalate_cfg"] = from_reference(kw["escalate_cfg"])
            res, m = tb.register_many(pairs, from_reference(cfg), device="cpu", **kw)
    return res, m, ladder


CRUDE = dataclasses.replace(MANY, rotation_steps=2, max_candidates=2, refine_candidates=2, screen_iterations=4,
                            max_icp_iterations=12)
LADDER = KSSICPConfig(rotation_steps=4, max_candidates=4, max_resample_points=160, resample_pad=192,
                      max_icp_iterations=12, rotation_chunk=16, screen_points=64, refine_candidates=2,
                      escalate_rotation_steps=5, escalate_max_candidates=5, escalate_coarse_points=64,
                      escalate_coarse_target_points=64, overlap_screen_steps=4, overlap_screen_iters=4,
                      overlap_iterations=2, escalate_threshold=1e-9, overlap_threshold=1e-9,
                      overlap_adopt_margin=0.8)
PARTIAL = (0, 2, 7)


def _settings(rng):
    """(label, pairs, cfg, register_many keywords) for the three settings."""
    pairs = _many_pairs(rng)
    partial = [(s, t) for i, (_, s, t, _) in enumerate(partial_corpus(n_points=1500)) if i in PARTIAL]
    return {
        # tests/test_register_many.py:30-34.
        "variable sizes": (pairs, MANY, dict(full_pad=512)),
        # tests/test_register_many.py:42-60: a grid too crude for the rotations, escalated on the 8^3 grid.
        "crude escalation": (pairs[:2], CRUDE, dict(full_pad=512, escalate=True, escalate_cfg=MANY,
                                                    escalate_threshold=1e-3)),
        # Partial pairs with every threshold at 1e-9: the whole ladder, rungs adopted and not.
        "overlap ladder": (partial, LADDER, dict(full_pad=1536)),
    }


@pytest.fixture(scope="module")
def many_runs():
    runs = {}
    for label, (pairs, cfg, kw) in _settings(np.random.default_rng(0)).items():
        runs[label] = (pairs, cfg, kw, _many("jax", pairs, cfg, **kw))
    return runs


@pytest.mark.parametrize("label", ["variable sizes", "crude escalation", "overlap ladder"])
def test_register_many_matches_jax(many_runs, label):
    """The same escalated, won and finished pairs, the same rungs run and
    adopted, the same pose (atol 1e-4) and an RMSE within JAX's + 1e-4. The
    test_register_many pairs are exact rotated copies, so JAX's CPU metric
    sits at its expansion-form floor (RMSE ~1.4e-4) where the port's exact
    differences read ~1e-6, and every candidate lane reaches the pose: their
    chosen indices are near-ties and not compared."""
    pairs, cfg, kw, (jr, jm, jl) = many_runs[label]
    tr, tm, tl = _many("torch", pairs, cfg, **dict(kw))
    for f in ("escalated", "won", "finisher"):
        assert getattr(tl, f).tolist() == getattr(jl, f).tolist(), f
    outcomes = [[(r["rung"], r["ran"], r["adopted"]) for r in rows] for rows in tl.rungs]
    assert outcomes == [[(r["rung"], r["ran"], r["adopted"]) for r in rows] for rows in jl.rungs]
    _same_transform(tr.transform, jr.transform)
    assert (tm["rmse"] <= np.asarray(jm["rmse"]) + 1e-4).all(), (tm["rmse"], jm["rmse"])
    if label == "crude escalation":
        assert tl.escalated.all() and tl.won.any()
    if label == "overlap ladder":
        states = {(r["ran"], r["adopted"]) for rows in tl.rungs for r in rows}
        assert {(True, True), (True, False)} <= states
        np.testing.assert_allclose(tr.fitness.numpy(), np.asarray(jr.fitness), rtol=1e-3)
        for rows_t, rows_j in zip(tl.rungs, jl.rungs):
            np.testing.assert_allclose([[r["tf_old"], r["tf_new"]] for r in rows_t],
                                       [[r["tf_old"], r["tf_new"]] for r in rows_j], rtol=1e-3)


def test_register_pair_and_register_many_reach_the_rungs_as_jax():
    """The two entry points' ladders differ, in JAX and in the port alike
    (models/kss_icp.py::escalation_ladder's `pair`): on partial pair 7, with
    overlap_threshold between its fitness before (0.0186) and after (0.0179)
    the 16^3 rung's adoption, register_pair still offers the screen rung
    (the tier is entered once) and register_many does not (the threshold is
    re-checked before each rung)."""
    cfg = dataclasses.replace(LADDER, overlap_threshold=0.0182)
    _, src, tgt, _ = partial_corpus(n_points=1500)[7]
    with RungLog(jk, cfg.overlap_adopt_margin) as jr:
        jk.register_pair(src, tgt, cfg)
    with RungLog(tk, cfg.overlap_adopt_margin) as tr:
        tk.register_pair(src, tgt, from_reference(cfg), device="cpu")
    assert jr.outcomes()[:2] == ["ran", "adopted"] and len(jr.outcomes()) == 3
    assert tr.outcomes() == jr.outcomes()
    rungs = [[(r["rung"], r["ran"], r["adopted"]) for r in _many(package, [(src, tgt)], cfg, full_pad=1536)[2].rungs[0]]
             for package in ("jax", "torch")]
    assert rungs[0] == rungs[1] == [("overlap8", True, False), ("overlap16", True, True)]


@pytest.mark.parametrize("solver", ["field", "screen"])
def test_overlap_batch_matches_jax(solver):
    """overlap_batch, the batched rung of JAX's register_many (the port's
    ladder runs its pieces inline, its incumbent's trimmed fitness taken
    from the crop gate), on three partial pairs against identity
    incumbents: the same pose, and fit_std, tfit_new and tfit_old within
    rtol 1e-3."""
    pairs = [(s, t) for i, (_, s, t, _) in enumerate(partial_corpus(n_points=1500)) if i in PARTIAL]
    clouds = _resampled(pairs, LADDER)
    b = len(pairs)
    incumbent = (np.ones(b, np.float32), np.tile(np.eye(3, dtype=np.float32), (b, 1, 1)),
                 np.zeros((b, 3), np.float32))
    ocfg = LADDER.overlap_config()
    want = jb.overlap_batch(*_j(*clouds), JSim(*_j(*incumbent)), ocfg, solver=solver)
    got = tb.overlap_batch(*_t(*clouds), TSim(*_t(*incumbent)), from_reference(ocfg), solver=solver)
    _same_transform(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3)


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_register_many_rows_do_not_depend_on_the_batch(many_runs, package):
    """Row b of register_many([a, b, c]) is register_many([b]): the same
    ladder, and the same answer, bit for bit in the port; XLA's vmapped CPU
    programs round differently at another batch size (and JAX pads the
    one-pair selections to escalate_pad rows), so JAX's rows agree within
    atol 1e-5 (pose) and rtol 1e-4."""
    pairs, cfg, kw, jax_run = many_runs["overlap ladder"]
    res, m, ladder = jax_run if package == "jax" else _many("torch", pairs, cfg, **kw)
    one, m1, ladder1 = _many(package, pairs[1:2], cfg, **kw)
    tol = dict(rtol=1e-4, atol=1e-5) if package == "jax" else dict(rtol=0, atol=0)

    def arr(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    for got, want in [(getattr(one.transform, f), getattr(res.transform, f)) for f in TSim._fields] + [
            (one.fitness, res.fitness), (m1["rmse"], m["rmse"])]:
        np.testing.assert_allclose(arr(got)[0], arr(want)[1], **tol)
    assert ladder1.escalated[0] == ladder.escalated[1] and ladder1.won[0] == ladder.won[1]
    assert [(r["rung"], r["ran"], r["adopted"]) for r in ladder1.rungs[0]] == [
        (r["rung"], r["ran"], r["adopted"]) for r in ladder.rungs[1]]


def test_batched_metric_equals_per_pair_metric(rng):
    clouds = []
    for n, r in ((300, 500), (420, 512), (512, 260)):
        a, t = np.zeros((512, 3), np.float32), np.zeros((512, 3), np.float32)
        a[:n], t[:r] = random_cloud(rng, n), random_cloud(rng, r) + 0.01
        clouds.append((a, np.arange(512) < n, t, np.arange(512) < r))
    stacked = [torch.as_tensor(np.stack([c[i] for c in clouds])) for i in range(4)]
    batch = registration_measure_padded(*stacked)
    for b, c in enumerate(clouds):
        one = registration_measure_padded(*_t(*c))
        for k in ("mse", "rmse", "mae"):
            np.testing.assert_allclose(float(batch[k][b]), float(one[k]), rtol=1e-6)


@pytest.mark.parametrize("knobs, kw", [({}, dict(mesh=object())),
                                       (dict(refine_polish_iterations=4, refine_max_iterations=1), {})])
def test_unported_batch_options_raise(rng, knobs, kw):
    """A device mesh is not ported and raises. The two-stage converge is: the
    capped pairs are continued and, their refine_hit_cap kept, finished as in
    JAX's register_many, with JAX's transforms and ladder."""
    if kw:
        cfg = dataclasses.replace(from_reference(MANY), **knobs)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tb.register_many(_many_pairs(rng, 1), cfg, full_pad=512, device="cpu", **kw)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            kt.register_many(_many_pairs(rng, 1), cfg, full_pad=512, device="cpu", **kw)
        return
    # Noisy copies: on an exact copy the port's exact-difference fitness keeps
    # falling past JAX's expansion-form floor, and the lanes stop apart.
    pairs = [(s + rng.normal(0, 0.01, s.shape).astype(np.float32), t) for s, t in _many_pairs(rng, 2)]
    cfg = dataclasses.replace(MANY, **knobs)
    jres, jm, jl = _many("jax", pairs, cfg, full_pad=512)
    tres, tm, tl = _many("torch", pairs, cfg, full_pad=512)
    assert tl.continued.any()
    for key in ("continued", "escalated", "won", "finisher"):
        assert getattr(tl, key).tolist() == getattr(jl, key).tolist(), key
    assert tres.refine_hit_cap.tolist() == np.asarray(jres.refine_hit_cap).tolist()
    _same_transform(tres.transform, jres.transform)
    np.testing.assert_allclose(tm["rmse"], np.asarray(jm["rmse"]), atol=1e-4)


def test_register_many_stages_and_result_shapes(rng):
    stages = []
    import contextlib

    pairs = _many_pairs(rng, 3)
    cfg = dataclasses.replace(from_reference(CRUDE), escalate_threshold=0.0, escalate_rotation_steps=4,
                              escalate_max_candidates=4)
    res, m = kt.register_many(pairs, cfg, full_pad=512, device="cpu",
                              timer=lambda s: stages.append(s) or contextlib.nullcontext())
    assert stages[:4] == ["resample", "coarse", "screen", "refine"] and stages[-1] == "metric"
    assert "escalate" in stages
    assert res.transform.rotation.shape == (3, 3, 3) and res.coarse.field.shape == (3, 2, 2, 2)
    assert all(v.shape == (3,) and np.isfinite(v).all() for v in m.values())


@pytest.mark.slow
def test_remesh_25_through_register_many_matches_jax():
    """ROADMAP.md item 9's done test: the remesh 25 through register_many at
    DEFAULT_CONFIG in both packages on the CPU, every pair's RMSE within
    JAX's + 0.006 and the same escalated pairs. Per-pair answers do not
    depend on the batch, so both run sub-batches of 5 pairs: JAX's vmapped
    program for 25 pairs at full_pad 8192 takes tens of GiB on the CPU.
    CPU hours; scripts/torch_port_expected.py --batch records the JAX side."""
    meta = json.loads((FIXTURES / "remesh_transfer.json").read_text())
    with np.load(FIXTURES / "remesh_transfer.npz") as z:
        pairs = [(np.asarray(z[r["name"] + "_src"], np.float32), np.asarray(z[r["name"] + "_tgt"], np.float32))
                 for r in meta]
    cfg = KSSICPConfig()
    for i in range(0, len(pairs), 5):
        sub = pairs[i:i + 5]
        _, jm, jl = _many("jax", sub, cfg)
        _, tm, tl = _many("torch", sub, cfg)
        assert (tm["rmse"] <= np.asarray(jm["rmse"]) + 0.006).all(), (i, tm["rmse"], jm["rmse"])
        assert tl.escalated.tolist() == jl.escalated.tolist(), i
