"""The port's escalation (kss_icp_torch/escalate.py, models/kss_icp.py) against
the JAX package on the same inputs: the host logic of kss_icp_tpu/escalate.py
on the cases of tests/test_escalate.py, the symmetric-pose tie-break, the
uncapped finisher polish_resampled, and register_pair with escalation forced
at tiny configs (a low escalate_threshold, and a tiny refine_max_iterations
for the hit-cap fold), both field methods."""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import random_cloud
from kss_icp_torch import escalate as te
from kss_icp_torch.config import from_reference
from kss_icp_torch.core.transforms import Similarity as TSim
from kss_icp_torch.models import kss_icp as tk
from kss_icp_tpu import escalate as je
from kss_icp_tpu.config import KSSICPConfig
from kss_icp_tpu.core.transforms import Similarity as JSim
from kss_icp_tpu.models import kss_icp as jk

torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parents[1] / "fixtures"


# --- host logic: the cases of tests/test_escalate.py through both packages ---

def test_padded_selection_matches_jax():
    for flagged, m, cap in (([3, 7], 4, None), ([1, 2, 3, 4], 4, None), ([5], 4, 2), ([2], 1, None)):
        args = (np.array(flagged), m, cap)
        assert te.padded_selection(*args).tolist() == je.padded_selection(*args).tolist()


def _rerun_both(fitness, threshold, pad, result, resolve_fn, **kw):
    """escalate_rerun of both packages on numpy results; the port's also on tensors."""
    calls = {"jax": [], "torch": []}

    def resolver(tag, as_tensor):
        def resolve(sel):
            calls[tag].append(list(sel))
            tree, fit2 = resolve_fn(sel)
            if as_tensor:
                tree = {k: torch.as_tensor(v) for k, v in tree.items()}
            return tree, fit2
        return resolve

    jout = je.escalate_rerun(resolver("jax", False), fitness, threshold, pad, result=result, **kw)
    tout = te.escalate_rerun(resolver("torch", False), fitness, threshold, pad, result=result, **kw)
    tens = te.escalate_rerun(resolver("torch", True), fitness, threshold, pad,
                             result={k: torch.as_tensor(v) for k, v in result.items()}, **kw)
    assert calls["torch"][:len(calls["jax"])] == calls["jax"]
    for out in (tout, tens):
        np.testing.assert_array_equal(out[1], jout[1])
        assert out[3] == jout[3] and [w[0] for w in out[2]] == [w[0] for w in jout[2]]
        for k in result:
            np.testing.assert_array_equal(np.asarray(out[0][k]), jout[0][k])
    return jout


def test_escalate_rerun_fitness_gate_matches_jax():
    out = _rerun_both(np.array([1e-4, 5e-3, 2e-4, 9e-3]), 3e-3, 2, {"x": np.zeros(4)},
                      lambda sel: ({"x": np.full(len(sel), 42.0)}, np.full(len(sel), 1e-5)))
    assert out[3] == 2 and out[0]["x"].tolist() == [0.0, 42.0, 0.0, 42.0]


def test_escalate_rerun_flags_override_matches_jax():
    out = _rerun_both(np.array([1e-4, 1e-4, 1e-4]), None, 1, {"x": np.zeros(3)},
                      lambda sel: ({"x": np.full(len(sel), 1.0)}, np.full(len(sel), 5e-5)),
                      flags=np.array([False, True, False]))
    assert out[0]["x"].tolist() == [0.0, 1.0, 0.0]


def test_escalate_rerun_difficulty_sort_chunks_matches_jax():
    fitness = np.array([0.001, 0.9, 0.002, 0.5, 0.003, 0.7], np.float32)
    out = _rerun_both(fitness, 0.1, 2, {"x": np.zeros((6, 1), np.float32)},
                      lambda sel: ({"x": np.asarray(sel, np.float32)[:, None]}, np.full(len(sel), 1e-4, np.float32)),
                      chunk=2)
    assert out[3] == 3 and out[0]["x"][:, 0].tolist() == [0, 1, 0, 3, 0, 5]


@pytest.mark.parametrize("margin, adopted", [(0.0, [1]), (0.05, [1, 2]), (0.2, [1, 2, 3])])
def test_escalate_rerun_near_tie_margin_matches_jax(margin, adopted):
    """near_tie_margin adopts a re-solve up to (1 + margin) x the incumbent's
    fitness (kss_icp_tpu/escalate.py:49-55), and the adopted row carries the
    re-solve's own fitness. Row 1 improves; rows 2 and 3 worsen by 4% and
    15%; row 0 is not flagged; float32 fitnesses, as the ladders pass them."""
    fitness = np.array([1e-4, 5e-3, 4e-3, 6e-3], np.float32)
    fit2 = np.array([0.0, 4e-3, 4e-3 * 1.04, 6e-3 * 1.15], np.float32)
    out = _rerun_both(fitness, 1e-3, 1, {"x": np.zeros(4, np.float32)},
                      lambda sel: ({"x": np.asarray(sel, np.float32)}, fit2[np.asarray(sel)]),
                      near_tie_margin=margin)
    assert [w[0] for w in out[2]] == adopted
    np.testing.assert_array_equal(out[1][adopted], fit2[adopted])
    assert out[0]["x"].tolist() == [float(i) if i in adopted else 0.0 for i in range(4)]


def test_polish_rerun_keep_better_matches_jax():
    fitness, hit = np.array([2e-3, 4e-3]), np.array([True, True])

    def resolve(sel):  # row 0 improves, row 1 worsens
        return {"x": np.full(len(sel), 7.0)}, np.where(np.asarray(sel) == 0, 1e-4, 9e-3)

    jout = je.polish_rerun(resolve, hit, fitness, 2, result={"x": np.zeros(2)})
    tout = te.polish_rerun(resolve, hit, fitness, 2, result={"x": np.zeros(2)})
    np.testing.assert_array_equal(tout[1], jout[1])
    assert tout[0]["x"].tolist() == jout[0]["x"].tolist() == [7.0, 0.0] and tout[3] == jout[3] == 2


def test_escalate_rerun_merges_namedtuple_rows():
    res = TSim(scale=torch.ones(3), rotation=torch.eye(3).repeat(3, 1, 1), translation=torch.zeros(3, 3))
    new = TSim(scale=torch.full((1,), 2.0), rotation=torch.zeros(1, 3, 3), translation=torch.ones(1, 3))
    out, fit, wins, n = te.escalate_rerun(lambda sel: (new, np.array([1e-5])), np.array([1e-4, 5e-3, 1e-4]),
                                          1e-3, 1, result=res)
    assert n == 1 and [w[0] for w in wins] == [1]
    assert out.scale.tolist() == [1.0, 2.0, 1.0] and out.translation[1].tolist() == [1.0, 1.0, 1.0]
    assert res.scale.tolist() == [1.0, 1.0, 1.0]  # the caller's tree is not touched


# --- the pose tie-break and the finisher ---

def _lanes(rng):
    tgt = random_cloud(rng, 300).astype(np.float32)
    base = tgt[rng.permutation(300)[:120]]
    # Lane k: the target's points with noise of scale s_k; lane 2 has the
    # smallest 0.95 quantile but is not near-tied in fitness.
    noise = [0.02, 0.015, 0.005, 0.01]
    aligned = np.stack([base + rng.normal(0, s, size=base.shape) for s in noise]).astype(np.float32)
    smask = np.ones(120, bool)
    smask[110:] = False
    tmask = np.ones(300, bool)
    tmask[290:] = False
    return aligned, smask, tgt, tmask


@pytest.mark.parametrize("fit, want", [
    ([1.0e-3, 1.05e-3, 1.3e-3, 1.08e-3], 3),   # lanes 0, 1, 3 near-tied: lane 3 has the lowest quantile
    ([1.0e-3, 1.5e-3, 1.6e-3, 1.7e-3], 0),     # no other lane within the margin
    ([1e30, 1.0e-3, 1.0e-3, 1e30], 2),         # invalid lanes never win; equal fitness both near
])
def test_pose_tiebreak_select_matches_jax(rng, fit, want):
    aligned, smask, tgt, tmask = _lanes(rng)
    cfg = KSSICPConfig(pose_tiebreak_margin=0.12)
    fit = np.asarray(fit, np.float32)
    j = jk._pose_tiebreak_select(jnp.asarray(fit), jnp.asarray(aligned), jnp.asarray(smask), jnp.asarray(tgt),
                                 jnp.asarray(tmask), cfg)
    t = tk._pose_tiebreak_select(*(torch.as_tensor(x)[None] for x in (fit, aligned, smask, tgt, tmask)),
                                 from_reference(cfg))
    assert t.shape == (1,) and int(t[0]) == int(j) == want


def test_polish_resampled_matches_jax(rng):
    tgt = random_cloud(rng, 256).astype(np.float32)
    src = (tgt[rng.permutation(256)[:200]] + rng.normal(0, 0.01, size=(200, 3))).astype(np.float32)
    smask, tmask = np.ones(200, bool), np.ones(256, bool)
    smask[190:] = False
    c, s = np.cos(0.3), np.sin(0.3)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    trans, scale = np.array([0.05, -0.02, 0.01], np.float32), np.float32(1.1)
    cfg = KSSICPConfig(max_icp_iterations=30)
    jt, jf, ji = jk.polish_resampled(jnp.asarray(src), jnp.asarray(smask), jnp.asarray(tgt), jnp.asarray(tmask),
                                     JSim(jnp.asarray(scale), jnp.asarray(rot), jnp.asarray(trans)), cfg)
    tt, tf, ti = tk.polish_resampled(*(torch.as_tensor(x) for x in (src, smask, tgt, tmask)),
                                     TSim(torch.tensor(scale), torch.as_tensor(rot), torch.as_tensor(trans)),
                                     from_reference(cfg))
    assert abs(int(ti) - int(ji)) <= 1  # the rotation-gate knife edge (tests/test_torch_icp.py)
    np.testing.assert_allclose(float(tf), float(jf), rtol=1e-3)
    np.testing.assert_allclose(tt.rotation.numpy(), np.asarray(jt.rotation), atol=1e-4)
    np.testing.assert_allclose(tt.translation.numpy(), np.asarray(jt.translation), atol=1e-4)
    assert float(tt.scale) == pytest.approx(float(jt.scale), rel=1e-6)


# --- register_pair with escalation forced ---

TINY = KSSICPConfig(rotation_steps=4, max_candidates=4, max_resample_points=128, resample_pad=128,
                    max_icp_iterations=8, rotation_chunk=16, screen_points=64, refine_candidates=2,
                    overlap_escalate=False, escalate_rotation_steps=6, escalate_max_candidates=6,
                    escalate_coarse_points=64, escalate_coarse_target_points=64)
CONFIGS = {
    # Every pair flags on fitness.
    "threshold": dataclasses.replace(TINY, escalate_threshold=1e-9),
    # Only the hit-cap fold flags: a 2-iteration final converge.
    "hit_cap": dataclasses.replace(TINY, escalate_threshold=1.0, refine_max_iterations=2, max_icp_iterations=30),
}
# (config, pair, field method). Pairs whose escalated candidates are near-tied
# (two lanes converged to one pose, their 0.95 quantiles a few ulps apart) pick
# either lane by rounding, so they are left out: Angelg, Armadillow, Bunnyw.
CASES = [("threshold", "Angelw", "vpu"), ("threshold", "Buddhag", "vpu"), ("threshold", "Bunnyg", "vpu"),
         ("threshold", "Catg", "vpu"), ("threshold", "Catg", "dot"), ("hit_cap", "Buddhag", "vpu"),
         ("hit_cap", "Buddhaw", "vpu"), ("hit_cap", "Catg", "vpu")]


class _Branches:
    """Counts the escalation branches register_pair takes in one package, and
    records for each re-solve whether its multistart gate failed, which is
    where the escalation config's pose tie-break picks the lane. In the port
    the tie-break's calls are counted too (JAX traces it inside jit). The
    port's re-solve returns only the rows it merges, so its gate is read
    from register_batch calls made inside the re-solve; its finisher runs
    through polish_rerun, whose escalate_rerun call is not a re-solve."""

    def __init__(self, monkeypatch, esc_mod, kss_mod):
        self.flagged = self.won = self.finished = self.tiebreaks = 0
        self.multistart = []
        self.resolving = self.polishing = False
        rerun, polish, polish_rerun = esc_mod.escalate_rerun, kss_mod.polish_resampled, esc_mod.polish_rerun

        def counted_rerun(resolve, *a, **kw):
            if self.polishing:
                return rerun(resolve, *a, **kw)

            def recorded(sel):
                r2, fit2 = resolve(sel)
                if kss_mod is not tk:
                    self.multistart.append(bool(r2.used_multistart))
                return r2, fit2

            self.resolving = True
            try:
                out = rerun(recorded, *a, **kw)
            finally:
                self.resolving = False
            self.flagged += out[3]
            self.won += len(out[2])
            return out

        def counted_polish(*a, **kw):
            self.finished += 1
            return polish(*a, **kw)

        def marked_polish_rerun(*a, **kw):
            self.polishing = True
            try:
                return polish_rerun(*a, **kw)
            finally:
                self.polishing = False

        monkeypatch.setattr(esc_mod, "escalate_rerun", counted_rerun)
        monkeypatch.setattr(esc_mod, "polish_rerun", marked_polish_rerun)
        monkeypatch.setattr(kss_mod, "polish_resampled", counted_polish)
        if kss_mod is tk:
            select, batch = tk._pose_tiebreak_select, tk.register_batch

            def counted_select(*a, **kw):
                self.tiebreaks += 1
                return select(*a, **kw)

            def recorded_batch(*a, **kw):
                r = batch(*a, **kw)
                if self.resolving:
                    self.multistart += [bool(x) for x in r.used_multistart]
                return r

            monkeypatch.setattr(tk, "_pose_tiebreak_select", counted_select)
            monkeypatch.setattr(tk, "register_batch", recorded_batch)

    def key(self):
        return self.flagged, self.won, self.finished, tuple(self.multistart)


def _pair(name):
    with np.load(FIXTURES / "remesh_transfer.npz") as z:
        return np.asarray(z[name + "_src"], np.float32), np.asarray(z[name + "_tgt"], np.float32)


@pytest.mark.parametrize("label, name, method", CASES)
def test_register_pair_escalation_matches_jax(monkeypatch, label, name, method):
    cfg = dataclasses.replace(CONFIGS[label], coarse_method=method)
    src, tgt = _pair(name)
    jb = _Branches(monkeypatch, je, jk)
    jr = jk.register_pair(src, tgt, cfg)
    tb = _Branches(monkeypatch, te, tk)
    tr = tk.register_pair(src, tgt, from_reference(cfg), device="cpu")
    assert jb.flagged == 1 and tb.key() == jb.key()
    assert tb.tiebreaks == sum(tb.multistart)  # the tie-break ran on every gate-failed re-solve
    assert int(tr.chosen_candidate) == int(jr.chosen_candidate)
    assert tr.coarse.field.shape == jr.coarse.field.shape
    assert not bool(tr.refine_hit_cap) and not bool(jr.refine_hit_cap)
    np.testing.assert_allclose(float(tr.fitness), float(jr.fitness), rtol=1e-3)


def test_forced_escalation_takes_every_branch():
    """The cases above win the re-solve, keep the base solve, run the finisher,
    and reach the re-solve's pose tie-break."""
    seen, tiebreaks = set(), 0
    for label, name, method in CASES:
        if method != "vpu":
            continue
        with pytest.MonkeyPatch.context() as mp:
            b = _Branches(mp, te, tk)
            tk.register_pair(*_pair(name), from_reference(CONFIGS[label]), device="cpu")
        seen.add(("won" if b.won else "kept", "finished" if b.finished else "unfinished"))
        tiebreaks += b.tiebreaks
    assert {("won", "unfinished"), ("kept", "unfinished"), ("kept", "finished")} <= seen
    assert tiebreaks > 0


def test_pose_tiebreak_margin_matches_jax(monkeypatch):
    """pose_tiebreak_margin on the base solve (no escalation) picks JAX's lane
    on pairs whose multistart gate fails, so the tie-break decides."""
    cfg = dataclasses.replace(TINY, auto_escalate=False, pose_tiebreak_margin=0.5)
    calls, select = [], tk._pose_tiebreak_select
    monkeypatch.setattr(tk, "_pose_tiebreak_select", lambda *a: calls.append(a) or select(*a))
    for name in ("Buddhag", "Catg"):
        src, tgt = _pair(name)
        calls.clear()
        jr = jk.register_pair(src, tgt, cfg)
        tr = tk.register_pair(src, tgt, from_reference(cfg), device="cpu")
        assert bool(jr.used_multistart) and bool(tr.used_multistart) and len(calls) == 1, name
        assert int(tr.chosen_candidate) == int(jr.chosen_candidate), name
        np.testing.assert_allclose(float(tr.fitness), float(jr.fitness), rtol=1e-3)


@pytest.mark.parametrize("label, name", [("hit_cap", "Angelw"), ("threshold", "Dogg")])
def test_keep_better_knife_edge_is_no_worse(monkeypatch, label, name):
    """Where the re-solve and the base solve end at near-equal fitness, the
    two packages can keep different ones (JAX keeps the base solve and, on
    Angelw, finishes it; the port keeps the re-solve): the rounding of the
    last ICP steps decides. Both flag the pair, and keep-better leaves the
    port no worse than its own base solve and within 1e-3 of JAX."""
    cfg = CONFIGS[label]
    src, tgt = _pair(name)
    jb = _Branches(monkeypatch, je, jk)
    jr = jk.register_pair(src, tgt, cfg)
    tb = _Branches(monkeypatch, te, tk)
    tr = tk.register_pair(src, tgt, from_reference(cfg), device="cpu")
    base = tk.register_pair(src, tgt, from_reference(dataclasses.replace(cfg, auto_escalate=False)), device="cpu")
    assert jb.flagged == tb.flagged == 1
    assert float(tr.fitness) <= float(base.fitness)
    np.testing.assert_allclose(float(tr.fitness), float(jr.fitness), rtol=1e-3)
