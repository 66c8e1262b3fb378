"""The port imports without jax, keeps the JAX package's config, runs every
knob as JAX does (the shipped DEFAULT_CONFIG's overlap tier, the two-stage
converge, the AIVS resampler, point-to-plane ICP and every field metric
included), and its CPU path launches no kernel."""

import ast
import contextlib
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import kss_icp_torch.config as tcfg
from kss_icp_torch.core.transforms import euler_xyz_matrix
from kss_icp_torch.models import kss_icp as tk
from helpers import random_cloud
from kss_icp_torch.ops.coarse_cuda import field_ave, field_dot, field_sq, field_trim
from kss_icp_torch.ops.nn_cuda import nn1
from kss_icp_torch.ops.resample_cuda import fps
from kss_icp_tpu import config as jcfg
from kss_icp_tpu.models import kss_icp as jk

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def test_imports_with_jax_blocked():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['kss_icp_tpu'] = None\n"
            "import kss_icp_torch, kss_icp_torch.models.kss_icp, kss_icp_torch.metrics\n"
            "import kss_icp_torch.ops, kss_icp_torch.models, kss_icp_torch.core\n"
            "import kss_icp_torch.escalate, kss_icp_torch.challenge, kss_icp_torch.parallel.batch\n"
            "import kss_icp_torch.largescan, kss_icp_torch.ops.simplify\n"
            "import kss_icp_torch.cli, kss_icp_torch.io, kss_icp_torch.transfer, kss_icp_torch.utils.log\n"
            "import kss_icp_torch.ops.spatial, kss_icp_torch.ops.normals, kss_icp_torch.ops.aivs\n"
            "import kss_icp_torch.ops.wlop, kss_icp_torch.measure_resample, kss_icp_torch.pipeline\n"
            "import kss_icp_torch.utils.cache, kss_icp_torch.utils.fileproc\n"
            "import kss_icp_torch.viz, kss_icp_torch.viz.render, kss_icp_torch.viz.trackball\n"
            "import kss_icp_torch.viz.interactive, kss_icp_torch.native\n"
            "import kss_icp_torch.ops.vcm, kss_icp_torch.ops.voronoi2d, kss_icp_torch.measure_mesh\n"
            "assert kss_icp_torch.register_many and kss_icp_torch.parallel.register_many\n"
            "print(sorted(kss_icp_torch.__all__))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    import kss_icp_tpu
    assert out.stdout.strip() == str(sorted(kss_icp_tpu.__all__))


def test_no_source_file_imports_jax():
    files = sorted((REPO / "kss_icp_torch").rglob("*.py")) + [REPO / "chip_smoke.py",
                                                                  REPO / "scripts" / "torch_kernel_ab.py",
                                                                  REPO / "scripts" / "torch_tree_ab.py"]
    names = {str(f.relative_to(REPO)) for f in files}
    for new in ("viz/__init__.py", "viz/render.py", "viz/trackball.py", "viz/interactive.py", "utils/fileproc.py",
                "native/__init__.py", "ops/vcm.py", "ops/voronoi2d.py", "measure_mesh.py"):
        assert f"kss_icp_torch/{new}" in names, new
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            bad += [f"{f.name}: {n}" for n in names if n.split(".")[0] in ("jax", "jaxlib", "kss_icp_tpu")]
    assert not bad


def test_config_fields_and_defaults_match_jax():
    j = [(f.name, f.default) for f in dataclasses.fields(jcfg.KSSICPConfig)]
    t = [(f.name, f.default) for f in dataclasses.fields(tcfg.KSSICPConfig)]
    assert t == j
    assert dataclasses.asdict(tcfg.DEFAULT_CONFIG) == dataclasses.asdict(jcfg.DEFAULT_CONFIG)


@pytest.mark.parametrize("knobs", [{}, dict(max_candidates=6, coarse_points=512, coarse_target_points=512,
                                           refine_candidates=2, refine_tier_iterations=12,
                                           refine_max_iterations=16),
                                   dict(rotation_chunk=128, refine_candidates=1, escalate_pose_tiebreak=0.3)])
def test_derived_configs_match_jax(knobs):
    j = jcfg.KSSICPConfig(**knobs)
    t = tcfg.from_reference(j)
    assert t == tcfg.KSSICPConfig(**knobs)
    assert dataclasses.asdict(t.escalation_config()) == dataclasses.asdict(j.escalation_config())
    assert dataclasses.asdict(t.overlap_config()) == dataclasses.asdict(j.overlap_config())
    assert dataclasses.asdict(t.escalation_config().overlap_config()) == dataclasses.asdict(
        j.escalation_config().overlap_config())
    assert [t.resample_count(a, b) for a, b in ((757, 3951), (5000, 9000), (3, 1))] == [
        j.resample_count(a, b) for a, b in ((757, 3951), (5000, 9000), (3, 1))]
    assert t.padded_size(3068) == j.padded_size(3068) and t.num_rotations == j.num_rotations


def test_from_reference_takes_a_dict_and_refuses_unknown_fields():
    d = dataclasses.asdict(jcfg.KSSICPConfig(neighborhood_fracs=(0.25, 0.5)))
    assert tcfg.from_reference(d).neighborhood_fracs == (0.25, 0.5)
    with pytest.raises(TypeError):
        tcfg.from_reference(dict(d, no_such_knob=1))


_NO_ESC = tcfg.KSSICPConfig(rotation_steps=2, max_candidates=2, max_resample_points=32, resample_pad=64,
                            max_icp_iterations=2, auto_escalate=False)
# Every knob that was once refused, each now held to JAX (the names of the
# list and the test are the ones the cases were first collected under).
UNPORTED = [dict(auto_escalate=True),  # overlap_escalate defaults to True: the overlap tier
            dict(auto_escalate=True, overlap_escalate=True), dict(overlap_mode=True),
            dict(refine_polish_iterations=4, refine_max_iterations=8), dict(resampler="aivs"),
            dict(neighborhood_fracs=(0.25,)), dict(pose_tiebreak_margin=0.12), dict(icp_variant="point_to_plane"),
            dict(coarse_error_metric="trim"), dict(coarse_error_metric="max"), dict(coarse_error_metric="diff"),
            dict(icp_trim_fraction=0.7), dict(icp_estimate_scale=True)]


@pytest.mark.parametrize("knobs", UNPORTED, ids=[",".join(k) for k in UNPORTED])
def test_unported_knobs_raise(rng, monkeypatch, knobs):
    """Each knob through the port's register_pair and JAX's on the same
    inputs: a target the source does not fit, so the multistart gate fails,
    the tie-break picks the lane (in JAX: used_multistart) and a flagged pair
    climbs the whole escalation ladder."""
    cfg = dataclasses.replace(_NO_ESC, **knobs)
    pts = rng.uniform(-1, 1, size=(40, 3)).astype(np.float32)
    if "icp_variant" not in knobs:
        tgt = rng.uniform(-1, 1, size=(40, 3)).astype(np.float32)
    else:
        # Point-to-plane needs a surface, and neighbourhoods (k = 20) of far
        # fewer points than the cloud, or every normal is the whole cloud's
        # and the step is unconstrained along the plane: a wavy surface and a
        # similarity copy of it, 160 resampled points.
        cfg = dataclasses.replace(cfg, max_resample_points=160, resample_pad=192)
        pts = random_cloud(rng, 400).astype(np.float32)
        rot = np.asarray(euler_xyz_matrix(torch.tensor([0.0, 0.0, 0.3])))
        tgt = (pts[::-1] @ rot.T * 1.2 + 0.1 + rng.normal(0, 0.002, pts.shape)).astype(np.float32)
    calls, select = [], tk._pose_tiebreak_select
    monkeypatch.setattr(tk, "_pose_tiebreak_select", lambda *a: calls.append(a) or select(*a))
    want = jk.register_pair(pts, tgt, jcfg.KSSICPConfig(**dataclasses.asdict(cfg)))
    got = tk.register_pair(pts, tgt, cfg, device="cpu")
    if "pose_tiebreak_margin" in knobs:
        assert bool(want.used_multistart) and bool(got.used_multistart) and len(calls) == 1
    if "refine_polish_iterations" in knobs:
        # The capped converge was continued, and the continuation cleared the flag.
        assert not bool(got.refine_hit_cap) and not bool(want.refine_hit_cap)
    if "auto_escalate" not in knobs:
        # Here two lanes of the 16^3 re-solve converge to one pose, their
        # fitnesses a few ulps apart, and the tie-break may take either.
        assert int(got.chosen_candidate) == int(want.chosen_candidate)
    np.testing.assert_allclose(float(got.fitness), float(want.fitness), rtol=1e-3, atol=1e-7)
    for f in ("scale", "rotation", "translation"):
        np.testing.assert_allclose(getattr(got.transform, f).numpy(), np.asarray(getattr(want.transform, f)),
                                   atol=1e-4)


def test_escalation_with_the_overlap_tier_raises_before_any_work(rng):
    """The two-stage converge beside the shipped ladder: DEFAULT_CONFIG shrunk
    to tiny sizes with every threshold at 0, and the escalation alone, each
    with the converge capped at 1 and continued. The port's register_pair
    gives JAX's pose and fitness, the pair continued in both (the
    polish_resampled calls at the base config) and refine_hit_cap cleared."""
    shipped = dataclasses.replace(tcfg.DEFAULT_CONFIG, max_resample_points=48, resample_pad=64, max_icp_iterations=4,
                                  rotation_steps=3, escalate_rotation_steps=4, overlap_screen_steps=3,
                                  max_candidates=4, escalate_max_candidates=4,
                                  escalate_threshold=0.0, overlap_threshold=0.0, overlap_gate_ratio=1e9)
    pts = rng.uniform(-1, 1, size=(100, 3)).astype(np.float32)
    # A noisy copy: on an exact copy the port's exact-difference fitness keeps
    # falling past JAX's expansion-form floor, so the lanes stop apart.
    tgt = (pts[::-1] @ np.asarray(euler_xyz_matrix(torch.tensor([0.2, -0.1, 0.3]))).T * 1.3
           + rng.normal(0, 0.01, pts.shape)).astype(np.float32)
    for cfg in (shipped, dataclasses.replace(_NO_ESC, auto_escalate=True)):
        cfg = dataclasses.replace(cfg, refine_polish_iterations=4, refine_max_iterations=1)
        calls = {"jax": [], "torch": []}
        with contextlib.ExitStack() as stack:
            for tag, mod in (("jax", jk), ("torch", tk)):
                orig = mod.polish_resampled
                stack.enter_context(_patched(mod, "polish_resampled",
                                             lambda *a, _o=orig, _t=tag, **kw: calls[_t].append(
                                                 a[-1].refine_polish_iterations) or _o(*a, **kw)))
            want = jk.register_pair(pts, tgt, jcfg.KSSICPConfig(**dataclasses.asdict(cfg)))
            got = tk.register_pair(pts, tgt, cfg, device="cpu")
        assert calls["torch"] == calls["jax"] and calls["jax"][:1] == [4]
        assert not bool(got.refine_hit_cap) and not bool(want.refine_hit_cap)
        np.testing.assert_allclose(float(got.fitness), float(want.fitness), rtol=1e-3, atol=1e-7)
        for f in ("scale", "rotation", "translation"):
            np.testing.assert_allclose(getattr(got.transform, f).numpy(), np.asarray(getattr(want.transform, f)),
                                       atol=1e-4)


@contextlib.contextmanager
def _patched(module, name, fn):
    orig = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, orig)


def test_default_config_runs_the_overlap_ladder(rng):
    """DEFAULT_CONFIG, shrunk to tiny sizes with every threshold at 0, runs
    the base solve, the escalation and the three overlap rungs, no knob
    refused."""
    cfg = dataclasses.replace(tcfg.DEFAULT_CONFIG, max_resample_points=48, resample_pad=64, max_icp_iterations=4,
                              rotation_steps=3, escalate_rotation_steps=4, overlap_screen_steps=3,
                              escalate_threshold=0.0, overlap_threshold=0.0, overlap_gate_ratio=1e9)
    stages = []
    pts = rng.uniform(-1, 1, size=(100, 3)).astype(np.float32)
    res = tk.register_pair(pts, pts[::-1] * 1.3, cfg, device="cpu",
                           timer=lambda s: stages.append(s) or contextlib.nullcontext())
    assert {"resample", "escalate", "overlap8", "overlap16", "overlap_screen"} <= set(stages)
    assert bool(torch.isfinite(res.fitness)) and bool(torch.isfinite(res.transform.rotation).all())


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    pts = np.zeros((40, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tk.register_pair(pts, pts, _NO_ESC)


def test_cpu_wrappers_launch_no_kernel(rng):
    counters = (nn1, fps, field_ave, field_dot, field_trim, field_sq)
    before = [fn.launches for fn in counters]
    pts = torch.as_tensor(rng.uniform(-1, 1, size=(2, 50, 3)).astype(np.float32))
    mask = torch.ones((2, 50), dtype=torch.bool)
    nn1(pts, pts, mask)
    fps(pts, mask, 10)
    field_ave(pts[0], mask[0], pts[1], mask[1], torch.eye(3)[None])
    field_dot(pts[0], mask[0], pts[1], mask[1], torch.eye(3)[None], precision="default")
    field_trim(pts[0], mask[0], pts[1], mask[1], torch.eye(3)[None], 0.7)
    field_sq(pts[0], mask[0], pts[1], mask[1], torch.eye(3)[None], "diff")
    assert [fn.launches for fn in counters] == before
