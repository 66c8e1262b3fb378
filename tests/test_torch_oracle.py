"""The port's reference oracle (kss_icp_torch/oracle.py), its native twin
(kss_icp_torch/native/oracle_hot), the corpus loaders (kss_icp_torch/stress.py)
and the stage timer (kss_icp_torch/utils/profiling.py), against the JAX
package's modules on the CPU.

The oracle is numpy + scipy in float64 in both packages, so every compared
field is held bit for bit on float64 inputs from a numpy seed; the native
twins are built with the same g++ flags and compared bit for bit too.
tests/test_oracle.py's own contract cases run here against the port, the
pipeline case through the port's register_pair on the CPU.
"""

import dataclasses
import inspect
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import kss_icp_torch.oracle as to
import kss_icp_torch.stress as ts
from kss_icp_torch.native import NativeBuildError
from kss_icp_torch.native import oracle_hot as th
from kss_icp_torch.utils.profiling import StageTimer, trace_annotation
import kss_icp_tpu.oracle as jo
import kss_icp_tpu.stress as js
from kss_icp_tpu.utils import profiling as jp

torch.set_num_threads(1)


def _wavy(n, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.uniform(-1, 1, n)
    v = rng.uniform(-1, 1, n)
    return np.stack([u, v, 0.3 * np.sin(3 * u) * np.cos(2 * v)], -1)


def _pair(n_src, n_tgt, seed, axis=2, angle=0.9, scale=1.2):
    """A float64 pair: two samplings of one surface, the source moved by an
    axis rotation, a scale and a shift."""
    tgt = _wavy(n_tgt, seed)
    src = jo._axis_rotate(axis, angle, _wavy(n_src, seed + 100) * scale) + np.array([0.1, -0.05, 0.02])
    return src, tgt


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# Bit for bit against kss_icp_tpu.oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 9_999, 10_000, 49_999, 50_000, 99_999, 100_000, 499_999, 500_000,
                               999_999, 1_000_000, 8_000_000, 27_000_001])
def test_estimate_box_scale_matches_jax(n):
    assert to.estimate_box_scale(n) == jo.estimate_box_scale(n)


@pytest.mark.parametrize("n, point_num", [(600, 150), (900, 420), (1200, 300)])
def test_aivs_simplify_matches_jax(n, point_num):
    pts = _wavy(n, seed=n)
    got, want = to.aivs_simplify(pts, point_num), jo.aivs_simplify(pts, point_num)
    _same(got, want)  # the same rows in the same order
    assert got.shape == (point_num, 3)
    br_t, br_j = to.OracleBallRegion(pts), jo.OracleBallRegion(pts)
    assert br_t.boxes == br_j.boxes and br_t.box_center_local == br_j.box_center_local
    assert br_t.xyz_number == br_j.xyz_number and br_t.radius == br_j.radius
    _same(br_t.box_centers, br_j.box_centers)
    assert [br_t.neighbor_boxes(i) for i in range(len(br_t.boxes))] == \
        [br_j.neighbor_boxes(i) for i in range(len(br_j.boxes))]


def test_accurate_cut_matches_jax():
    pts = _wavy(700, seed=7)
    sample = list(range(0, 700, 2))
    _same(to._accurate_cut(pts, sample, 200), jo._accurate_cut(pts, sample, 200))


@pytest.mark.parametrize("axis", [1, 2, 3])
def test_axis_rotate_matches_jax(axis):
    pts = _wavy(300, seed=axis)
    _same(to._axis_rotate(axis, 1.234, pts), jo._axis_rotate(axis, 1.234, pts))


@pytest.fixture(scope="module")
def resampled():
    """A resampled float64 pair, as register_pair_oracle makes it."""
    src, tgt = _pair(800, 1000, seed=11)
    return jo.aivs_simplify(src, 300), jo.aivs_simplify(tgt, 300)


def test_init_registration_matches_jax(resampled):
    cloud_s, cloud_t = resampled
    got, want = to.OracleInitRegistration(cloud_s, cloud_t), jo.OracleInitRegistration(cloud_s, cloud_t)
    for f in ("value", "angle", "middle", "middle_s", "scale", "point_source"):
        _same(getattr(got, f), getattr(want, f))
    assert got.value.shape == (9, 9, 9)  # the float-accumulation quirk: nine angles an axis
    assert len(got.angle_list) == len(want.angle_list) > 0
    for a, b in zip(got.angle_list, want.angle_list):
        _same(a, b)
    _same(got.rotate(cloud_s, want.angle_list[-1]), want.rotate(cloud_s, want.angle_list[-1]))


def test_pcl_icp_matches_jax(resampled):
    cloud_s, cloud_t = resampled
    moved = jo._axis_rotate(3, 0.2, cloud_s) * 1.1
    got, want = to.pcl_icp(moved, cloud_t), jo.pcl_icp(moved, cloud_t)
    _same(got.transformation, want.transformation)
    assert (got.fitness, got.iterations, got.converged) == (want.fitness, want.iterations, want.converged)
    assert got.iterations > 1
    capped = to.pcl_icp(moved, cloud_t, max_iterations=3, tree=cKDTree(cloud_t))
    assert (capped.iterations, capped.converged) == (3, True)
    _same(capped.transformation, jo.pcl_icp(moved, cloud_t, max_iterations=3).transformation)


def test_pcr_qm_matches_jax(resampled):
    cloud_s, cloud_t = resampled
    assert to.pcr_qm(cloud_s, cloud_t) == jo.pcr_qm(cloud_s, cloud_t)


# Two pairs: one where the judge ICP's fitness clears the 0.0005 gate (the
# target's own points rotated), one where it does not and every local minimum
# is tried (the multi-start).
PAIRS = {"gate": lambda: (jo._axis_rotate(2, 0.9, _wavy(1000, 6)), _wavy(1000, 6)),
         "multistart": lambda: _pair(1000, 800, seed=31, axis=1, angle=2.6, scale=1.4)}


@pytest.mark.parametrize("case", list(PAIRS))
def test_register_pair_oracle_matches_jax(case):
    src, tgt = PAIRS[case]()
    got, want = to.register_pair_oracle(src, tgt), jo.register_pair_oracle(src, tgt)
    fields = [f.name for f in dataclasses.fields(jo.OracleRegistrationResult)]
    assert fields == [f.name for f in dataclasses.fields(to.OracleRegistrationResult)]
    for f in fields:
        if f in ("seconds", "stage_seconds"):
            continue
        if f == "aligned":
            _same(got.aligned, want.aligned)
        else:
            assert getattr(got, f) == getattr(want, f), f
    assert set(got.stage_seconds) == set(want.stage_seconds)
    assert got.used_multistart == (case == "multistart")
    assert to.pcr_qm(got.aligned, tgt) == jo.pcr_qm(want.aligned, tgt)


RECORD = Path(__file__).resolve().parents[1] / "fixtures" / "torch_port_expected_oracle.json"


@pytest.mark.parametrize("name", ["Buddhaw", "Angelw"])
def test_oracle_record_matches_port(name):
    """chip_smoke.py phase 4m's record (JAX's oracle, scripts/torch_port_expected.py
    --oracle) lists the remesh 25 and the category board, and the port's
    oracle gives its numbers on this CPU on the record's two cheapest pairs
    (phase 4m holds all 57)."""
    from kss_icp_torch.challenge import category_corpus

    record = json.loads(RECORD.read_text())
    rows = {p["name"]: p for p in record["pairs"]}
    rows.update({f"category:{p['name']}": p for p in record["boards"]["category"]["pairs"]})
    pairs = {n: (s, t) for n, s, t, _ in ts.remesh_corpus()}
    assert sorted(rows) == sorted(list(pairs) + [f"category:{n}" for n, _, _, _ in category_corpus()])
    src, tgt = pairs[name]
    res = to.register_pair_oracle(src, tgt)
    got = dict(to.pcr_qm(res.aligned, tgt), judge_fitness=res.judge_fitness, fitness=res.fitness,
               used_multistart=res.used_multistart, num_candidates=res.num_candidates,
               chosen_candidate=res.chosen_candidate, n_source=len(src), n_target=len(tgt))
    assert got == {k: rows[name][k] for k in got}


@pytest.mark.parametrize("name", ["register_pair_oracle", "pcl_icp", "aivs_simplify", "pcr_qm",
                                  "OracleInitRegistration"])
def test_oracle_defaults_match_jax(name):
    assert inspect.signature(getattr(to, name)) == inspect.signature(getattr(jo, name))


# ---------------------------------------------------------------------------
# tests/test_oracle.py's contract cases, against the port
# ---------------------------------------------------------------------------


def test_box_scale_ladder():
    # ballRegionCompute.hpp:1194-1214
    assert [to.estimate_box_scale(n) for n in (5_000, 20_000, 99_999, 400_000, 900_000)] == [10, 20, 30, 40, 50]
    # int-truncated cbrt, like the reference's (int)pow(n/8, 1/3):
    # cbrt(1e6) computes as 99.999... in binary floating point -> 99.
    assert to.estimate_box_scale(8_000_000) == 99


def test_aivs_exact_count_and_subset():
    pts = _wavy(3000)
    out = to.aivs_simplify(pts, 500)
    assert out.shape == (500, 3)
    # Every sample is an input point (AIVS selects, never synthesizes).
    dist, _ = cKDTree(pts).query(out)
    assert float(dist.max()) == 0.0


def test_pcl_icp_recovers_small_rigid():
    src = _wavy(800, seed=1)
    ang = 0.15
    c, s = np.cos(ang), np.sin(ang)
    r = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    tgt = src @ r.T + np.array([0.02, -0.01, 0.03])
    res = to.pcl_icp(src, tgt)
    assert res.converged
    assert res.fitness < 1e-6
    np.testing.assert_allclose(res.transformation[:3, :3], r, atol=1e-4)


def test_oracle_axis_rotations_match_port_euler():
    # The oracle applies X then Y then Z (initRegistrationKSS.hpp:86-88);
    # the port's euler_xyz_matrix encodes the same composition.
    from kss_icp_torch.core.transforms import euler_xyz_matrix

    pts = _wavy(100, seed=2)
    ang = np.array([0.3, 1.1, 2.2])
    ref = to._axis_rotate(3, ang[2], to._axis_rotate(2, ang[1], to._axis_rotate(1, ang[0], pts)))
    ours = pts @ euler_xyz_matrix(torch.tensor(ang)).numpy().T
    np.testing.assert_allclose(ref, ours, atol=1e-5)


def test_oracle_middle_align_matches_port_preshape():
    from kss_icp_torch.core.preshape import middle_align

    src = _wavy(300, seed=3) * 2.0 + 0.5
    tgt = _wavy(400, seed=4)
    ir = to.OracleInitRegistration.__new__(to.OracleInitRegistration)
    ir.source, ir.target, ir.step = src, tgt, 2.0  # tiny grid: cheap scan
    ir.__post_init__()
    _, _, scale = middle_align(torch.tensor(src, dtype=torch.float32), torch.ones(len(src), dtype=torch.bool),
                               torch.tensor(tgt, dtype=torch.float32), torch.ones(len(tgt), dtype=torch.bool))
    assert abs(float(scale) - ir.scale) < 1e-4
    aligned = np.asarray(src) * ir.scale + (ir.middle_s - ir.scale * src.mean(0))
    np.testing.assert_allclose(ir.point_source, aligned, atol=1e-9)


def test_oracle_end_to_end_recovers_transfer():
    # transfer.txt protocol: a known axis rotation + scale + shift is
    # recovered (SURVEY.md §4.2, transferPC.hpp:66-130).
    tgt = _wavy(1200, seed=5)
    src = to._axis_rotate(1, 1.56, tgt * 1.3) + np.array([0.2, -0.1, 0.05])
    res = to.register_pair_oracle(src, tgt)
    m = to.pcr_qm(res.aligned, tgt)
    assert m["rmse"] < 0.05, m
    assert res.num_candidates >= 1


def test_oracle_and_port_pipeline_agree_on_golden_shape():
    # The oracle and the port's pipeline land in the same basin on an easy
    # pair: same data, both reach RMSE < 0.05.
    import kss_icp_torch as kt
    from kss_icp_torch.config import KSSICPConfig

    tgt = _wavy(1000, seed=6)
    src = to._axis_rotate(2, 0.9, tgt)
    om = to.pcr_qm(to.register_pair_oracle(src, tgt).aligned, tgt)

    # tests/test_oracle.py's config with the clouds padded to 512 slots
    # (pnumber is 500) in place of 2048 and 256 coarse points in place of
    # 512: the same valid points, and the plain field on the CPU, which takes
    # most of the test's time, does a quarter of the work.
    cfg = KSSICPConfig(max_candidates=8, coarse_points=256, refine_candidates=2, resample_pad=512)
    r = kt.register_pair(src.astype(np.float32), tgt.astype(np.float32), cfg, device="cpu")
    aligned = kt.apply_similarity(r.transform, torch.as_tensor(src, dtype=torch.float32)).numpy()
    pm = to.pcr_qm(aligned, tgt)
    assert om["rmse"] < 0.05
    assert pm["rmse"] < 0.05
    # The port must not be dramatically worse than the faithful replica.
    assert pm["rmse"] < max(2.0 * om["rmse"], 0.03)


# ---------------------------------------------------------------------------
# The native twin against kss_icp_tpu.native.oracle_hot
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """JAX's bindings over its own oracle_hot.cpp, its library built with its
    g++ flags into a temporary directory (not beside its source)."""
    from kss_icp_tpu.native import oracle_hot as jh

    mp = pytest.MonkeyPatch()
    mp.setattr(jh, "_SO", tmp_path_factory.mktemp("jax_native") / "libksstpu_oracle_hot.so")
    mp.setattr(jh, "_lib", None)
    mp.setattr(jh, "_tried", False)
    assert jh.available()
    yield jh
    mp.undo()


def test_map_spawned_gives_each_worker_one_blas_thread(monkeypatch):
    import os

    from kss_icp_torch.native import BLAS_THREADS, map_spawned

    monkeypatch.setenv(BLAS_THREADS[0], "7")
    monkeypatch.delenv(BLAS_THREADS[1], raising=False)
    assert map_spawned(os.getenv, list(BLAS_THREADS) * 2, 2) == ["1"] * (2 * len(BLAS_THREADS))
    assert os.environ[BLAS_THREADS[0]] == "7" and BLAS_THREADS[1] not in os.environ


def test_native_flags_are_jax_flags():
    from kss_icp_tpu.native import oracle_hot as jh

    assert '", "'.join(th.GXX_FLAGS) in inspect.getsource(jh._build)


def test_native_twin_matches_jax(jax_native, resampled):
    cloud_s, cloud_t = resampled
    ir = to.OracleInitRegistration(cloud_s, cloud_t)
    tree_t, tree_j = th.NativeKDTree(cloud_t), jax_native.NativeKDTree(cloud_t)
    field = th.rotation_scan(ir.point_source, tree_t, 8.0)
    _same(field, jax_native.rotation_scan(ir.point_source, tree_j, 8.0))
    # float32 points against the float64 field (chip_smoke.py phase 4m's bar).
    np.testing.assert_allclose(field, ir.value, rtol=1e-5)
    assert tree_t.mean_nn(cloud_s) == tree_j.mean_nn(cloud_s)
    moved = ir.rotate(cloud_s)
    got, want = th.icp_native(moved, tree_t), jax_native.icp_native(moved, tree_j)
    _same(got[0], want[0])
    assert got[1:] == want[1:] and got[2] > 1
    assert th.icp_native(moved, tree_t, max_iterations=2)[1:] == jax_native.icp_native(moved, tree_j, 2)[1:]


def test_native_signatures_match_jax():
    from kss_icp_tpu.native import oracle_hot as jh

    for name in ("rotation_scan", "icp_native", "available"):
        assert inspect.signature(getattr(th, name)) == inspect.signature(getattr(jh, name)), name


def test_native_build_failure_raises(monkeypatch):
    def fail(*a, **kw):
        raise NativeBuildError("g++ failed")

    th.library.cache_clear()
    monkeypatch.setattr(th, "build", fail)
    assert not th.available()
    with pytest.raises(NativeBuildError):
        th.NativeKDTree(np.zeros((4, 3)))
    monkeypatch.undo()
    assert th.available()


# ---------------------------------------------------------------------------
# stress.py against kss_icp_tpu.stress
# ---------------------------------------------------------------------------


def test_remesh_corpus_matches_jax():
    got, want = ts.remesh_corpus(), js.remesh_corpus()
    assert len(got) == len(want) == 25
    for (n1, s1, t1, r1), (n2, s2, t2, r2) in zip(got, want):
        assert n1 == n2 and r1 == r2
        _same(s1, s2)
        _same(t1, t2)
    with pytest.raises(ValueError):
        ts.remesh_corpus(data=ts.REMESH / "elsewhere")


def test_stress_constants_match_jax():
    for k in ("DATA", "MODELS", "HARD", "REMESH", "GOLDEN_ROOT", "GOLDEN_SETS", "FIXTURE_NPZ", "FIXTURE_JSON",
              "_AXES", "_ANGLES", "_SCALES", "_SHIFTS"):
        assert getattr(ts, k) == getattr(js, k), k
    for args in [(0.1, 0.2, 0.3), (2.8, 1.9, 0.9)]:
        _same(ts.rot_xyz(*args), js.rot_xyz(*args))
    names = [f"m{i}" for i in range(7)]
    assert [dataclasses.astuple(r) for r in ts.remesh_records(names)] == \
        [dataclasses.astuple(r) for r in js.remesh_records(names)]


def _write_count(path, pts):
    path.write_text(f"{len(pts)}\n" + "".join(f"{x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in pts))


def test_remesh_halves_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    for name in ("b_model", "a_model", "c_model"):
        v = rng.uniform(-2, 3, (101, 3))
        (tmp_path / f"{name}.off").write_text(
            "OFF\n101 0 0\n" + "".join(f"{x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in v))
    got = ts.remesh_corpus(tmp_path, seed=5, protocol="halves")
    want = js.remesh_corpus(tmp_path, seed=5, protocol="halves")
    assert [g[0] for g in got] == ["a_model", "b_model", "c_model"]
    for (n1, s1, t1, r1), (n2, s2, t2, r2) in zip(got, want):
        assert n1 == n2 and r1 == r2
        _same(s1, s2)
        _same(t1, t2)


def test_stress_and_golden_corpus_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    for name in ("Cat", "ant"):
        _write_count(tmp_path / f"{name}.wlop", rng.uniform(-1, 1, (60, 3)))
    got, want = ts.stress_corpus(["Cat", "ant"], tmp_path), js.stress_corpus(["Cat", "ant"], tmp_path)
    assert [g[0] for g in got] == [w[0] for w in want] == [f"{m}/h{k}" for m in ("Cat", "ant") for k in range(3)]
    for (_, s1, t1), (_, s2, t2) in zip(got, want):
        _same(s1, s2)
        _same(t1, t2)
    with pytest.raises(Exception) as e_port:
        ts.stress_corpus(["Cat", "Missing"], tmp_path)
    with pytest.raises(Exception) as e_jax:
        js.stress_corpus(["Cat", "Missing"], tmp_path)
    assert type(e_port.value) is type(e_jax.value)

    root = tmp_path / "golden"
    for subdir in ("registration", "registration_scale"):
        d = root / subdir
        d.mkdir(parents=True)
        for name in ("Dog", "Bunny"):
            _write_count(d / f"{name}.gird", rng.uniform(-1, 1, (40, 3)))
            _write_count(d / f"{name}.wlop", rng.uniform(-1, 1, (50, 3)))
        _write_count(d / "Orphan.gird", rng.uniform(-1, 1, (40, 3)))  # no .wlop: not a pair
    got, want = ts.golden_corpus(root), js.golden_corpus(root)
    assert [g[0] for g in got] == [w[0] for w in want] == ["Bunny", "Dog", "s/Bunny", "s/Dog"]
    for (_, s1, t1), (_, s2, t2) in zip(got, want):
        _same(s1, s2)
        _same(t1, t2)
    assert ts.golden_corpus(tmp_path / "absent") == js.golden_corpus(tmp_path / "absent") == []


# ---------------------------------------------------------------------------
# utils/profiling.py against kss_icp_tpu.utils.profiling
# ---------------------------------------------------------------------------


def test_stage_timer_sums_and_emits_as_jax():
    lines = {}
    for tag, cls in (("port", StageTimer), ("jax", jp.StageTimer)):
        stream = io.StringIO()
        timer = cls(emit=True, stream=stream)
        for name in ("resample", "coarse", "resample"):
            with timer.stage(name):
                pass
        with pytest.raises(KeyError), timer.stage("icp"):
            raise KeyError("inside a stage")
        summary = timer.summary()
        assert list(summary) == ["resample", "coarse", "icp"] and all(v >= 0 for v in summary.values())
        lines[tag] = [json.loads(line) for line in stream.getvalue().splitlines()]
    assert [sorted(x) for x in lines["port"]] == [sorted(x) for x in lines["jax"]] == [["seconds", "stage"]] * 4
    assert [x["stage"] for x in lines["port"]] == [x["stage"] for x in lines["jax"]]
    assert inspect.signature(StageTimer) == inspect.signature(jp.StageTimer)
    silent = StageTimer(stream=io.StringIO())
    with silent.stage("x"):
        pass
    assert silent.stream.getvalue() == ""


def test_trace_annotation_reraises_and_names_a_span():
    ran = []
    with pytest.raises(ValueError, match="body"):
        with trace_annotation("kss_oracle_span"):
            ran.append(1)
            raise ValueError("body")
    assert ran == [1]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace_annotation("kss_oracle_span"):
            torch.ones(4).sum()
    assert "kss_oracle_span" in {e.key for e in prof.key_averages()}
