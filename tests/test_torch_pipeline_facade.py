"""The preprocessing facade (kss_icp_torch/pipeline.py) and the
content-hashed cache (kss_icp_torch/utils/cache.py) against the JAX
package's on the same seeded inputs: the radius within rtol 1e-6 (and within
1e-6 of its float64 value), border and count equal, the grid
build_voxel_grid's, unit normals equal to estimate_oriented_normals' on the
same input, the `.normal` sidecar read back when its count matches;
content_key JAX's string; and the properties of
tests/test_pipeline_facade.py."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import kss_icp_tpu.pipeline as jpipe
from helpers import random_cloud
from kss_icp_torch import pipeline as tpipe
from kss_icp_torch.io.formats import load_normals, save_normals, save_xyz, uniform_normalize
from kss_icp_torch.ops.normals import estimate_oriented_normals
from kss_icp_torch.ops.spatial import build_voxel_grid
from kss_icp_torch.utils import cache as tcache
from kss_icp_tpu.utils import cache as jcache

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _radius_f64(points, k=12):
    p = np.asarray(points, np.float32).astype(np.float64)
    d2 = ((p[:, None] - p[None]) ** 2).sum(-1)
    return float(np.sqrt(np.sort(d2, axis=1)[:, k]).max())


def _assert_grid(state):
    grid = build_voxel_grid(torch.as_tensor(state.points), torch.as_tensor(state.mask), state.boxes_per_axis)
    for got, want in zip(state.grid, grid):
        assert torch.equal(got, want)


@pytest.mark.parametrize("n, scale", [(400, 1.0), (700, 4.0)])
def test_pipeline_without_uniform_matches_jax(n, scale):
    pts = random_cloud(np.random.default_rng(n), n, scale)
    st = tpipe.pipeline_from_points_without_uniform(pts, device="cpu")
    js = jpipe.pipeline_from_points_without_uniform(pts)
    assert st.count == js.count == n and st.boxes_per_axis == js.boxes_per_axis
    np.testing.assert_array_equal(st.border, js.border)
    np.testing.assert_array_equal(st.points, js.points)
    np.testing.assert_array_equal(st.mask, js.mask)
    assert st.radius == pytest.approx(js.radius, rel=1e-6)
    assert st.radius == pytest.approx(_radius_f64(pts), rel=1e-6)
    assert st.normals is None and st.uniform is None
    _assert_grid(st)
    np.testing.assert_array_equal(st.grid.counts.numpy(), np.asarray(js.grid.counts))
    np.testing.assert_array_equal(st.grid.center_point.numpy(), np.asarray(js.grid.center_point))


def test_pipeline_from_points_normals_are_the_oriented_normals():
    pts = random_cloud(np.random.default_rng(3), 300)
    st = tpipe.pipeline_from_points(pts, device="cpu")
    padded = np.zeros((512, 3), np.float32)
    padded[:300] = pts
    want = estimate_oriented_normals(torch.as_tensor(padded), torch.as_tensor(np.arange(512) < 300)).numpy()
    np.testing.assert_array_equal(st.normals[:300], want[:300])
    assert (st.normals[300:] == 0).all()
    np.testing.assert_allclose(np.linalg.norm(st.normals[:300], axis=1), 1.0, atol=1e-4)
    js = jpipe.pipeline_from_points(pts, cache=None)
    assert st.radius == pytest.approx(js.radius, rel=1e-6)
    np.testing.assert_array_equal(st.border, js.border)
    _assert_grid(st)


def test_pipeline_from_file_matches_jax_and_reads_the_sidecar(tmp_path):
    """Uniform normalization, radius, border and grid as JAX's; the sidecar
    written, then read back (its normals, not a recompute) when its count
    matches the cloud's, and replaced when it does not."""
    pts = random_cloud(np.random.default_rng(4), 280) * 3.0 + 1.0
    path = tmp_path / "cloud.xyz"
    save_xyz(path, pts)
    st = tpipe.pipeline_from_file(path, cache=tcache.ArrayCache(tmp_path / "cache"), device="cpu")
    sidecar = path.with_suffix(".normal")
    assert sidecar.exists() and load_normals(sidecar).shape == (280, 3)
    assert np.abs(st.points[:st.count]).max() <= 1.0 + 1e-6
    jdir = tmp_path / "jax"
    jdir.mkdir()
    save_xyz(jdir / "cloud.xyz", pts)
    js = jpipe.pipeline_from_file(jdir / "cloud.xyz", use_normal_sidecar=False)
    np.testing.assert_array_equal(st.points, js.points)
    np.testing.assert_array_equal(st.border, js.border)
    np.testing.assert_array_equal(st.uniform.center, js.uniform.center)
    assert st.uniform.scale == js.uniform.scale
    assert st.radius == pytest.approx(js.radius, rel=1e-6)
    _assert_grid(st)

    marked = np.tile(np.float32([[0.0, 0.0, 1.0]]), (280, 1))
    save_normals(sidecar, marked)
    st2 = tpipe.pipeline_from_file(path, device="cpu")
    np.testing.assert_array_equal(st2.normals[:280], marked)  # read back, not recomputed
    save_normals(sidecar, marked[:100])
    st3 = tpipe.pipeline_from_file(path, device="cpu")
    np.testing.assert_allclose(st3.normals[:280], st.normals[:280], atol=1e-5)  # count differs: recomputed
    assert load_normals(sidecar).shape == (280, 3)


def test_pipeline_cache_serves_the_normals(tmp_path):
    pts = random_cloud(np.random.default_rng(5), 200)
    cache = tcache.ArrayCache(tmp_path / "c")
    first = tpipe.pipeline_from_points(pts, cache=cache, device="cpu")
    key = tcache.content_key(np.asarray(pts, np.float32), op="oriented_normals", k=20)
    cache.put(key, normals=np.full((200, 3), 0.5, np.float32))
    assert (tpipe.pipeline_from_points(pts, cache=cache, device="cpu").normals[:200] == 0.5).all()
    assert np.abs(first.normals[:200]).max() <= 1.0


def test_pipeline_device_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.pipeline_from_points_without_uniform(random_cloud(np.random.default_rng(0), 50))


@pytest.mark.parametrize("params", [dict(op="oriented_normals", k=20), dict(op="test", k=3, note=None), {}])
def test_content_key_is_jax_string(params):
    rng = np.random.default_rng(6)
    arrays = (rng.normal(size=(10, 3)).astype(np.float32), np.arange(7, dtype=np.int32))
    assert tcache.content_key(*arrays, **params) == jcache.content_key(*arrays, **params)


def test_array_cache_default_directory(tmp_path):
    """$KSS_ICP_CACHE_DIR where it is set, as in JAX; else the port's own
    ~/.cache/kss_icp_torch, never the JAX package's directory."""
    code = "from kss_icp_torch.utils.cache import ArrayCache; print(ArrayCache().dir)"
    env = {k: v for k, v in os.environ.items() if k != "KSS_ICP_CACHE_DIR"}
    dirs = [subprocess.run([sys.executable, "-c", code], cwd=REPO, env=e, capture_output=True, text=True,
                           timeout=120).stdout.strip()
            for e in (env, dict(env, KSS_ICP_CACHE_DIR=str(tmp_path / "shared")))]
    assert dirs == [str(Path.home() / ".cache" / "kss_icp_torch"), str(tmp_path / "shared")]
    assert Path(dirs[0]) != Path.home() / ".cache" / "kss_icp_tpu"


def test_array_cache_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    cache = tcache.ArrayCache(tmp_path / "c")
    a = rng.normal(size=(10, 3))
    key = tcache.content_key(a, op="test", k=3)
    assert cache.get(key) is None
    cache.put(key, out=a * 2)
    np.testing.assert_allclose(cache.get(key)["out"], a * 2)
    assert tcache.content_key(a, op="test", k=4) != key
    assert tcache.content_key(a + 1e-9, op="test", k=3) != key
    (tmp_path / "c" / f"{key}.npz").write_bytes(b"corrupt")
    assert cache.get(key) is None  # a corrupt entry is a miss
    calls = []

    def double(x):
        calls.append(1)
        return x * 2

    assert np.array_equal(cache.memoize(double, a)[0], a * 2)
    assert np.array_equal(cache.memoize(double, a)[0], a * 2) and len(calls) == 1


def test_uniform_normalize_feeds_the_pipeline(tmp_path):
    pts = random_cloud(np.random.default_rng(7), 300) * 7.0 + np.array([5.0, -2.0, 9.0])
    save_xyz(tmp_path / "c.xyz", pts)
    st = tpipe.pipeline_from_file(tmp_path / "c.xyz", use_normal_sidecar=False, device="cpu")
    unit, info = uniform_normalize(np.loadtxt(tmp_path / "c.xyz", skiprows=1))
    np.testing.assert_array_equal(st.points[:300], unit.astype(np.float32))
    np.testing.assert_allclose(st.uniform.invert(st.points[:300].astype(np.float64)), pts, atol=1e-4)
    assert not (tmp_path / "c.normal").exists()
