"""hierarchy_simplify (kss_icp_torch/ops/simplify.py) against JAX's jitted
function: the kept set equal on the JAX tests' clouds, an 8192-point sphere
and lattice, with the variation stop on, on clouds whose points sit near
their cluster's barycentre at equal distances, and the same bits on many CPU
threads as on one; and the properties of tests/test_simplify.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import random_cloud
from kss_icp_torch.ops import simplify as ts
from kss_icp_torch.ops.spatial import segment_reduce
from kss_icp_tpu.ops.simplify import hierarchy_simplify as jax_hierarchy

torch.set_num_threads(1)


def _both(pts, mask, **kw):
    """(port's keep, JAX's keep, port's points) on the same float32 inputs."""
    out, keep = ts.hierarchy_simplify(torch.as_tensor(pts), torch.as_tensor(mask), **kw)
    _, jkeep = jax_hierarchy(jnp.asarray(pts), jnp.asarray(mask), **kw)
    return keep.numpy(), np.asarray(jkeep), out.numpy()


def _sphere(n, seed=0):
    v = np.random.default_rng(seed).normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True) * 3.7 + np.array([5.0, -2.0, 1.0])).astype(np.float32)


def _lattice(n):
    k = int(np.ceil(n ** (1 / 3)))
    g = np.stack(np.meshgrid(*[np.arange(k)] * 3, indexing="ij"), -1).reshape(-1, 3)[:n]
    return (g * 0.1).astype(np.float32)


def _wavy_512():
    """tests/test_simplify.py::test_hierarchy_simplify_variation_stop's cloud."""
    rng = np.random.default_rng(0)
    u, v = rng.uniform(-1, 1, 512), rng.uniform(-1, 1, 512)
    return np.stack([u, v, 0.5 * np.sin(4 * u) * np.cos(4 * v)], -1).astype(np.float32)


CASES = {
    "wavy 1024, cluster 16": (lambda: random_cloud(np.random.default_rng(0), 1024).astype(np.float32), 1024, 16),
    "wavy 2048, cluster 32": (lambda: random_cloud(np.random.default_rng(0), 2048).astype(np.float32), 2048, 32),
    "sphere 8192, cluster 10": (lambda: _sphere(8192), 8192, 10),
    "lattice 8192, cluster 10": (lambda: _lattice(8192), 8192, 10),
}


@pytest.mark.parametrize("case", list(CASES))
def test_hierarchy_kept_set_matches_jax(case):
    """The kept set equal to JAX's; the lattice puts points exactly on the
    split planes, where a mean rounded otherwise (a reciprocal for the
    division) parts on hundreds of points."""
    make, n, cluster = CASES[case]
    pts = make()
    keep, jkeep, out = _both(pts, np.ones(n, bool), max_cluster_size=cluster)
    np.testing.assert_array_equal(keep, jkeep)
    np.testing.assert_array_equal(out[keep], pts[keep])
    assert (out[~keep] == 0).all()


@pytest.mark.parametrize("cluster, variation", [(256, 0.01), (10, 0.05), (64, 0.1)])
def test_hierarchy_variation_stop_matches_jax(cluster, variation):
    """max_variation < 1/3 (the covariance eigenvalues per cluster) keeps
    JAX's set, and splits deeper than the size cap alone."""
    pts = _wavy_512()
    keep, jkeep, _ = _both(pts, np.ones(512, bool), max_cluster_size=cluster, max_variation=variation)
    np.testing.assert_array_equal(keep, jkeep)
    size_only, _, _ = _both(pts, np.ones(512, bool), max_cluster_size=cluster)
    assert keep.sum() >= size_only.sum()


def test_hierarchy_respects_the_mask_like_jax():
    pts = random_cloud(np.random.default_rng(0), 256).astype(np.float32)
    pts[200:] = 1e5
    mask = np.arange(256) < 200
    keep, jkeep, out = _both(pts, mask, max_cluster_size=8)
    np.testing.assert_array_equal(keep, jkeep)
    assert not keep[200:].any() and np.abs(out[keep]).max() < 10.0


def _tie_clouds(n_clouds):
    """Eight points in four pairs mirrored about a centre: each pair sits at
    one distance from the barycentre up to rounding, so the pick reads the
    last bit of the squared distances."""
    rng = np.random.default_rng(0)
    for _ in range(n_clouds):
        c, a = rng.uniform(-3, 3, 3), rng.uniform(-1, 1, (4, 3))
        yield np.concatenate([c + a, c - a]).astype(np.float32)


def test_hierarchy_barycentre_picks_round_as_jax():
    """The pick nearest the barycentre on mirrored pairs (one cluster of 8):
    XLA contracts the squared distance into fused multiply-adds
    (ops/spatial.py::sq_norm_fma); summed squares rounded one by one pick the
    other point of a pair on about 2% of these clouds."""
    rounded_apart = 0
    for pts in _tie_clouds(400):
        keep, jkeep, _ = _both(pts, np.ones(8, bool), max_cluster_size=16)
        np.testing.assert_array_equal(keep, jkeep)
        t = torch.as_tensor(pts)
        d = t - t.mean(dim=0)
        plain = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
        rounded_apart += int(torch.argmin(plain)) != int(np.nonzero(keep)[0][0])
    assert rounded_apart > 0  # the probe reaches the rounding it is there for


def test_hierarchy_is_the_same_on_many_threads():
    """At 40960 points the CPU's segment sums run serially whatever the thread
    count (torch adds float32 rows of 32768+ elements with atomic adds across
    threads outside deterministic mode), so each run keeps one set."""
    pts = torch.as_tensor(_sphere(40960, 1))
    mask = torch.ones(40960, dtype=torch.bool)
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        keeps = [ts.hierarchy_simplify(pts, mask, 10)[1] for _ in range(2)]
        vals = torch.arange(40960 * 3, dtype=torch.float32).reshape(-1, 3).sin()
        seg = torch.randint(0, 7, (40960,), generator=torch.Generator().manual_seed(0))
        sums = [segment_reduce(vals, seg, 7, "sum", 0.0) for _ in range(4)]
    finally:
        torch.set_num_threads(before)
    assert torch.equal(keeps[0], keeps[1])
    assert all(torch.equal(s, sums[0]) for s in sums)
    assert torch.equal(sums[0], segment_reduce(vals, seg, 7, "sum", 0.0))  # and one thread's bits
    assert not torch.are_deterministic_algorithms_enabled()


# The properties of tests/test_simplify.py's hierarchy tests, on the port.

def test_hierarchy_cluster_size_bound():
    pts = random_cloud(np.random.default_rng(0), 1024).astype(np.float32)
    out, keep = ts.hierarchy_simplify(torch.as_tensor(pts), torch.ones(1024, dtype=torch.bool), 16)
    kept = out.numpy()[keep.numpy()]
    assert 1024 // 16 <= kept.shape[0] <= 1024
    assert ((kept[:, None] - pts[None]) ** 2).sum(-1).min(1).max() < 1e-10


def test_hierarchy_reduces_count():
    pts = random_cloud(np.random.default_rng(0), 2048).astype(np.float32)
    _, keep = ts.hierarchy_simplify(torch.as_tensor(pts), torch.ones(2048, dtype=torch.bool), 32)
    assert int(keep.sum()) < 2048 // 4


def test_hierarchy_flat_plane_ignores_the_variation_stop():
    flat = _wavy_512()
    flat[:, 2] = 0.0
    t, m = torch.as_tensor(flat), torch.ones(512, dtype=torch.bool)
    assert int(ts.hierarchy_simplify(t, m, 64)[1].sum()) == int(ts.hierarchy_simplify(t, m, 64, 0.01)[1].sum())


def test_hierarchy_matches_the_tools_record(tmp_path):
    """At the CLI's cluster size 10 on the four 40960-point originals of
    fixtures/torch_port_expected_tools.json (written and read back as the CLI
    reads them), and on `simplify -m hierarchy`'s handg source: JAX's kept
    indices exactly."""
    import json
    from pathlib import Path

    from kss_icp_torch.challenge import _instance
    from kss_icp_torch.io.formats import load_points, save_xyz

    fixtures = Path(__file__).resolve().parents[1] / "fixtures"
    rec = json.loads((fixtures / "torch_port_expected_tools.json").read_text())
    with np.load(fixtures / "torch_port_expected_tools.npz") as z:
        arrays = {k: z[k] for k in z.files}
    for o in rec["originals"]:
        save_xyz(tmp_path / "c.xyz", _instance(o["family"], 0, o["n"], sample=0))
        pts = load_points(tmp_path / "c.xyz").astype(np.float32)
        _, keep = ts.hierarchy_simplify(torch.as_tensor(pts), torch.ones(len(pts), dtype=torch.bool), 10)
        np.testing.assert_array_equal(np.nonzero(keep.numpy())[0], arrays[f"{o['name']}_hierarchy"])
    meta = json.loads((fixtures / "remesh_transfer.json").read_text())
    name = rec["cli_hierarchy"]["name"]
    assert any(r["name"] == name for r in meta)
    with np.load(fixtures / "remesh_transfer.npz") as z:
        save_xyz(tmp_path / "h.xyz", z[name + "_src"])
    pts = load_points(tmp_path / "h.xyz").astype(np.float32)
    _, keep = ts.hierarchy_simplify(torch.as_tensor(pts), torch.ones(len(pts), dtype=torch.bool), 10)
    np.testing.assert_array_equal(np.nonzero(keep.numpy())[0], arrays["cli_hierarchy"])
