"""The port's transfer tools (kss_icp_torch/transfer.py), k-NN
(kss_icp_torch/ops/nn.py::knn) and support radius
(kss_icp_torch/ops/spatial.py::estimate_radius) against the JAX package on
seeded numpy inputs: records and their log round trips exactly, the
perturbations at 1e-12 in float64, k-NN indices equal on tie-free clouds and
the lower index on built ties, the port's one row-blocked path against both
of JAX's (the dense one and the streaming one), both radius estimates at
rtol 1e-5, and pair generation (make_pair, generate_fixture_set).

k-NN squared distances: the port's are exact float32 differences, held to
float64 at rtol 1e-6; JAX's come from the ‖a‖² + ‖b‖² − 2ab expansion, whose
rounding is absolute, about 3 float32 ulps of ‖a‖² + ‖b‖² (up to 2e-6 for
clouds in [-1, 1]³), so the two agree at rtol 1e-5 beside that atol."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kss_icp_torch import transfer as tt
from kss_icp_torch.ops import nn as tnn
from kss_icp_torch.ops.spatial import estimate_radius
from kss_icp_tpu import transfer as jt
from kss_icp_tpu.ops import nn as jnn
from kss_icp_tpu.ops import spatial as jsp

torch.set_num_threads(1)

LOG = "ant x:1.56\nGirl x: 1.1\nCat y:-0.5 s:1.25 t:0.3\n\nbox z:2e-1 t:-1.5\nplain\n"


def test_records_and_log_round_trip(tmp_path):
    recs = tt.parse_transfer_log(LOG)
    assert [dataclass_tuple(r) for r in recs] == [dataclass_tuple(r) for r in jt.parse_transfer_log(LOG)]
    assert [r.line() for r in recs] == [r.line() for r in jt.parse_transfer_log(LOG)]
    mine, theirs = tmp_path / "t.txt", tmp_path / "j.txt"
    tt.save_transfer_log(mine, recs)
    jt.save_transfer_log(theirs, jt.parse_transfer_log(LOG))
    assert mine.read_bytes() == theirs.read_bytes()
    assert tt.load_transfer_log(mine) == recs


def dataclass_tuple(r):
    return (r.name, r.axis, r.angle, r.scale, r.translation)


@pytest.mark.parametrize("axis", ["x", "y", "z"])
def test_rotations_and_apply_record(axis):
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(200, 3))
    angle = float(rng.uniform(-3, 3))
    np.testing.assert_allclose(tt.axis_rotation_matrix(axis, angle), jt.axis_rotation_matrix(axis, angle),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(tt.inverse_rotation(tt.TransferRecord("a", axis, angle)),
                               jt.inverse_rotation(jt.TransferRecord("a", axis, angle)), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tt.rotate_axis(pts, axis, angle), jt.rotate_axis(pts, axis, angle), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tt.scale_about_centroid(pts, 1.3), jt.scale_about_centroid(pts, 1.3), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(tt.translate_uniform(pts, -0.4), jt.translate_uniform(pts, -0.4), rtol=0, atol=1e-12)
    for scale, trans in ((1.0, 0.0), (0.8, 0.0), (1.0, 0.25), (1.7, -2.0)):
        rec = tt.TransferRecord("a", axis, angle, scale, trans)
        got = tt.apply_record(pts, rec)
        want = jt.apply_record(pts, jt.TransferRecord("a", axis, angle, scale, trans))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        # bench-dir's ground truth: the perturbation undone.
        np.testing.assert_allclose(tt.unapply_record(got, rec), pts, rtol=0, atol=1e-12)


def test_save_pair_writes_jax_files(tmp_path):
    rng = np.random.default_rng(4)
    rec = tt.TransferRecord("m0", "y", 0.7)
    tgt, src = rng.normal(size=(90, 3)), rng.normal(size=(40, 3))
    paths = tt.save_pair(tt.TransferPair("m0", tgt, src, rec, 0.1), tmp_path / "t")
    jpaths = jt.save_pair(jt.TransferPair("m0", tgt, src, jt.TransferRecord("m0", "y", 0.7), 0.1), tmp_path / "j")
    assert [p.name for p in paths] == [p.name for p in jpaths] == ["m0.wlop", "m0.gird"]
    for mine, theirs in zip(paths, jpaths):
        assert mine.read_bytes() == theirs.read_bytes()


def test_pair_generation_needs_wlop(tmp_path):
    """make_pair and generate_fixture_set against JAX's (the WLOP they once
    waited for is ported): at a given grid cell the `.gird` source is JAX's
    bit for bit and the `.wlop` target holds the WLOP bar (median |Δ| 5e-5,
    max 2e-3 bounding-box diagonals; tests/test_torch_wlop.py); at the
    default cell the source is JAX's grid at the port's radius (exact float32
    differences, within rtol 1e-5 of JAX's expansion-form radius); the files
    round-trip through save_pair, and transfer.txt is JAX's bytes."""
    from helpers import random_cloud

    from kss_icp_torch.io.formats import load_points
    from kss_icp_tpu.ops.simplify import grid_simplify

    pts = random_cloud(np.random.default_rng(8), 1500)
    diag = np.linalg.norm(pts.max(0) - pts.min(0))
    rec = tt.TransferRecord("m", "z", 0.9, 1.2, 0.1)
    jrec = jt.TransferRecord("m", "z", 0.9, 1.2, 0.1)
    got = tt.make_pair(pts, rec, wlop_points=400, grid_cell=0.07, device="cpu")
    want = jt.make_pair(pts, jrec, wlop_points=400, grid_cell=0.07)
    assert got.radius == want.radius and got.name == "m" and got.record == rec
    assert got.source.dtype == want.source.dtype == np.float64
    np.testing.assert_array_equal(got.source, want.source)
    assert got.target.shape == want.target.shape == (400, 3)
    d = np.linalg.norm(got.target - want.target, axis=1) / diag
    assert np.median(d) <= 5e-5 and d.max() <= 2e-3

    default = tt.make_pair(pts, rec, wlop_points=400, device="cpu")
    assert default.radius == tt.estimate_radius(pts, device="cpu")
    assert default.radius == pytest.approx(jt.estimate_radius(pts), rel=1e-5)
    padded = np.zeros((1536, 3), np.float32)
    padded[:1500] = pts
    gp, gm = grid_simplify(jnp.asarray(padded), jnp.asarray(np.arange(1536) < 1500), default.radius / 1.5)
    np.testing.assert_array_equal(default.source, jt.apply_record(np.asarray(gp, np.float64)[np.asarray(gm)], jrec))

    clouds = [("m", pts), ("n", random_cloud(np.random.default_rng(9), 900))]
    records = [rec, tt.TransferRecord("n", "x", -0.4)]
    pairs = tt.generate_fixture_set(clouds, records, tmp_path / "t", device="cpu", wlop_points=300,
                                    grid_cell=0.08)
    jpairs = jt.generate_fixture_set(clouds, [jrec, jt.TransferRecord("n", "x", -0.4)], tmp_path / "j",
                                     wlop_points=300, grid_cell=0.08)
    assert (tmp_path / "t" / "transfer.txt").read_bytes() == (tmp_path / "j" / "transfer.txt").read_bytes()
    for pair, jpair in zip(pairs, jpairs):
        assert (tmp_path / "t" / f"{pair.name}.gird").read_bytes() == (tmp_path / "j" / f"{pair.name}.gird").read_bytes()
        np.testing.assert_allclose(load_points(tmp_path / "t" / f"{pair.name}.gird"), pair.source, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(load_points(tmp_path / "t" / f"{pair.name}.wlop"), pair.target, rtol=1e-5, atol=1e-5)
        assert load_points(tmp_path / "t" / f"{pair.name}.wlop").shape == jpair.target.shape


def _cloud(n, seed):
    return np.random.default_rng(seed).uniform(-1, 1, size=(n, 3)).astype(np.float32)


def _jax_knn(q, r, m, k, **kw):
    d2, idx = jnn.knn(jnp.asarray(q), jnp.asarray(r), jnp.asarray(m), k, **kw)
    return np.asarray(d2), np.asarray(idx)


def _torch_knn(q, r, m, k, **kw):
    d2, idx = tnn.knn(torch.as_tensor(q), torch.as_tensor(r), torch.as_tensor(m), k, **kw)
    return d2.numpy(), idx.numpy()


EXPANSION_ATOL = 2e-6  # JAX's expansion rounding on clouds in [-1, 1]^3 (module docstring)


def _assert_distances(d2, jd2):
    """The port's d2 against JAX's: the same masked (1e30) entries, the valid
    ones at rtol 1e-5 beside the expansion's rounding."""
    valid = d2 < 1e29
    np.testing.assert_array_equal(valid, jd2 < 1e29)
    np.testing.assert_allclose(d2[valid], jd2[valid], rtol=1e-5, atol=EXPANSION_ATOL)


# JAX's k-NN paths: dense, and streaming at two tilings.
JAX_PATHS = [{}, dict(query_chunk=96, ref_chunk=128), dict(query_chunk=512, ref_chunk=50)]


@pytest.mark.parametrize("chunks", JAX_PATHS, ids=["dense", "streaming", "streaming-small-tiles"])
def test_knn_matches_jax(chunks):
    q, r = _cloud(300, 0), _cloud(700, 1)
    m = np.random.default_rng(2).uniform(size=700) < 0.8
    d2, idx = _torch_knn(q, r, m, 13)
    jd2, jidx = _jax_knn(q, r, m, 13, **chunks)
    assert d2.shape == idx.shape == (300, 13)
    _assert_distances(d2, jd2)
    exact = ((q[:, None, :].astype(np.float64) - r[idx].astype(np.float64)) ** 2).sum(-1)
    np.testing.assert_allclose(d2, exact, rtol=1e-6)
    np.testing.assert_array_equal(idx, jidx)  # random clouds have no ties
    assert np.all(np.diff(d2, axis=1) >= 0) and m[idx].all()


@pytest.mark.parametrize("chunks", [{}, dict(query_chunk=8, ref_chunk=16)], ids=["dense", "streaming"])
def test_knn_takes_the_lower_index_on_ties(chunks):
    """Every query at the centre of a cube whose corners are repeated: the
    equal distances come back in index order, as jax.lax.top_k's."""
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], np.float32)
    r = np.concatenate([corners, corners[::-1], corners])  # 24 rows, every one at squared distance 3
    q = np.zeros((5, 3), np.float32)
    m = np.ones(len(r), bool)
    m[3] = False
    d2, idx = _torch_knn(q, r, m, 10)
    jd2, jidx = _jax_knn(q, r, m, 10, **chunks)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(d2, jd2)
    assert idx[0].tolist() == [0, 1, 2, 4, 5, 6, 7, 8, 9, 10]


def test_knn_with_fewer_references_than_k():
    """k above R is refused, by the port and by JAX's dense path (jax.lax.top_k)."""
    q, r = _cloud(20, 5), _cloud(6, 6)
    m = np.ones(6, bool)
    for knn in (_torch_knn, _jax_knn):
        with pytest.raises(ValueError):
            knn(q, r, m, 9)


def test_knn_row_blocks_give_one_blocks_answer(monkeypatch):
    """Blocks of 7 query rows (a ragged last one) and a batch axis: the same
    bits as one block, and JAX's answer row by row."""
    q = np.stack([_cloud(50, 20), _cloud(50, 21)])
    r = np.stack([_cloud(90, 22), _cloud(90, 23)])
    m = np.random.default_rng(24).uniform(size=(2, 90)) < 0.9
    whole = _torch_knn(q, r, m, 5)
    monkeypatch.setattr(tnn, "_KNN_BLOCK_ELEMS", 7 * 90)
    blocked = _torch_knn(q, r, m, 5)
    for a, b in zip(whole, blocked):
        np.testing.assert_array_equal(a, b)
    for i in range(2):
        jd2, jidx = _jax_knn(q[i], r[i], m[i], 5)
        np.testing.assert_array_equal(blocked[1][i], jidx)
        _assert_distances(blocked[0][i], jd2)


def test_estimate_radius_matches_jax():
    pts = _cloud(500, 9) * np.float32([1.0, 2.0, 0.5])
    assert tt.estimate_radius(pts, device="cpu") == pytest.approx(jt.estimate_radius(pts), rel=1e-5)
    padded = np.zeros((768, 3), np.float32)
    padded[:500] = pts
    mask = np.zeros(768, bool)
    mask[:500] = True
    got = float(estimate_radius(torch.as_tensor(padded), torch.as_tensor(mask)))
    want = float(jsp.estimate_radius(jnp.asarray(padded), jnp.asarray(mask)))
    assert got == pytest.approx(want, rel=1e-5)
    assert got == pytest.approx(tt.estimate_radius(pts, device="cpu"), rel=1e-6)
