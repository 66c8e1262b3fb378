"""The port's native reader (kss_icp_torch/native, fastio.cpp built with g++)
against the port's Python readers and the JAX package's loader, on
tests/test_native.py's inputs: equal arrays, the native and Python writers'
equal bytes, the threaded batch loader, a refused file falling to the Python
readers and counted, and a failed build raising with the compiler's output."""

import numpy as np
import pytest

from kss_icp_torch import native
from kss_icp_torch.io import formats as tf
from kss_icp_tpu.io import formats as jf


def _both(p):
    """The native array, the port's Python reader's and JAX's load_points'."""
    return native.load_points_native(p), tf.load_points(p, prefer_native=False), jf.load_points(p)


def test_count_format_parity(tmp_path, rng):
    p = tmp_path / "a.xyz"
    tf.save_xyz(p, rng.normal(size=(123, 3)))
    a, b, c = _both(p)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c)
    np.testing.assert_array_equal(tf.load_points(p), a)


@pytest.mark.parametrize("fmt", ["binary_little_endian", "ascii"])
def test_ply_parity(tmp_path, rng, fmt):
    pts = rng.normal(size=(57, 3)).astype(np.float32)
    p = tmp_path / "b.ply"
    tf.save_ply(p, pts, faces=np.array([[0, 1, 2]]), fmt=fmt)
    a, b, c = _both(p)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c)
    np.testing.assert_allclose(a, pts, atol=1e-7 if fmt == "ascii" else 0)


def test_ascii_ply_extra_property_off_and_obj(tmp_path):
    ply = tmp_path / "c.ply"
    ply.write_text("ply\nformat ascii 1.0\nelement vertex 2\nproperty float x\nproperty float y\nproperty float z\n"
                   "property float quality\nend_header\n1 2 3 9\n4 5 6 9\n")
    off = tmp_path / "d.off"
    off.write_text("OFF\n3 1 0\n0 0 0\n1 0 0\n0 1 0\n3 0 1 2\n")
    obj = tmp_path / "e.obj"
    obj.write_text("v 1 2 3\nvn 0 0 1\nv 4 5 6\nf 1 2\n")
    for p in (ply, off, obj):
        a, b, c = _both(p)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_writer_bytes_and_truncation(tmp_path, rng):
    pts = rng.normal(size=(123, 3))
    for name, prefer in (("n.xyz", True), ("p.xyz", False)):
        tf.save_xyz(tmp_path / name, pts, prefer_native=prefer)
    jf.save_xyz(tmp_path / "j.xyz", pts)
    assert native.save_xyz_native(tmp_path / "m.xyz", pts)
    data = {n: (tmp_path / n).read_bytes() for n in ("n.xyz", "p.xyz", "j.xyz", "m.xyz")}
    assert len(set(data.values())) == 1
    assert data["n.xyz"].decode().splitlines()[0] == "123"
    tf.save_xyz(tmp_path / "n.xyz", pts[:10])
    assert tf.load_points(tmp_path / "n.xyz").shape == (10, 3)
    assert not native.save_xyz_native(tmp_path / "bad.xyz", pts[:, :2])


def test_batch_loader_and_refused_files(tmp_path, rng):
    """load_points_batch gives each file's array on the parser's threads; a
    missing file and a big-endian PLY (which the parser does not read) are
    None there and counted; load_points reads the PLY with the Python reader,
    as JAX does."""
    paths = []
    for i in range(5):
        paths.append(tmp_path / f"c{i}.xyz")
        tf.save_xyz(paths[-1], rng.normal(size=(50 + 10 * i, 3)))
    big = tmp_path / "big.ply"
    tf.save_ply(big, rng.normal(size=(20, 3)).astype(np.float32), fmt="binary_big_endian")
    missing = tmp_path / "missing.xyz"
    before = native.load_points_native.refused
    out = native.load_points_batch(paths + [big, missing])
    assert out[-2:] == [None, None] and native.load_points_native.refused == before + 2
    for p, o in zip(paths, out):
        np.testing.assert_array_equal(o, tf.load_points(p, prefer_native=False))
    assert native.load_points_native(missing) is None
    np.testing.assert_array_equal(tf.load_points(big), tf.load_points(big, prefer_native=False))
    np.testing.assert_array_equal(tf.load_points(big), jf.load_points(big))
    assert native.load_points_native.refused == before + 5  # the missing file once more, the PLY twice


def test_failed_build_raises_with_the_compilers_output(tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("extern \"C\" int f() { return undeclared_name; }\n")
    with pytest.raises(native.NativeBuildError, match="undeclared_name"):
        native.build(bad, tmp_path / "out")
    assert not list((tmp_path / "out").glob("*.so"))
    lib = native.build(native.SRC, tmp_path / "out")
    assert lib.exists() and native.build(native.SRC, tmp_path / "out") == lib
