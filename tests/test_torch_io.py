"""The port's point-cloud I/O (kss_icp_torch/io/formats.py) against the JAX
package's Python readers and writers (kss_icp_tpu/io/formats.py,
prefer_native=False) on files written to tmp_path from seeded numpy clouds:
every reader gives JAX's float64 arrays, and every writer writes JAX's
bytes."""

import numpy as np
import pytest

from kss_icp_torch.io import formats as tf
from kss_icp_tpu.io import formats as jf


@pytest.fixture()
def cloud():
    return np.random.default_rng(7).normal(size=(57, 3)) * [1.0, 20.0, 1e-3]


def _faces(n_vert, n_faces, seed=1):
    return np.random.default_rng(seed).integers(0, n_vert, size=(n_faces, 3))


def _same(a, b):
    assert a.dtype == b.dtype == np.float64
    np.testing.assert_array_equal(a, b)


def test_count_format_and_plain_text(tmp_path, cloud):
    count = tmp_path / "c.gird"
    jf.save_xyz(count, cloud, prefer_native=False)
    plain = tmp_path / "p.txt"
    np.savetxt(plain, cloud, fmt="%.9g")
    six = tmp_path / "six.wlop"  # count format with a normal after each point
    with open(six, "w") as f:
        f.write(f"{len(cloud)}\n")
        np.savetxt(f, np.hstack([cloud, -cloud]), fmt="%.7g")
    longer = tmp_path / "longer.xyz"  # a count below the rows given: the first `count` rows
    longer.write_text("2\n" + "\n".join(" ".join(map(str, p)) for p in cloud[:4]) + "\n")
    for path in (count, plain, six, longer):
        want = jf.load_points(path, prefer_native=False)
        _same(tf.load_points(path), want)
        _same(tf.load_xyz(path), jf.load_xyz(path))
    assert tf.load_points(longer).shape == (2, 3)
    _same(tf.load_normals(six), jf.load_normals(six))


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian", "binary_big_endian"])
@pytest.mark.parametrize("faces", [False, True])
def test_ply_written_by_either_package(tmp_path, cloud, fmt, faces):
    tris = _faces(len(cloud), 11) if faces else None
    mine, theirs = tmp_path / "t.ply", tmp_path / "j.ply"
    tf.save_ply(mine, cloud, tris, fmt=fmt)
    jf.save_ply(theirs, cloud, tris, fmt=fmt)
    assert mine.read_bytes() == theirs.read_bytes()
    _same(tf.load_points(mine), jf.load_points(theirs, prefer_native=False))
    tv, tt = tf.load_mesh(mine)
    jv, jt = jf.load_mesh(theirs)
    _same(tv, jv)
    np.testing.assert_array_equal(tt, jt)
    assert len(tt) == (11 if faces else 0)


def _ply_with_attributes(path, pts, normals, colors, fmt, polys):
    """A PLY with comments, obj_info, normals, colors and polygon faces. The
    binary ones also lead with a fixed-size element and give the face
    element a scalar before its list, which the binary readers skip; the
    ASCII reader of either package takes the vertex block first and a face
    row's first token as its count, so the ASCII file keeps to that."""
    bo = {"binary_little_endian": "<", "binary_big_endian": ">"}.get(fmt)
    header = (f"ply\nformat {fmt} 1.0\ncomment made for a test\nobj_info seeded\n"
              + ("element camera 1\nproperty float view\nproperty float zoom\n" if bo else "")
              + f"element vertex {len(pts)}\n"
              "property double x\nproperty double y\nproperty double z\n"
              "property float nx\nproperty float ny\nproperty float nz\n"
              "property uchar red\nproperty uchar green\nproperty uchar blue\n"
              f"element face {len(polys)}\n" + ("property uchar flags\n" if bo else "")
              + "property list uchar int vertex_indices\nend_header\n")
    if bo is None:
        lines = [" ".join(f"{float(v)!r}" for v in p) + " " + " ".join(f"{v:.7g}" for v in n) + " "
                 + " ".join(str(int(c)) for c in col) for p, n, col in zip(pts, normals, colors)]
        lines += [f"{len(q)} " + " ".join(map(str, q)) for q in polys]
        path.write_text(header + "\n".join(lines) + "\n")
        return
    row = np.dtype([("x", bo + "f8"), ("y", bo + "f8"), ("z", bo + "f8"), ("nx", bo + "f4"), ("ny", bo + "f4"),
                    ("nz", bo + "f4"), ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    v = np.empty(len(pts), row)
    for i, k in enumerate("xyz"):
        v[k] = pts[:, i]
    for i, k in enumerate(("nx", "ny", "nz")):
        v[k] = normals[:, i]
    for i, k in enumerate(("red", "green", "blue")):
        v[k] = colors[:, i]
    body = np.array([1, 2], bo + "f4").tobytes() + v.tobytes()
    for q in polys:
        body += np.array([7, len(q)], "u1").tobytes() + np.asarray(q, bo + "i4").tobytes()
    path.write_bytes(header.encode("ascii") + body)


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian", "binary_big_endian"])
def test_ply_with_normals_colors_and_polygons(tmp_path, cloud, fmt):
    rng = np.random.default_rng(3)
    normals = rng.normal(size=cloud.shape)
    colors = rng.integers(0, 256, size=cloud.shape)
    polys = [list(rng.integers(0, len(cloud), size=k)) for k in (3, 4, 5, 4)]
    path = tmp_path / "attr.ply"
    _ply_with_attributes(path, cloud, normals, colors, fmt, polys)
    _same(tf.load_ply(path), jf.load_ply(path))
    _same(tf.load_points(path), jf.load_points(path, prefer_native=False))
    np.testing.assert_allclose(tf.load_points(path), cloud, rtol=1e-15)
    tv, jv = tf.load_ply_vertex_data(path), jf.load_ply_vertex_data(path)
    assert sorted(tv) == sorted(jv) == ["colors", "normals", "points"]
    for k in tv:
        _same(tv[k], jv[k])
    tm, jm = tf.load_mesh(path), jf.load_mesh(path)
    _same(tm[0], jm[0])
    np.testing.assert_array_equal(tm[1], jm[1])
    assert len(tm[1]) == 1 + 2 + 3 + 2  # fan triangulation (0, t, t+1)


def test_ply_refusals_match(tmp_path):
    bad = tmp_path / "bad.ply"
    bad.write_bytes(b"ply\nformat ascii 1.0\nelement vertex 1\nproperty float x\n")
    for mod in (tf, jf):
        with pytest.raises(ValueError, match="end_header"):
            mod.load_ply(bad)
    listy = tmp_path / "list.ply"
    listy.write_text("ply\nformat ascii 1.0\nelement vertex 1\nproperty list uchar float x\nend_header\n1 0\n")
    for mod in (tf, jf):
        with pytest.raises(ValueError, match="list"):
            mod.load_ply(listy)


@pytest.mark.parametrize("faces", [False, True])
def test_off_and_obj(tmp_path, cloud, faces):
    tris = _faces(len(cloud), 9, seed=4) if faces else None
    for ext, save_t, save_j in ((".off", tf.save_off, jf.save_off), (".obj", tf.save_obj, jf.save_obj)):
        mine, theirs = tmp_path / f"t{ext}", tmp_path / f"j{ext}"
        save_t(mine, cloud, tris)
        save_j(theirs, cloud, tris)
        assert mine.read_bytes() == theirs.read_bytes()
        _same(tf.load_points(mine), jf.load_points(theirs, prefer_native=False))
        tm, jm = tf.load_mesh(mine), jf.load_mesh(theirs)
        _same(tm[0], jm[0])
        np.testing.assert_array_equal(tm[1], jm[1])
    polys = tmp_path / "poly.obj"
    polys.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvn 0 0 1\nf 1/1/1 2/2/1 3/3/1 4/4/1\n")
    np.testing.assert_array_equal(tf.load_mesh(polys)[1], jf.load_mesh(polys)[1])
    assert tf.load_mesh(polys)[1].tolist() == [[0, 1, 2], [0, 2, 3]]


def test_converters_keep_an_existing_output(tmp_path, cloud):
    tris = _faces(len(cloud), 5)
    src = tmp_path / "m.off"
    tf.save_off(src, cloud, tris)
    out = tf.convert_off_to_obj(src)
    assert out == tmp_path / "m.obj" and out.read_bytes() == _written(jf.save_obj, tmp_path, cloud, tris)
    out.write_text("kept\n")
    assert tf.convert_off_to_obj(src).read_text() == "kept\n"
    tf.convert_off_to_obj(src, overwrite=True)
    back = tf.convert_obj_to_off(out, tmp_path / "back.off")
    assert back.read_bytes() == src.read_bytes()


def _written(save, tmp_path, *args):
    path = tmp_path / "ref.tmp"
    save(path, *args)
    return path.read_bytes()


def test_writers_are_byte_identical_and_truncate(tmp_path, cloud):
    path = tmp_path / "out.xyz"
    tf.save_xyz(path, cloud)
    assert path.read_bytes() == _written(lambda p, x: jf.save_xyz(p, x, prefer_native=False), tmp_path, cloud)
    tf.save_xyz(path, cloud[:3])  # a rewrite truncates (the reference appended)
    assert path.read_bytes() == _written(lambda p, x: jf.save_xyz(p, x, prefer_native=False), tmp_path, cloud[:3])
    assert tf.load_points(path).shape == (3, 3)
    normals = tmp_path / "n.normal"
    tf.save_normals(normals, cloud)
    assert normals.read_bytes() == _written(jf.save_normals, tmp_path, cloud)


def test_uniform_normalize_matches(cloud):
    tp, ti = tf.uniform_normalize(cloud)
    jp, ji = jf.uniform_normalize(cloud)
    _same(tp, jp)
    assert ti.scale == ji.scale
    np.testing.assert_array_equal(ti.center, ji.center)
    np.testing.assert_array_equal(ti.border_indices, ji.border_indices)
    np.testing.assert_array_equal(tf.border_indices(cloud), jf.border_indices(cloud))
    np.testing.assert_allclose(ti.invert(tp), cloud, rtol=0, atol=1e-12)
    assert np.abs(tp).max() == pytest.approx(1.0)
