"""The port's viewer stack against the JAX package's on the same inputs
(tests/test_viz.py and tests/test_interactive_view.py): the trackball
(kss_icp_torch/viz/trackball.py), the z-buffer renderer and its PNG bytes
(viz/render.py), the terminal viewer's state machine and ANSI frames
(viz/interactive.py) and the directory walker (utils/fileproc.py). All numpy:
equal arrays and equal bytes."""

import numpy as np
import pytest

from helpers import random_cloud
from kss_icp_torch import viz as tviz
from kss_icp_torch.utils import fileproc as tfp
from kss_icp_torch.viz import interactive as tint
from kss_icp_tpu import viz as jviz
from kss_icp_tpu.utils import fileproc as jfp
from kss_icp_tpu.viz import interactive as jint


@pytest.mark.parametrize("drag", [(0.3, 0.2, 0.3, 0.2), (-0.3, 0.0, 0.3, 0.0), (0.1, -0.5, 0.9, 0.7),
                                  (0.0, 0.0, 0.4, 0.0)])
def test_trackball_matches_jax(drag):
    np.testing.assert_array_equal(tviz.drag_quaternion(*drag), jviz.drag_quaternion(*drag))
    q1, q2 = tviz.axis_angle_quaternion([0, 1, 0], 0.4), tviz.axis_angle_quaternion([1, 0, 0], 0.7)
    np.testing.assert_array_equal(q1, jviz.axis_angle_quaternion([0, 1, 0], 0.4))
    np.testing.assert_array_equal(tviz.add_quaternions(q1, q2), jviz.add_quaternions(q1, q2))
    tb, jb = tviz.Trackball(), jviz.Trackball()
    for t in (tb, jb):
        t.drag(*drag)
        t.drag(0.4, 0.0, 0.0, 0.0)
    np.testing.assert_array_equal(tb.rotation, jb.rotation)
    np.testing.assert_array_equal(tviz.quaternion_matrix(tb.quat), jviz.quaternion_matrix(jb.quat))


@pytest.mark.parametrize("point_px", [1, 2, 3])
def test_render_and_png_bytes_match_jax(rng, tmp_path, point_px):
    tgt = random_cloud(rng, 500)
    src = (tgt + 0.1).astype(np.float32)
    tb = jviz.Trackball()
    tb.drag(0.0, 0.0, 0.3, 0.15)
    kw = dict(rotation=tb.rotation, size=(160, 120), point_px=point_px)
    img = tviz.render_clouds([tgt, src, np.zeros((0, 3))], **kw)
    np.testing.assert_array_equal(img, jviz.render_clouds([tgt, src, np.zeros((0, 3))], **kw))
    tviz.render_registration(tmp_path / "t.png", tgt, source=src, aligned=tgt, **kw)
    jviz.render_registration(tmp_path / "j.png", tgt, source=src, aligned=tgt, **kw)
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()


def test_render_zbuffer_near_wins():
    near, far = np.array([[0.0, 0.0, 1.0]]), np.array([[0.0, 0.0, -1.0]])
    kw = dict(size=(64, 64), point_px=2, colors=((255, 0, 0), (0, 255, 0)))
    img = tviz.render_clouds([far, near], **kw)
    np.testing.assert_array_equal(img, jviz.render_clouds([far, near], **kw))
    center = img[28:36, 28:36].reshape(-1, 3)
    lit = center[(center != np.array([18, 18, 22], np.uint8)).any(axis=-1)]
    assert lit.size > 0 and (lit[:, 1] > lit[:, 0]).all()


def test_interactive_viewer_matches_jax():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(200, 3)).astype(np.float32)
    t, j = tint.InteractiveViewer([pts, pts + 0.2], size=(24, 16)), jint.InteractiveViewer([pts, pts + 0.2],
                                                                                           size=(24, 16))
    for key in ("left", "up", "+", " ", "down", "-", "right", "r", "up", "q"):
        t.handle_key(key)
        j.handle_key(key)
        assert t.running == j.running and t.zoom == j.zoom
        assert t.ansi_frame() == j.ansi_frame()
    assert not t.running and t.frames_rendered == j.frames_rendered == 10
    img = np.zeros((4, 3, 3), np.uint8)
    img[0, :, 0] = 255
    assert tint.image_to_ansi(img) == jint.image_to_ansi(img)


def test_fileproc_matches_jax(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "a" / "x.xyz").write_text("1\n0 0 0\n")
    (tmp_path / "a" / "y.ply").write_text("ply")
    (tmp_path / "z.off").write_text("OFF\n0 0 0\n")
    (tmp_path / "notes.md").write_text("hi")
    for pattern in ("*", "*.xyz", "*.off"):
        assert list(tfp.browse_dir(tmp_path, pattern)) == list(jfp.browse_dir(tmp_path, pattern))
        assert tfp.stat_dir(tmp_path, pattern).__dict__ == jfp.stat_dir(tmp_path, pattern).__dict__
    assert tfp.find_point_clouds(tmp_path) == jfp.find_point_clouds(tmp_path)
    seen = []
    list(tfp.browse_dir(tmp_path, "*", on_file=lambda p: seen.append(p) and False))
    assert len(seen) == 1
