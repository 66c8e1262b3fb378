"""The op surface the tools import (pairwise_sqdist, fps_points,
resample_for_registration, masked_max_radius and middle_align's scale_mode,
get_logger, the ops package's exports) against the JAX package on the same
seeded float32 inputs."""

import io
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kss_icp_torch.ops as tops
import kss_icp_tpu.ops as jops
from helpers import random_cloud
from kss_icp_torch.config import DEFAULT_CONFIG as TCFG
from kss_icp_torch.core import preshape as tp
from kss_icp_torch.models import kss_icp as tk
from kss_icp_torch.ops import nn as tnn
from kss_icp_torch.ops.resample import fps_points
from kss_icp_torch.ops.resample_cuda import fps
from kss_icp_torch.utils import log as tlog
from kss_icp_tpu.config import DEFAULT_CONFIG as JCFG
from kss_icp_tpu.core import preshape as jp
from kss_icp_tpu.models import kss_icp as jk
from kss_icp_tpu.ops import nn as jnn
from kss_icp_tpu.ops import resample as jr

torch.set_num_threads(1)


def _padded(n, pad, seed, scale=1.0, offset=0.0):
    pts = np.zeros((pad, 3), np.float32)
    pts[:n] = random_cloud(np.random.default_rng(seed), n, scale) + offset
    return pts, np.arange(pad) < n


@pytest.mark.parametrize("offset", [0.0, 5.0])
def test_pairwise_sqdist_matches_jax(offset):
    """The expansion form at rtol 1e-5 against JAX's, clamped at 0, over
    leading axes. Beside it an atol of the expansion's own rounding, 4 ulps
    of the largest ‖a‖² + ‖b‖² (7e-7 at offset 0, 3.6e-5 at offset 5), which
    each package's float32 rounds its own way."""
    rng = np.random.default_rng(1)
    a = (rng.normal(size=(2, 70, 3)) + offset).astype(np.float32)
    b = (rng.normal(size=(2, 90, 3)) + offset).astype(np.float32)
    got = tnn.pairwise_sqdist(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    want = np.asarray(jnn.pairwise_sqdist(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == want.shape == (2, 70, 90) and got.min() >= 0.0
    atol = 4 * np.finfo(np.float32).eps * float((a ** 2).sum(-1).max() + (b ** 2).sum(-1).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)
    exact = ((a[:, :, None].astype(np.float64) - b[:, None]) ** 2).sum(-1)
    np.testing.assert_allclose(got, exact, rtol=1e-5, atol=atol)
    with pytest.raises(ValueError, match="highest"):
        tnn.pairwise_sqdist(torch.as_tensor(a), torch.as_tensor(b), precision="default")


def test_exact_sqdist_is_zero_between_coincident_points():
    """The difference form WLOP and the MLS projection use: exactly 0 where a
    sample sits on an input point, where the eager expansion leaves a
    residue; elsewhere the float64 value at rtol 1e-6."""
    pts = (random_cloud(np.random.default_rng(2), 512) * 3.7 + np.array([5.0, -2.0, 1.0])).astype(np.float32)
    t = torch.as_tensor(pts)
    d2 = tnn.exact_sqdist(t, t).numpy()
    assert (np.diag(d2) == 0.0).all()
    assert (np.diag(tnn.pairwise_sqdist(t, t).numpy()) > 0.0).any()  # the residue exact_sqdist avoids
    exact = ((pts[:, None].astype(np.float64) - pts[None]) ** 2).sum(-1)
    off = ~np.eye(512, dtype=bool)
    np.testing.assert_allclose(d2[off], exact[off], rtol=1e-6)


@pytest.mark.parametrize("n, pad, s", [(700, 768, 300), (200, 256, 256)])
def test_fps_points_matches_jax(n, pad, s):
    """JAX's points and mask exactly, through the fps wrapper (its plain
    version on the CPU), masked slots zero when the cloud is smaller than S."""
    pts, mask = _padded(n, pad, n)
    got, gm = fps_points(torch.as_tensor(pts), torch.as_tensor(mask), s)
    want, wm = jr.fps_points(jnp.asarray(pts), jnp.asarray(mask), s)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert gm.sum() == min(n, s)


def test_fps_points_on_the_cpu_launches_no_kernel():
    pts, mask = _padded(300, 512, 3)
    before = fps.launches
    fps_points(torch.as_tensor(pts), torch.as_tensor(mask), 64)
    assert fps.launches == before


@pytest.mark.parametrize("pnumber, pad", [(300, None), (64, 128)])
def test_resample_for_registration_matches_jax(pnumber, pad):
    """JAX's points and mask exactly: FPS to the pad, `pnumber` kept, the
    rest zeroed; at DEFAULT_CONFIG's resample_pad and at an explicit pad."""
    pts, mask = _padded(2500, 2560, 7)
    got, gm = tk.resample_for_registration(torch.as_tensor(pts), torch.as_tensor(mask), pnumber, TCFG, pad)
    want, wm = jk.resample_for_registration(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(pnumber), JCFG, pad)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(gm.sum()) == pnumber


@pytest.mark.parametrize("scale_mode", ["mean_radius", "max_radius"])
def test_middle_align_scale_modes_match_jax(scale_mode):
    """Both size measures, batched over two pairs with padded rows, at rtol
    1e-6; masked_max_radius itself too."""
    src = np.stack([_padded(400, 512, s, 2.0, 1.5)[0] for s in (1, 2)])
    tgt = np.stack([_padded(450, 512, s)[0] for s in (3, 4)])
    sm = np.stack([np.arange(512) < 400] * 2)
    tm = np.stack([np.arange(512) < 450, np.arange(512) < 300])
    args_t = [torch.as_tensor(x) for x in (src, sm, tgt, tm)]
    args_j = [jnp.asarray(x) for x in (src, sm, tgt, tm)]
    sim, ct, scale = tp.middle_align(*args_t, scale_mode=scale_mode)
    jsim, jct, jscale = jp.middle_align(*args_j, scale_mode=scale_mode)
    np.testing.assert_allclose(scale.numpy(), np.asarray(jscale), rtol=1e-6)
    np.testing.assert_allclose(ct.numpy(), np.asarray(jct), rtol=1e-6)
    np.testing.assert_allclose(sim.translation.numpy(), np.asarray(jsim.translation), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(sim.rotation.numpy(), np.asarray(jsim.rotation))
    c = tp.masked_centroid(args_t[0], args_t[1])
    np.testing.assert_allclose(tp.masked_max_radius(args_t[0], args_t[1], c).numpy(),
                               np.asarray(jp.masked_max_radius(args_j[0], args_j[1], jnp.asarray(c.numpy()))),
                               rtol=1e-6)


def test_middle_align_defaults_to_the_mean_radius():
    a = [torch.as_tensor(x) for x in (*_padded(300, 512, 5), *_padded(400, 512, 6, 3.0))]
    assert torch.equal(tp.middle_align(*a)[2], tp.middle_align(*a, scale_mode="mean_radius")[2])
    assert not torch.equal(tp.middle_align(*a)[2], tp.middle_align(*a, scale_mode="max_radius")[2])


def test_get_logger_is_one_process_wide_stderr_logger(monkeypatch):
    monkeypatch.setattr(tlog, "_default", None)
    err = io.StringIO()
    monkeypatch.setattr(sys, "stderr", err)
    log = tlog.get_logger()
    assert log is tlog.get_logger()
    log.emit("probe", n=3)
    assert '"event": "probe", "n": 3' in err.getvalue()


def test_ops_exports_what_jax_exports():
    """Every name of kss_icp_tpu.ops.__all__, plus the port's kernels."""
    assert set(jops.__all__) <= set(tops.__all__)
    assert set(tops.__all__) - set(jops.__all__) == {"field_ave", "field_dot", "fps", "nn1",
                                                      "masked_quantile_threshold"}
    for name in tops.__all__:
        assert callable(getattr(tops, name))
