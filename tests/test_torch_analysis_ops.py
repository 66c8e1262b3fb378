"""The port's analysis ops against the JAX package on the CPU
(tests/test_analysis_ops.py's inputs): mesh angles (kss_icp_torch/
measure_mesh.py), 2D Voronoi cells and Lloyd relaxation (ops/voronoi2d.py)
and the VCM edge test (ops/vcm.py), each with the JAX function run beside it.

Where JAX's ‖a‖² + ‖b‖² − 2ab expansion parts from the float64 answer (the
VCM sample owners, the Voronoi pixel labels), the port's exact differences
are held to float64, and JAX's labels or owners that are not float64's are
counted, not compared. Probes: a π/3 angle on a histogram edge, a two-site
raster with exact ties, a fully masked site set."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kss_icp_torch.measure_mesh import angle_statistics, histogram_edges, mesh_angle_report, triangle_angles
from kss_icp_torch.ops import vcm as tv
from kss_icp_torch.ops.voronoi2d import lloyd_relax, voronoi_cells
from kss_icp_tpu import measure_mesh as jm
from kss_icp_tpu.ops import vcm as jv
from kss_icp_tpu.ops import voronoi2d as jvor

torch.set_num_threads(1)

UNIT = (0.0, 0.0, 1.0, 1.0)


def _angles_f64(verts, faces):
    v = np.asarray(verts, np.float64)[np.asarray(faces)]

    def corner(p, q, r):
        u, w = q - p, r - p
        c = (u * w).sum(-1) / (np.linalg.norm(u, axis=-1) * np.linalg.norm(w, axis=-1))
        return np.arccos(np.clip(c, -1.0, 1.0))

    a, b, c = v[:, 0], v[:, 1], v[:, 2]
    return np.stack([corner(a, b, c), corner(b, a, c), corner(c, a, b)], -1)


# --- mesh angles -----------------------------------------------------------

def test_triangle_angles_equilateral_and_right():
    verts = np.array([[0, 0, 0], [1, 0, 0], [0.5, np.sqrt(3) / 2, 0], [0, 0, 1], [1, 0, 1], [0, 1, 1]])
    faces = np.array([[0, 1, 2], [3, 4, 5]])
    got = triangle_angles(verts, faces, device="cpu")
    assert got.dtype == torch.float32
    want = np.asarray(jm.triangle_angles(jnp.asarray(verts, jnp.float64), jnp.asarray(faces)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), _angles_f64(verts, faces), atol=1e-6)
    np.testing.assert_allclose(got.numpy().sum(axis=1), np.pi, atol=1e-6)


@pytest.mark.parametrize("sliver_deg", [30.0, 10.0])
def test_angle_report_matches_jax(rng, sliver_deg):
    """A random mesh and JAX's sliver triangle: the float32 angles within
    1e-6 of JAX's, the edges JAX's bit for bit, and the histogram, sliver
    count and count JAX's."""
    verts = rng.normal(size=(300, 3)).astype(np.float32)
    faces = rng.integers(0, 300, size=(500, 3))
    faces = faces[(faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])]
    faces = np.concatenate([faces, [[0, 1, 2]]])
    verts[:3] = [[0, 0, 0], [1, 0, 0], [0.01, 0.1, 0]]  # tests/test_analysis_ops.py's sliver
    got = mesh_angle_report(verts, faces, device="cpu", sliver_threshold_deg=sliver_deg)
    want = jm.mesh_angle_report(jnp.asarray(verts), jnp.asarray(faces), sliver_threshold_deg=sliver_deg)
    np.testing.assert_array_equal(got["bin_edges"], np.asarray(want["bin_edges"]))
    assert got["bin_edges"].dtype == np.asarray(want["bin_edges"]).dtype == np.float32
    ang = triangle_angles(verts, faces, device="cpu").numpy()
    np.testing.assert_allclose(ang, np.asarray(jm.triangle_angles(jnp.asarray(verts), jnp.asarray(faces))), atol=1e-6)
    near_edge = np.abs(ang.ravel()[:, None] - got["bin_edges"][None]).min(axis=1) < 1e-6
    assert not near_edge.any()  # so the histograms must be equal
    np.testing.assert_array_equal(got["histogram"], np.asarray(want["histogram"]))
    for k in ("sliver_count", "count"):
        assert int(got[k]) == int(want[k]), k
    for k in ("min", "max", "mean"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)
    assert got["sliver_count"] >= 1 and got["histogram"].sum() == got["count"] == 3 * len(faces)


def test_equilateral_angle_on_a_bin_edge():
    """π/3 is the edge of bins 5 and 6 of 18: this triangle's float32 angles
    round to the edge itself, and searchsorted puts them in bin 6, as
    jnp.histogram does. Every edge and its float32 neighbours are binned as
    JAX bins them; torch.histc's arithmetic index bins some of the values
    just below an edge in the bin above (0.87266463 in bin 5, not 4)."""
    verts = np.array([[0, 0, 0], [1, 0, 0], [0.5, np.sqrt(3) / 2, 0]], np.float32)
    ang = triangle_angles(verts, np.array([[0, 1, 2]]), device="cpu")
    edges = histogram_edges(18)
    assert (ang == edges[6]).all()
    got = angle_statistics(ang)
    want = jm.angle_statistics(jnp.asarray(ang.numpy()))
    np.testing.assert_array_equal(got["histogram"], np.asarray(want["histogram"]))
    assert got["histogram"][6] == 3
    e = edges.numpy()
    probes = np.concatenate([np.nextafter(e, np.float32(-1)), e, np.nextafter(e, np.float32(4))])
    probes = probes[(probes >= 0) & (probes <= e[-1])]
    got = angle_statistics(torch.as_tensor(probes))["histogram"]
    np.testing.assert_array_equal(got, np.asarray(jm.angle_statistics(jnp.asarray(probes))["histogram"]))
    histc = torch.histc(torch.as_tensor(probes), bins=18, min=0.0, max=float(e[-1])).numpy()
    assert not np.array_equal(histc, got)


# --- 2D Voronoi / CVT ------------------------------------------------------

def _labels_f64(sites, mask, bbox, res):
    """First-index float64 labels on JAX's float32 pixel centres."""
    x0, y0, x1, y1 = bbox
    i = np.arange(res, dtype=np.float32) + np.float32(0.5)
    xs = np.float32(x0) + i * np.float32(x1 - x0) / np.float32(res)
    ys = np.float32(y0) + i * np.float32(y1 - y0) / np.float32(res)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    pix = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float64)
    d2 = ((pix[:, None, :] - np.asarray(sites, np.float64)[None]) ** 2).sum(-1)
    return np.where(np.asarray(mask)[None], d2, np.inf).argmin(1).reshape(res, res)


def _cells_both(sites, mask, bbox, res):
    got = voronoi_cells(torch.as_tensor(sites), torch.as_tensor(mask), bbox, res)
    want = jvor.voronoi_cells(jnp.asarray(sites), jnp.asarray(mask), bbox, resolution=res)
    return got, want


@pytest.mark.parametrize("res", [64, 128])
def test_voronoi_two_sites_matches_jax(res):
    sites = np.array([[0.25, 0.5], [0.75, 0.5]], np.float32)
    mask = np.array([True, True])
    got, want = _cells_both(sites, mask, UNIT, res)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.labels.numpy(), _labels_f64(sites, mask, UNIT, res))
    np.testing.assert_array_equal(got.areas.numpy(), np.asarray(want.areas))
    np.testing.assert_array_equal(got.centroids.numpy(), np.asarray(want.centroids))
    np.testing.assert_allclose(got.areas.numpy(), [0.5, 0.5], atol=2e-2)
    np.testing.assert_allclose(got.areas.numpy().sum(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("mask", [[True, False], [False, False]], ids=["one_masked", "all_masked"])
def test_voronoi_masked_sites_match_jax(mask):
    """A masked site gets area 0 and its own position; with every site masked
    each pixel is labelled 0, as JAX's argmin over all-1e30 rows gives."""
    sites = np.array([[0.5, 0.5], [0.6, 0.6]], np.float32)
    got, want = _cells_both(sites, np.array(mask), UNIT, 64)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.areas.numpy(), np.asarray(want.areas))
    np.testing.assert_array_equal(got.centroids.numpy(), np.asarray(want.centroids))
    if not any(mask):
        assert not got.labels.any() and not got.areas.any()
        np.testing.assert_array_equal(got.centroids.numpy(), sites)


@pytest.mark.parametrize("res", [3, 9, 27])
def test_voronoi_exact_ties_take_the_first_site(res):
    """Sites at x = 0.25 and 0.75: the column of pixel centres at x = 0.5 is
    at exactly equal distance from both. The port's exact differences tie
    there and give the first site, as the float64 first-index argmin does;
    JAX's expansion form rounds the two apart, so its tie column is counted,
    not compared."""
    sites = np.array([[0.25, 0.5], [0.75, 0.5]], np.float32)
    mask = np.array([True, True])
    got, want = _cells_both(sites, mask, UNIT, res)
    f64 = _labels_f64(sites, mask, UNIT, res)
    np.testing.assert_array_equal(got.labels.numpy(), f64)
    assert (got.labels.numpy()[res // 2] == 0).all()
    off_tie = np.ones(res, bool)
    off_tie[res // 2] = False
    np.testing.assert_array_equal(np.asarray(want.labels)[off_tie], f64[off_tie])


def test_lloyd_relax_matches_jax_and_spreads_sites(rng):
    """tests/test_analysis_ops.py's clustered start: the sites spread out and
    stay in the box, and equal JAX's to float32 rounding where the labels
    agree (every step's labels are checked against float64)."""
    sites0 = rng.uniform(0.4, 0.6, size=(16, 2)).astype(np.float32)
    mask = np.ones(16, bool)
    got = lloyd_relax(torch.as_tensor(sites0), torch.as_tensor(mask), UNIT, resolution=128, iterations=12).numpy()
    want = np.asarray(jvor.lloyd_relax(jnp.asarray(sites0), jnp.asarray(mask), UNIT, resolution=128,
                                       iterations=12))
    np.testing.assert_allclose(got, want, atol=1e-6)
    pts = torch.as_tensor(sites0)
    for _ in range(12):
        cells = voronoi_cells(pts, torch.as_tensor(mask), UNIT, 128)
        np.testing.assert_array_equal(cells.labels.numpy(), _labels_f64(pts.numpy(), mask, UNIT, 128))
        pts = cells.centroids
    assert got.min() >= 0.0 and got.max() <= 1.0

    def min_spacing(s):
        d = np.linalg.norm(s[:, None] - s[None, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        return d.min(axis=1).mean()

    assert min_spacing(got) > 2.0 * min_spacing(sites0)


# --- VCM edges -------------------------------------------------------------

@pytest.fixture(scope="module")
def crease():
    """tests/test_analysis_ops.py's L-shaped surface, padded to 1024 rows, with
    JAX's samples: _ball_samples jitted from PRNGKey(0), its radius a traced
    float32 argument, as vcm draws them."""
    rng = np.random.default_rng(0)
    n = 400
    u, v = rng.uniform(0, 1, n), rng.uniform(0, 1, n)
    plane1 = np.stack([u, v, np.zeros(n)], -1)
    plane2 = np.stack([rng.uniform(0, 1, n), np.zeros(n), rng.uniform(0, 1, n)], -1)
    pts = np.concatenate([plane1, plane2]).astype(np.float32)
    padded = np.zeros((1024, 3), np.float32)
    padded[:2 * n] = pts
    mask = np.arange(1024) < 2 * n
    key = jax.random.PRNGKey(0)
    samples = np.array(jax.jit(lambda k, p, r: jv._ball_samples(k, p, jnp.asarray(r, jnp.float32), 48))(
        key, jnp.asarray(padded), 0.25))
    return padded, mask, key, samples


def _owners_f64(samples, points, mask):
    d2 = ((samples.astype(np.float64)[:, None, :] - points.astype(np.float64)[None]) ** 2).sum(-1)
    d2 = np.where(mask[None], d2, np.inf)
    owner = d2.argmin(1)
    second = np.partition(d2, 1, axis=1)[:, 1]
    return owner, d2.min(1), second


def test_vcm_owners_are_the_float64_owners(crease):
    """Each sample's owner is its float64 nearest valid site; JAX's
    expansion-form argmin is counted against it (near-ties it parts on)."""
    padded, mask, _, samples = crease
    owner, in_domain = tv.sample_owners(torch.as_tensor(samples), torch.as_tensor(padded), torch.as_tensor(mask),
                                        0.25)
    own64, d2min, second = _owners_f64(samples, padded, mask)
    np.testing.assert_array_equal(owner.numpy(), own64)
    np.testing.assert_array_equal(in_domain.numpy(), d2min <= np.float32(0.25) ** 2)
    jax_owner = np.asarray(jnp.argmin(jnp.where(jnp.asarray(mask)[None], jv.pairwise_sqdist(
        jnp.asarray(samples), jnp.asarray(padded)), jv._BIG), axis=-1))
    parted = jax_owner != own64
    # Where JAX parts from float64, the two nearest sites are near-tied.
    assert (np.abs(second - d2min)[parted] <= 1e-5 * np.maximum(d2min[parted], 1e-3)).all()


def test_vcm_edges_match_jax_with_its_samples(crease):
    """The port's vcm_edges on JAX's samples: the matrices within rtol 1e-4 of
    the largest entry of JAX's, the ratios within 1e-4, the flags JAX's but
    where the ratio is within 1e-4 of the threshold; and the crease test of
    tests/test_analysis_ops.py holds."""
    padded, mask, key, samples = crease
    pts, msk = torch.as_tensor(padded), torch.as_tensor(mask)
    mats = tv.vcm(pts, msk, 0.25, 0.12, samples=torch.as_tensor(samples), samples_per_point=48).numpy()
    want = np.asarray(jv.vcm(jnp.asarray(padded), jnp.asarray(mask), 0.25, 0.12, key, 48))
    scale = np.abs(want).max()
    np.testing.assert_allclose(mats / scale, want / scale, atol=1e-4)
    assert not mats[~mask].any()
    edge, ratio = tv.vcm_edges(pts, msk, 0.25, 0.12, samples=torch.as_tensor(samples), samples_per_point=48)
    jedge, jratio = jv.vcm_edges(jnp.asarray(padded), jnp.asarray(mask), 0.25, 0.12, key, samples_per_point=48)
    np.testing.assert_allclose(ratio.numpy(), np.asarray(jratio), atol=1e-4)
    firm = np.abs(np.asarray(jratio) - 0.16) > 1e-4
    np.testing.assert_array_equal(edge.numpy()[firm], np.asarray(jedge)[firm])
    ratio = ratio.numpy()[: 800]
    p = padded[:800]
    near_crease = (np.abs(p[:, 1]) < 0.08) & (np.abs(p[:, 2]) < 0.08)
    interior = (p[:, 1] > 0.4) & (np.abs(p[:, 2]) < 1e-6)
    assert ratio[near_crease].mean() > 1.5 * ratio[interior].mean()
    assert not edge.numpy()[800:].any()


def test_vcm_draws_from_its_generator(crease):
    """With no samples, the draw comes from the torch.Generator: one seed,
    one answer; and the crease still separates."""
    padded, mask, _, _ = crease
    pts, msk = torch.as_tensor(padded), torch.as_tensor(mask)
    runs = [tv.vcm_edges(pts, msk, 0.25, 0.12, samples_per_point=16, generator=torch.Generator().manual_seed(7))
            for _ in range(2)]
    np.testing.assert_array_equal(runs[0][1].numpy(), runs[1][1].numpy())
    samples = tv.ball_samples(pts, 0.25, 16, torch.Generator().manual_seed(7))
    assert samples.shape == (1024 * 16, 3)
    off = np.linalg.norm(samples.numpy().reshape(1024, 16, 3) - padded[:, None], axis=-1)
    assert off.max() <= 0.25 * (1 + 1e-6)
    ratio = runs[0][1].numpy()[:800]
    p = padded[:800]
    assert ratio[(np.abs(p[:, 1]) < 0.08) & (np.abs(p[:, 2]) < 0.08)].mean() > \
        1.5 * ratio[(p[:, 1] > 0.4) & (np.abs(p[:, 2]) < 1e-6)].mean()
