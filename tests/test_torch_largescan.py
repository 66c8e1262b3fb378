"""The port's large-scan path (kss_icp_torch/largescan.py, ops/simplify.py,
ops/resample.py::voxel_downsample) against the JAX package's on the CPU: the
Room scenes array for array, the voxel and octree survivors bit for bit, the
plain FPS past 65536 points index for index, run_largescan at 20k points on
the tiny config of tests/test_largescan.py, and the octree survivors at the
200k points of fixtures/torch_port_expected_largescan.json (the counts that
chip_smoke.py's phase 4f gates on).

JAX runs octree_simplify under one jit, as run_largescan does: XLA then
multiplies by the reciprocal of sqrt(target_points) where an eager call
divides, and the cell's last bit moves the survivors."""

import hashlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import random_cloud
from kss_icp_torch import largescan as tl
from kss_icp_torch.config import DEFAULT_CONFIG, KSSICPConfig
from kss_icp_torch.ops.resample import farthest_point_sampling as t_fps
from kss_icp_torch.ops.resample import voxel_downsample
from kss_icp_torch.ops.resample_cuda import fps
from kss_icp_torch.ops.simplify import grid_simplify, octree_simplify
from kss_icp_tpu import largescan as jl
from kss_icp_tpu.config import KSSICPConfig as JConfig
from kss_icp_tpu.ops.resample import farthest_point_sampling as j_fps
from kss_icp_tpu.ops.resample import voxel_downsample as j_voxel
from kss_icp_tpu.ops.simplify import octree_simplify as j_octree

torch.set_num_threads(1)

RECORD = Path(__file__).resolve().parents[1] / "fixtures" / "torch_port_expected_largescan.json"
# tests/test_largescan.py:43-46.
TINY = dict(max_candidates=6, coarse_points=512, coarse_target_points=512, refine_candidates=2,
            refine_tier_iterations=12, refine_max_iterations=48)
RMSE_BAND = 0.006  # the pipeline parity bar (ROADMAP.md)


def _normalized(src, tgt):
    """run_largescan's ingest normalization and padding: ((src, mask), (tgt, mask), nscale)."""
    center = tgt.mean(axis=0)
    nscale = float(np.abs(tgt - center).max())
    pad = ((max(len(src), len(tgt)) + 4095) // 4096) * 4096
    return (tuple(jl._pad(((x - center) / nscale).astype(np.float32), pad) for x in (src, tgt)), nscale)


def _assert_same_survivors(got, want):
    pts, keep = (x.numpy() for x in got)
    np.testing.assert_array_equal(keep, np.asarray(want[1]))
    np.testing.assert_array_equal(pts, np.asarray(want[0]))


@pytest.mark.parametrize("n, seed, sample", [(5000, 3, 0), (5000, 3, 1), (20000, 0, 0)])
def test_room_scene_equals_jax(n, seed, sample):
    np.testing.assert_array_equal(tl.room_scene(n, seed, sample), jl.room_scene(n, seed, sample))


@pytest.mark.parametrize("n, seed, noise", [(2000, 1, 0.0), (20000, 0, 0.01)])
def test_room_pair_equals_jax(n, seed, noise):
    *clouds, gt = tl.room_pair(n, seed, noise)
    *want, gt_j = jl.room_pair(n, seed, noise)
    for a, b in zip(clouds, want):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    for k in ("R", "s", "t"):
        np.testing.assert_array_equal(gt[k], gt_j[k])


def _boundary_cloud(rng):
    """Points exactly on voxel boundaries: a lattice at the cell from lo, at a
    power-of-two cell (exact coordinates) and at 0.1 (coordinates rounded, so
    (p - lo) / cell falls on either side of the integer), with interior points."""
    k = np.unique(rng.integers(0, 24, size=(1500, 3)), axis=0).astype(np.float32)
    lo = np.float32(-1.0)
    lattice = np.concatenate([lo + k * np.float32(0.125), lo + k[::2] * np.float32(0.1)])
    inner = rng.uniform(-1, 2, size=(800, 3)).astype(np.float32)
    return np.concatenate([lattice, inner]).astype(np.float32)


def _sphere_cloud(rng, cell, extent):
    """Six points at one distance from the centre of each of ~300 voxels of
    `cell` (float32 rounding alone orders them, so the voxel's survivor
    depends on how d2c rounds), and the corners 0 and `extent` (lo = 0)."""
    ijk = np.unique(rng.integers(1, int(extent / cell) - 2, (300, 3)), axis=0).astype(np.float32)
    d = rng.normal(size=(len(ijk), 6, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    r = rng.uniform(0.1, 0.45, size=(len(ijk), 1, 1)) * cell
    pts = ((ijk + np.float32(0.5)) * np.float32(cell))[:, None] + r * d
    return np.concatenate([pts.reshape(-1, 3), [[0, 0, 0], [extent] * 3]]).astype(np.float32)


@pytest.mark.parametrize("case", ["random cloud, masked tail", "20k room scan", "voxel boundaries",
                                  "points on spheres about the voxel centres"])
@pytest.mark.parametrize("cell", [0.125, 0.1, 0.037])
def test_voxel_downsample_equals_jax(rng, case, cell):
    """Survivor mask and sorted points bit-equal to JAX's (exact equality).
    The spheres part every order and rounding of d2c but XLA's,
    fma(dz, dz, fma(dy, dy, dx * dx))."""
    if case == "points on spheres about the voxel centres":
        pts = _sphere_cloud(rng, np.float32(cell), np.float32(3.0))
        mask = np.ones(len(pts), bool)
    elif case == "random cloud, masked tail":
        pts = random_cloud(rng, 3000).astype(np.float32)
        mask = np.ones(len(pts), bool)
        mask[2600:] = False
    elif case == "20k room scan":
        ((pts, mask), _), _ = _normalized(*jl.room_pair(20_000, 0)[:2])
    else:
        pts = _boundary_cloud(rng)
        mask = np.ones(len(pts), bool)
    want = j_voxel(jnp.asarray(pts), jnp.asarray(mask), jnp.float32(cell))
    got = voxel_downsample(torch.as_tensor(pts), torch.as_tensor(mask), cell)
    _assert_same_survivors(got, want)
    assert int(got[1].sum()) > 0
    _assert_same_survivors(grid_simplify(torch.as_tensor(pts), torch.as_tensor(mask), cell), want)


_J_OCTREE = jax.jit(j_octree, static_argnames=("target_points",))  # as run_largescan calls it


@pytest.mark.parametrize("side", [0, 1])
def test_octree_simplify_equals_jax_at_20k(side):
    """Both scans of the 20k Room pair, normalized and padded as run_largescan
    does, to a target of 5000: survivors bit-equal (exact equality)."""
    clouds, _ = _normalized(*jl.room_pair(20_000, 0)[:2])
    pts, mask = clouds[side]
    want = _J_OCTREE(jnp.asarray(pts), jnp.asarray(mask), target_points=5000)
    got = octree_simplify(torch.as_tensor(pts), torch.as_tensor(mask), 5000)
    _assert_same_survivors(got, want)
    assert 4000 < int(got[1].sum()) < 8000


def _octree_cell(extent: float, target: int) -> np.float32:
    """The octree's cell for a cube of edge `extent`, rounded as JAX's jit rounds it."""
    sq = np.float32(extent) * np.float32(extent)
    return np.sqrt((sq + sq) + sq) * (np.float32(1) / np.sqrt(np.float32(target)))


def _bbox_probe_cloud(rng, target):
    """A box of random extents and, for each cell that some order or rounding
    of the diagonal (x² + y² + z², with or without fused multiply-adds) gives,
    points at multiples of that cell along each axis: the voxel keys then part
    the cells, and so the diagonal's rounding."""
    e = rng.uniform(0.3, 2.5, 3).astype(np.float32)
    sq = e * e
    sums = {np.float32(sq[i] + sq[j]) + sq[k] for i, j, k in ((0, 1, 2), (0, 2, 1), (1, 2, 0))}
    sums |= {np.float32(np.float64(e[k]) ** 2 + (sq[i] + sq[j])) for i, j, k in ((0, 1, 2), (0, 2, 1), (1, 2, 0))}
    cells = {np.float32(np.sqrt(np.float32(v)) * (np.float32(1) / np.sqrt(np.float32(target)))) for v in sums}
    pts = [np.zeros(3, np.float32), e]
    for c in sorted(cells):
        for n in (1, 2, 3, 7, 11):
            for ax in range(3):
                q = rng.uniform(0.1, 0.9, 3).astype(np.float32) * e
                q[ax] = np.float32(n * c)
                pts.append(q)
    return np.stack(pts).astype(np.float32)


@pytest.mark.parametrize("case", ["spheres on the octree's voxels", "boxes that part the diagonal's roundings"])
@pytest.mark.parametrize("trial", range(4))
def test_octree_simplify_equals_jax_on_rounding_probes(case, trial):
    """Clouds on which the survivors follow the last bit of the octree's cell
    or of d2c: bit-equal to JAX's jitted octree_simplify, which sums the
    diagonal's squares as (x² + z²) + y² with no fused multiply-add, divides
    by the constant as a product with its reciprocal, and takes the square
    root correctly rounded (torch's CPU float32 sqrt is an ulp off on some
    inputs). Exact equality."""
    rng = np.random.default_rng(100 + trial)
    if case == "spheres on the octree's voxels":
        # Trial 0's cube: torch's CPU float32 sqrt of its 3 E² is an ulp low.
        extent = np.float32(1.1832612) if trial == 0 else np.float32(rng.uniform(0.8, 1.5))
        pts = _sphere_cloud(rng, _octree_cell(extent, 5000), extent)
        target = 5000
    else:
        target = 80000
        pts = _bbox_probe_cloud(rng, target)
    mask = np.ones(len(pts), bool)
    want = _J_OCTREE(jnp.asarray(pts), jnp.asarray(mask), target_points=target)
    _assert_same_survivors(octree_simplify(torch.as_tensor(pts), torch.as_tensor(mask), target), want)


def test_plain_fps_past_65536_points_equals_jax(rng):
    """The plain FPS (the fps wrapper's CPU path and the kernel's reference) at
    P = 69632, 64 steps, against the XLA loop: indices identical."""
    p_n = 69632
    pts = np.stack([random_cloud(rng, p_n) for _ in range(2)]).astype(np.float32)
    mask = np.ones((2, p_n), bool)
    mask[1, 67000:] = False
    want = jax.vmap(lambda p, m: j_fps(p, m, 64))(jnp.asarray(pts), jnp.asarray(mask))
    for fn in (t_fps, fps):
        idx, sm = fn(torch.as_tensor(pts), torch.as_tensor(mask), 64)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(sm.numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("escalate_threshold", [None, 0.0], ids=["default gate", "every pair escalates"])
def test_run_largescan_matches_jax_at_20k(monkeypatch, escalate_threshold):
    """run_largescan(20_000, 5_000, the tiny config, seed 0) on the CPU against
    JAX's: the same pnumber, escalation and keep-better outcome (the second
    case sets escalate_threshold 0, so largescan's re-solve at
    escalation_config() runs in both), the unit-scale RMSE within JAX's +
    0.006, the pose within 0.3 m (tests/test_largescan.py's bar). The re-solve's
    grid is cut to 10³ rotations to keep the CPU test short."""
    from kss_icp_tpu.models import kss_icp as jk

    knobs = dict(TINY) if escalate_threshold is None else dict(TINY, escalate_threshold=escalate_threshold,
                                                                escalate_rotation_steps=10)  # 10³, not 16³
    fits, register = [], jk.register_resampled

    def counting(*a, **kw):  # run_largescan imports register_resampled when it runs
        res = register(*a, **kw)
        fits.append(float(res.fitness))
        return res

    monkeypatch.setattr(jk, "register_resampled", counting)
    want = jl.run_largescan(20_000, 5_000, JConfig(**knobs), seed=0, repeats=1)
    assert len(fits) in (1, 2)
    got = tl.run_largescan(20_000, 5_000, KSSICPConfig(**knobs), seed=0, repeats=1, device="cpu")
    _, nscale = _normalized(*jl.room_pair(20_000, 0)[:2])
    assert got["nscale"] == nscale and got["device"] == "cpu"
    assert set(want) <= set(got)
    assert got["pnumber"] == want["pnumber"] == 2000 and got["n_points"] == want["n_points"]
    assert got["escalated"] == (len(fits) == 2) == (escalate_threshold is not None)
    assert got["escalation_won"] == (len(fits) == 2 and fits[1] < fits[0])
    assert got["resample_count"] == DEFAULT_CONFIG.resample_count(got["n_s"], got["n_t"])
    assert got["unit_rmse"] <= want["rmse"] / nscale + RMSE_BAND, (got, want)
    assert got["pose_rmse"] < 0.3, got
    assert got["metric_s"] > 0 and got["total_s"] >= got["metric_s"]


def test_run_largescan_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tl.run_largescan(2000, 500, device="cuda")


def _digest(points, keep) -> str:
    """scripts/torch_port_expected.py::survivor_digest of the port's survivors."""
    return hashlib.sha256(np.ascontiguousarray(points.numpy()[keep.numpy()]).tobytes()).hexdigest()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_octree_survivors_at_200k_match_the_record(seed):
    """The port's CPU octree_simplify on the 200k-point Room pair at the 80k
    target gives the recorded JAX survivors (SHA-256 of the kept points) and so
    JAX's n_s, n_t, pnumber and compacted pad: what phase 4f gates on."""
    record = json.loads(RECORD.read_text())
    rec = next(r for r in record["seeds"] if r["seed"] == seed)
    clouds, nscale = _normalized(*tl.room_pair(record["n_points"], seed)[:2])
    assert nscale == rec["nscale"]
    counts = []
    for (pts, mask), side in zip(clouds, ("source", "target")):
        out, keep = octree_simplify(torch.as_tensor(pts), torch.as_tensor(mask), record["pre_downsample"])
        counts.append(int(keep.sum()))
        assert _digest(out, keep) == rec["survivors_sha256"][side], side
    assert counts == [rec["n_s"], rec["n_t"]]
    assert DEFAULT_CONFIG.resample_count(*counts) == rec["pnumber"]
    assert ((max(counts) + 4095) // 4096) * 4096 == rec["ds_pad"]


@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_run_largescan_at_200k_on_the_cpu_matches_the_record(seed):
    """Phase 4f's gates on the CPU: the port's whole large-scan run at 200k
    points and DEFAULT_CONFIG (minutes: the metric's 200704² plain distances)."""
    record = json.loads(RECORD.read_text())
    rec = next(r for r in record["seeds"] if r["seed"] == seed)
    got = tl.run_largescan(record["n_points"], record["pre_downsample"], DEFAULT_CONFIG, seed, device="cpu")
    assert (got["n_s"], got["n_t"], got["resample_count"]) == (rec["n_s"], rec["n_t"], rec["pnumber"])
    assert got["escalated"] == rec["escalated"]
    assert got["unit_rmse"] <= rec["unit_rmse"] + RMSE_BAND
    assert got["pose_rmse"] < record["pose_bar"]
