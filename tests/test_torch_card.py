"""The port's CUDA kernels on the card, held to their plain versions and to
JAX values recorded in this file.

This file imports neither jax nor kss_icp_tpu, because the machine with the
card has no jax; tests/conftest.py imports jax, so run it there with

    python -m pytest --noconftest tests/test_torch_card.py -q -m cuda

The recorded values come from the JAX Pallas kernels in interpret mode on
the CPU (kss_icp_tpu/ops/nn_pallas.py::nearest_neighbor_vpu,
ops/resample_pallas.py::fps_batch_pallas, ops/coarse_pallas.py::
rotation_scores_pallas with method "vpu" and "dot") on the inputs built
below; the plain versions are held to them here on the CPU as well."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import kss_icp_torch as kt
from helpers import random_cloud
from kss_icp_torch.config import KSSICPConfig
from kss_icp_torch.core.transforms import euler_xyz_matrix
from kss_icp_torch.models import coarse
from kss_icp_torch.models.icp import ICPParams, icp
from kss_icp_torch.ops.coarse_cuda import field_ave, field_ave_plain, field_dot, field_dot_plain
from kss_icp_torch.ops.nn_cuda import nn1, nn1_plain, nn1_plan
from kss_icp_torch.ops.resample import farthest_point_sampling
from kss_icp_torch.ops.resample_cuda import fps
from torch_helpers import cuda_device, cull_probe_cases  # noqa: F401  (fixture)

torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parents[1] / "fixtures"

# nearest_neighbor_vpu(interpret=True) on _nn_case(): first 12 queries.
JAX_NN_IDX = [176, 85, 231, 208, 18, 201, 52, 176, 264, 255, 242, 158]
JAX_NN_D2 = [0.003139611, 0.004743203, 0.001666419, 0.0001842281, 0.001253936, 0.006382955,
             0.001971299, 0.005938212, 0.0001728665, 0.001211259, 0.002552126, 0.0001584018]
# fps_batch_pallas(interpret=True) on _fps_case(), 24 samples.
JAX_FPS_IDX = [145, 277, 351, 184, 282, 135, 403, 101, 348, 99, 57, 301, 394, 120, 345, 265,
               305, 197, 154, 71, 303, 397, 41, 275]
# rotation_scores_pallas(interpret=True, method="vpu") on _field_case().
JAX_FIELD = [0.08787406, 0.2258687, 0.08588043, 0.2288799, 0.2302824, 0.08509021, 0.227922, 0.08788089]
# rotation_scores_pallas(interpret=True, method="dot", precision="highest") on _field_case().
JAX_FIELD_DOT = [0.08787389, 0.2258687, 0.08588044, 0.22888, 0.23028247, 0.08509029, 0.22792202, 0.08788095]


def _t(x, device="cpu"):
    return torch.as_tensor(x, device=device)


def _nn_case(device="cpu"):
    rng = np.random.default_rng(11)
    q = random_cloud(rng, 40).astype(np.float32)
    r = random_cloud(rng, 300).astype(np.float32)
    m = np.ones(300, bool)
    m[280:] = False
    return _t(q, device), _t(r, device), _t(m, device)


def _fps_case(device="cpu"):
    rng = np.random.default_rng(12)
    pts = random_cloud(rng, 500).astype(np.float32)[None]
    mask = np.ones((1, 500), bool)
    mask[0, 450:] = False
    return _t(pts, device), _t(mask, device)


def _field_case(device="cpu"):
    rng = np.random.default_rng(13)
    src = random_cloud(rng, 200).astype(np.float32)
    tgt = random_cloud(rng, 150).astype(np.float32)
    sm = np.ones(200, bool)
    sm[190:] = False
    tm = np.ones(150, bool)
    tm[140:] = False
    rots = euler_xyz_matrix(coarse.rotation_grid(2, 6.3, device))
    return tuple(_t(x, device) for x in (src, sm, tgt, tm)) + (rots,)


def test_plain_versions_match_recorded_jax_values():
    d2, idx = nn1(*_nn_case())
    np.testing.assert_array_equal(idx[:12].numpy(), JAX_NN_IDX)
    np.testing.assert_allclose(d2[:12].numpy(), JAX_NN_D2, rtol=1e-5)
    idx, _ = fps(*_fps_case(), 24)
    np.testing.assert_array_equal(idx[0].numpy(), JAX_FPS_IDX)
    np.testing.assert_allclose(field_ave(*_field_case()).numpy(), JAX_FIELD, rtol=2e-5)


@pytest.mark.cuda
def test_nn1_kernel_matches_plain_and_jax(cuda_device):
    q, r, m = _nn_case(cuda_device)
    before = nn1.launches
    d2, idx = nn1(q, r, m)
    assert nn1.launches == before + 1
    d2_p, idx_p = nn1_plain(q[None], r[None], m[None])
    assert torch.equal(idx, idx_p[0]) and torch.equal(d2, d2_p[0])
    np.testing.assert_array_equal(idx[:12].cpu().numpy(), JAX_NN_IDX)
    np.testing.assert_allclose(d2[:12].cpu().numpy(), JAX_NN_D2, rtol=1e-5)


@pytest.mark.cuda
def test_nn1_kernel_lanes_masks_and_ties(cuda_device):
    rng = np.random.default_rng(5)
    q = _t(np.stack([random_cloud(rng, 700) for _ in range(6)]).astype(np.float32), cuda_device)
    r = _t(np.stack([random_cloud(rng, 1500) for _ in range(3)]).astype(np.float32), cuda_device)
    r[0, 700:710] = r[0, 600]  # exact ties: the first index must win
    m = torch.ones((3, 1500), dtype=torch.bool, device=cuda_device)
    m[1, 1000:] = False
    m[2] = False  # a fully masked reference
    lane_ref = torch.tensor([0, 1, 2, 1, 0, 2], dtype=torch.int32, device=cuda_device)
    d2, idx = nn1(q, r, m, lane_ref)
    d2_p, idx_p = nn1_plain(q, r, m, lane_ref)
    assert torch.equal(idx, idx_p) and torch.equal(d2, d2_p)
    assert bool((d2[2] == 1e30).all())


def _same_nn(got, want):
    assert torch.equal(got[1], want[1]), f"indices differ at {int((got[1] != want[1]).sum())} queries"
    assert torch.equal(got[0], want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("lanes, q_n, r_n", [(32, 512, 2048), (4, 2048, 2048), (1, 3072, 8192), (1, 1001, 2037),
                                             (3, 97, 300)])
def test_nn1_kernel_matches_plain_at_the_plans_shapes(cuda_device, lanes, q_n, r_n):
    """Main-path shapes, and R not a multiple of the slice with Q not a
    multiple of the query tile."""
    rng = np.random.default_rng(q_n + r_n)
    q = _t(np.stack([random_cloud(rng, q_n) for _ in range(lanes)]).astype(np.float32), cuda_device)
    r = _t(random_cloud(rng, r_n).astype(np.float32)[None], cuda_device)
    m = torch.ones((1, r_n), dtype=torch.bool, device=cuda_device)
    m[0, r_n - r_n // 40:] = False
    _same_nn(nn1(q, r, m), nn1_plain(q, r, m))


@pytest.mark.cuda
def test_nn1_kernel_ties_across_slice_borders_keep_the_first_index(cuda_device):
    r_n = 2048
    plan = nn1_plan(2, 256, r_n)
    assert plan.cluster == 8 and plan.slice == 256
    rng = np.random.default_rng(8)
    r = random_cloud(rng, r_n).astype(np.float32)
    border = plan.slice
    for a, b in ((border - 1, border), (3 * border - 1, 3 * border), (5, 7 * border + 3)):
        r[b] = r[a]  # exact ties: the later row, in a later slice, must lose
    q = np.stack([r[[border - 1, border, 3 * border, 7 * border + 3] * 64], r[rng.permutation(r_n)[:256]]])
    q = _t(q.astype(np.float32), cuda_device)
    rt = _t(r[None], cuda_device)
    m = torch.ones((1, r_n), dtype=torch.bool, device=cuda_device)
    m[0, border - 1] = False  # a masked row straddling the border: its twin wins
    d2, idx = nn1(q, rt, m)
    _same_nn((d2, idx), nn1_plain(q, rt, m))
    assert idx[0, :4].tolist() == [border, border, 3 * border - 1, 5]


@pytest.mark.cuda
def test_nn1_kernel_fully_masked_reference_and_foreign_lane_ref(cuda_device):
    rng = np.random.default_rng(9)
    q = _t(np.stack([random_cloud(rng, 600) for _ in range(4)]).astype(np.float32), cuda_device)
    r = _t(np.stack([random_cloud(rng, 2100) for _ in range(2)]).astype(np.float32), cuda_device)
    m = torch.ones((2, 2100), dtype=torch.bool, device=cuda_device)
    m[1] = False
    d2, idx = nn1(q, r, m, torch.tensor([0, 1, 2, -1], dtype=torch.int32, device=cuda_device))
    want = nn1_plain(q[:2], r, m)
    _same_nn((d2[:2], idx[:2]), want)
    assert bool((d2[1] == 1e30).all())
    assert bool(torch.isnan(d2[2:]).all()) and bool((idx[2:] == -1).all())


# (L, Q, R, G, valid rows of one cloud, label, the plan nn1_plan picks on an
# H100's 132 SMs: (queries a thread, cluster)): every plan the rule can
# choose, the room's metric with its 704 padded rows, the overlap screen's
# ICP and the refine among them.
NN1_PLAN_CASES = [
    (1, 200704, 200704, 1, 200000, "room metric, 704 padded rows", (4, 2)),
    (8192, 512, 2048, 16, None, "overlap screen ICP, 16 clouds", (4, 2)),
    (300, 512, 300, 3, None, "4 queries a thread, R unsplit", (4, 1)),
    (4, 2048, 2048, 1, None, "refine", (2, 8)),
    (6, 700, 1500, 3, None, "a cluster of 4", (2, 4)),
    (1, 65536, 65536, 1, None, "K4 regime", (2, 2)),
    (3, 97, 300, 3, None, "2 queries a thread, R unsplit", (2, 1)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("lanes, q_n, r_n, groups, valid, label, chosen", NN1_PLAN_CASES,
                         ids=[c[5] for c in NN1_PLAN_CASES])
def test_nn1_kernel_matches_plain_at_every_plan(cuda_device, lanes, q_n, r_n, groups, valid, label, chosen):
    """The min-only scan at each plan the rule chooses, bit for bit against
    the plain version, and one launch a call counted under its plan."""
    rng = np.random.default_rng(lanes + q_n + r_n)
    q = _t(np.stack([random_cloud(rng, q_n) for _ in range(lanes)]).astype(np.float32), cuda_device)
    r = _t(np.stack([random_cloud(rng, r_n) for _ in range(groups)]).astype(np.float32), cuda_device)
    rows = torch.arange(r_n, device=cuda_device)[None]
    m = rows < (valid if valid is not None else _t(rng.integers(r_n // 2, r_n + 1, size=(groups, 1)), cuda_device))
    m = m.expand(groups, r_n).contiguous()
    lane_ref = torch.arange(groups, dtype=torch.int32, device=cuda_device).repeat_interleave(lanes // groups)
    plan = nn1_plan(lanes, q_n, r_n, torch.cuda.get_device_properties(cuda_device).multi_processor_count)
    if torch.cuda.get_device_properties(cuda_device).multi_processor_count == 132:
        assert (plan.queries, plan.cluster) == chosen
    nn1.plan_launches.clear()
    got = nn1(q, r, m, lane_ref)
    assert nn1.plan_launches == {(plan.queries, plan.cluster): 1}
    _same_nn(got, nn1_plain(q, r, m, lane_ref))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [2, 600])
def test_nn1_kernel_ties_and_masks_at_chunk_and_tile_borders(cuda_device, lanes):
    """Exact ties across the 32-row chunks, the 1024-row tiles and the
    slices, masked rows at a chunk's first and last row (their twins win),
    duplicate rows and a fully masked lane, at 2 queries a thread on a
    cluster of 8 and 4 on a cluster of 2: the first index wins as in the
    plain version."""
    r_n = 3000
    rng = np.random.default_rng(lanes)
    r = random_cloud(rng, 2 * r_n).astype(np.float32).reshape(2, r_n, 3)
    for a, b in ((31, 32), (63, 95), (1023, 1024), (5, 1500), (2047, 2048), (2990, 2999)):
        r[0, b] = r[0, a]  # the later row must lose
    r[0, 640:672] = r[0, 640]  # a whole chunk of duplicates
    m = np.ones((2, r_n), bool)
    m[1] = False  # a fully masked cloud
    for row in (64, 127, 1055, 2016):  # a chunk's first or last row, masked; its twin later in the cloud
        m[0, row] = False
        r[0, row + 7] = r[0, row]
    picks = [31, 32, 63, 95, 1023, 1024, 5, 1500, 2047, 2990, 640, 650, 64, 127, 1055, 2016]
    q = np.concatenate([r[0, picks], random_cloud(rng, 512 - len(picks)).astype(np.float32)])
    q = _t(np.broadcast_to(q, (lanes, 512, 3)).copy(), cuda_device)
    lane_ref = _t((np.arange(lanes) % 2).astype(np.int32), cuda_device)
    rt, mt = _t(r, cuda_device), _t(m, cuda_device)
    plan = nn1_plan(lanes, 512, r_n)
    assert plan.queries == (4 if lanes == 600 else 2)
    d2, idx = nn1(q, rt, mt, lane_ref)
    _same_nn((d2, idx), nn1_plain(q, rt, mt, lane_ref))
    assert idx[0, :12].tolist() == [31, 31, 63, 63, 1023, 1023, 5, 5, 2047, 2990, 640, 640]
    assert idx[0, 12:16].tolist() == [71, 134, 1062, 2023] and bool((d2[1] == 1e30).all())


@pytest.mark.cuda
def test_fps_kernel_matches_plain_and_jax(cuda_device):
    pts, mask = _fps_case(cuda_device)
    before = fps.launches
    idx, sm = fps(pts, mask, 24)
    assert fps.launches == before + 1
    idx_p, sm_p = farthest_point_sampling(pts, mask, 24)
    assert torch.equal(idx, idx_p) and torch.equal(sm, sm_p)
    np.testing.assert_array_equal(idx[0].cpu().numpy(), JAX_FPS_IDX)


@pytest.mark.cuda
# One block (1 to 16 points a thread in registers), then clusters of 2-16 blocks.
@pytest.mark.parametrize("p", [1, 757, 3072, 8192, 12801, 20000, 65536, 151552])
def test_fps_kernel_matches_plain_at_width(cuda_device, p):
    rng = np.random.default_rng(p)
    pts = _t(np.stack([random_cloud(rng, p) for _ in range(2)]).astype(np.float32), cuda_device)
    mask = torch.ones((2, p), dtype=torch.bool, device=cuda_device)
    mask[1, p - p // 50:] = False
    s = min(256, 2 * p + 3)  # P = 1: more samples than points
    idx, sm = fps(pts, mask, s)
    idx_p, sm_p = farthest_point_sampling(pts, mask, s)
    assert torch.equal(idx, idx_p) and torch.equal(sm, sm_p)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [700, 5000, 9000, 36004, 100004])
def test_fps_kernel_ties_short_clouds_and_steps(cuda_device, p):
    """Duplicate points (tied scores; past 8192 points a tile's copies lie
    in other blocks of the cluster, and from 36004 the blocks' borders cut
    the tiles), more samples than valid points, an invalid first point, and
    steps < S."""
    rng = np.random.default_rng(p + 1)
    base = random_cloud(rng, p // 4).astype(np.float32)
    pts = _t(np.stack([np.tile(base, (4, 1)), random_cloud(rng, p).astype(np.float32)]), cuda_device)
    mask = torch.ones((2, p), dtype=torch.bool, device=cuda_device)
    mask[1, 0] = False
    mask[1, 300:] = False  # 299 valid points, 512 samples
    for steps in (512, 200, 1, 0):
        idx, sm = fps(pts, mask, 512, steps)
        idx_p, sm_p = farthest_point_sampling(pts, mask, 512, steps)
        assert torch.equal(idx, idx_p) and torch.equal(sm, sm_p), steps
        assert not idx[:, steps:].any()


@pytest.mark.cuda
def test_resample_batch_steps_cut_is_bit_identical_on_the_card(cuda_device):
    from kss_icp_torch.models.kss_icp import resample_batch

    rng = np.random.default_rng(17)
    pts = _t(np.stack([random_cloud(rng, 3072), random_cloud(rng, 3072)]).astype(np.float32), cuda_device)
    mask = torch.ones((2, 3072), dtype=torch.bool, device=cuda_device)
    mask[1, 2900:] = False
    pn = torch.tensor([1534, 1400], device=cuda_device)
    cfg = KSSICPConfig()
    full = resample_batch(pts, mask, pn, cfg)
    cut = resample_batch(pts, mask, pn, cfg, steps=1534)
    cpu = resample_batch(pts.cpu(), mask.cpu(), pn.cpu(), cfg, steps=1534)
    for a, b, c in zip(cut, full, cpu):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)


def _fps_plans():
    """(cluster, slice kept in registers): every cluster size with a slice in
    registers and one in shared memory."""
    return [(c, reg) for c in (1, 2, 4, 8, 16) for reg in (True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("cluster, registers", _fps_plans())
def test_fps_kernel_at_every_cluster_size(cuda_device, cluster, registers):
    """Each cluster size the kernel takes, with the slice in registers (3000
    points a block, ragged) and in shared memory (9000), at an invalid first
    point of a later block, a block left wholly masked and steps < S: the
    plain version's picks."""
    from kss_icp_torch.ops.resample_cuda import block_plan

    per_block = 3000 if registers else 9000
    p = cluster * per_block - 7
    rng = np.random.default_rng(cluster * 2 + registers)
    pts = _t(np.stack([random_cloud(rng, p) for _ in range(2)]).astype(np.float32), cuda_device)
    mask = torch.ones((2, p), dtype=torch.bool, device=cuda_device)
    plan = block_plan(p, cluster)
    assert plan.registers == registers and plan.cluster * plan.slice >= p
    mask[0, plan.slice * (cluster - 1)] = False  # the first point of the last block
    mask[1, : plan.slice] = False  # the first block wholly masked
    mask[1, p - p // 3:] = False
    for s, steps in ((512, 512), (512, 300)):
        before = fps.launches
        idx, sm = fps(pts, mask, s, steps, plan=plan)
        assert fps.launches == before + 1
        idx_p, sm_p = farthest_point_sampling(pts, mask, s, steps)
        assert torch.equal(idx, idx_p) and torch.equal(sm, sm_p), (s, steps)


@pytest.mark.cuda
@pytest.mark.parametrize("batch, p, cluster", [(1, 3072, 1), (50, 8192, 1), (128, 8192, 1), (1, 8192, 16),
                                               (2, 8192, 16), (14, 8192, 8), (40, 20000, 2), (20, 20000, 4),
                                               (16, 20000, 8), (2, 151552, 16), (1, 40960, 16)])
def test_fps_plan_on_the_card(cuda_device, batch, p, cluster):
    """The plan the wrapper picks from the card's SM count, at the main
    path's clouds and batches and at batches whose plan is each cluster size
    on a card of 132 SMs: the plain version's picks."""
    from kss_icp_torch.ops.nn_cuda import sm_count
    from kss_icp_torch.ops.resample_cuda import fps_plan

    plan = fps_plan(batch, p, sm_count(cuda_device.index))
    assert plan.cluster == cluster or sm_count(cuda_device.index) != 132
    rng = np.random.default_rng(batch + p)
    pts = _t(rng.uniform(-1, 1, size=(batch, p, 3)).astype(np.float32), cuda_device)
    mask = _t(rng.uniform(size=(batch, p)) < 0.9, cuda_device)
    idx, sm = fps(pts, mask, 256, 200)
    idx_p, sm_p = farthest_point_sampling(pts, mask, 256, 200)
    assert torch.equal(idx, idx_p) and torch.equal(sm, sm_p), plan


@pytest.mark.cuda
def test_fps_kernel_at_max_points(cuda_device):
    """One cloud of MAX_POINTS = 2^18 points, 16384 a block in shared memory."""
    from kss_icp_torch.ops.nn_cuda import sm_count
    from kss_icp_torch.ops.resample_cuda import MAX_POINTS, fps_plan

    assert fps_plan(1, MAX_POINTS, sm_count(cuda_device.index))[:2] == (16, 16384)
    rng = np.random.default_rng(MAX_POINTS)
    pts = _t(random_cloud(rng, MAX_POINTS).astype(np.float32)[None], cuda_device)
    mask = torch.arange(MAX_POINTS, device=cuda_device)[None] != 5
    idx, sm = fps(pts, mask, 512)
    idx_p, sm_p = farthest_point_sampling(pts, mask, 512)
    assert torch.equal(idx, idx_p) and torch.equal(sm, sm_p)


@pytest.mark.cuda
def test_fps_kernel_refuses_a_cluster_the_card_cannot_schedule(cuda_device):
    """A cluster of 32 blocks (an H100 schedules up to 16): the card's
    occupancy query refuses it and the wrapper raises, with no launch and no
    fallback; the next launch runs as usual."""
    from kss_icp_torch.ops.resample_cuda import block_plan

    rng = np.random.default_rng(32)
    pts = _t(random_cloud(rng, 3200).astype(np.float32)[None], cuda_device)
    mask = torch.ones((1, 3200), dtype=torch.bool, device=cuda_device)
    before = fps.launches
    with pytest.raises(RuntimeError, match="fps: CUDA error"):
        fps(pts, mask, 64, plan=block_plan(3200, 32))
    assert fps.launches == before
    idx, _ = fps(pts, mask, 64)
    torch.cuda.synchronize()
    assert torch.equal(idx, farthest_point_sampling(pts, mask, 64)[0])


@pytest.mark.cuda
def test_fps_kernel_refuses_clouds_past_65536(cuda_device):
    """The limit was 65536 points a cloud; since the large-scan path it is
    MAX_POINTS (2^18): a cloud one point wider raises, with no fallback."""
    from kss_icp_torch.ops.resample_cuda import MAX_POINTS

    assert MAX_POINTS >= 151552  # the widest compacted scan pad of seeds 0-2
    pts = torch.zeros((1, MAX_POINTS + 1, 3), device=cuda_device)
    before = fps.launches
    with pytest.raises(ValueError, match=str(MAX_POINTS)):
        fps(pts, torch.ones((1, MAX_POINTS + 1), dtype=torch.bool, device=cuda_device), 8)
    assert fps.launches == before


@pytest.mark.cuda
def test_field_kernel_matches_plain_and_jax(cuda_device):
    args = _field_case(cuda_device)
    before = field_ave.launches
    got = field_ave(*args)
    assert field_ave.launches == before + 1
    assert torch.equal(got, field_ave_plain(*args))  # the culling kernel's "ave": the plain version's bits
    np.testing.assert_allclose(got.cpu().numpy(), JAX_FIELD, rtol=2e-5)
    assert torch.equal(got, field_ave(*args))  # no atomics: repeated runs agree bit for bit


def test_plain_field_dot_matches_recorded_jax_values():
    np.testing.assert_allclose(field_dot(*_field_case()).numpy(), JAX_FIELD_DOT, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_field_dot_kernel_matches_plain_and_jax(cuda_device, precision):
    args = _field_case(cuda_device)
    before = field_dot.launches
    got = field_dot(*args, precision=precision)
    assert field_dot.launches == before + 1
    torch.testing.assert_close(got, field_dot_plain(*args, precision=precision), rtol=2e-5, atol=0.0)
    assert torch.equal(got, field_dot(*args, precision=precision))  # no atomics: bit for bit
    if precision == "highest":
        np.testing.assert_allclose(got.cpu().numpy(), JAX_FIELD_DOT, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_field_dot_kernel_matches_plain_at_width(cuda_device, precision):
    """The escalation grid's shape (C=4096 at P=T=512 there; 1000 rotations
    here) with masked source and target rows and a ragged last tile."""
    rng = np.random.default_rng(21)
    src, tgt = _t(random_cloud(rng, 512).astype(np.float32), cuda_device), _t(
        random_cloud(rng, 1300).astype(np.float32), cuda_device)
    smask = torch.arange(512, device=cuda_device) < 500
    tmask = torch.arange(1300, device=cuda_device) < 1234
    rots = euler_xyz_matrix(coarse.rotation_grid(10, 6.3, cuda_device))
    got = field_dot(src, smask, tgt, tmask, rots, precision)
    torch.testing.assert_close(got, field_dot_plain(src, smask, tgt, tmask, rots, precision), rtol=2e-5, atol=0.0)


FIELD_VARIANTS = [("field_ave", None), ("field_dot", "highest"), ("field_dot", "high"), ("field_dot", "default")]
# name -> (grid steps, P, T, valid source rows, valid target rows): an int is a
# suffix mask (a padded cloud, as register_pair pads both to 2048), "scatter"
# masks a random third of the rows. The remesh pairs' pnumber runs 378-1534.
FIELD_CARD_CASES = {
    "suffix 378": (8, 2048, 2048, 378, 378),
    "suffix 1070": (8, 2048, 2048, 1070, 1070),
    "suffix 1534": (8, 2048, 2048, 1534, 1534),
    "scattered": (8, 2048, 2048, "scatter", "scatter"),
    "target fully masked": (8, 2048, 2048, 2000, 0),
    "source fully masked": (8, 2048, 2048, 0, 2000),
    "T not a multiple of the tile": (8, 2048, 4173, 2000, 4100),
    "C not a multiple of q": (9, 2048, 2048, 1534, 1534),
    "16^3 grid": (16, 512, 512, 500, 490),
    "8^3 grid, bench prefixes": (8, 512, 512, 378, 378),
    "few rotations, small P, long T": (3, 200, 3000, 190, 2900),
}


def _field_kernel(name, precision):
    if name == "field_ave":
        return field_ave, field_ave_plain, {}
    return field_dot, field_dot_plain, {"precision": precision}


def _mask(rng, n, valid, device):
    if valid == "scatter":
        return _t(rng.uniform(size=n) < 2 / 3, device)
    return torch.arange(n, device=device) < valid


def _field_card_case(device, steps, p, t, s_valid, t_valid):
    rng = np.random.default_rng(p + t + steps)
    src, tgt = (_t(random_cloud(rng, n).astype(np.float32), device) for n in (p, t))
    return src, _mask(rng, p, s_valid, device), tgt, _mask(rng, t, t_valid, device), euler_xyz_matrix(
        coarse.rotation_grid(steps, 6.3, device))


@pytest.mark.cuda
@pytest.mark.parametrize("name, precision", FIELD_VARIANTS)
@pytest.mark.parametrize("case", list(FIELD_CARD_CASES))
def test_field_kernels_match_plain_on_padded_clouds(cuda_device, case, name, precision):
    """Masked rows skipped, exactly: field_ave the plain version's bits,
    field_dot within rtol 2e-5 of it (its tensor-core sums), the same bits
    on a second run and, for suffix masks, the bits of the field of the
    valid prefix alone."""
    kernel, plain, kw = _field_kernel(name, precision)
    steps, p, t, s_valid, t_valid = FIELD_CARD_CASES[case]
    args = _field_card_case(cuda_device, *FIELD_CARD_CASES[case])
    before = kernel.launches
    got = kernel(*args, **kw)
    assert kernel.launches == before + 1
    if name == "field_ave":
        assert torch.equal(got, plain(*args, **kw))
    else:
        torch.testing.assert_close(got, plain(*args, **kw), rtol=2e-5, atol=0.0)
    assert torch.equal(got, kernel(*args, **kw))
    assert kernel.launches == before + 2
    if s_valid == 0:
        assert not got.any()
    if isinstance(s_valid, int) and isinstance(t_valid, int) and s_valid and t_valid:
        src, smask, tgt, tmask, rots = args
        prefix = kernel(src[:s_valid], smask[:s_valid], tgt[:t_valid], tmask[:t_valid], rots, **kw)
        assert torch.equal(got, prefix)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("case", list(FIELD_CARD_CASES))
def test_field_dot_matches_plain_whole_and_in_chunks(cuda_device, case, precision):
    """csrc/field_dot.cu with the target staged whole and in chunks of 128
    rows (the running mins in a device scratch): within rtol 2e-5 of the
    plain version, the same bits on a second run, the chunked launch the
    whole one's bits (the min is exact), every launch counted."""
    from kss_icp_torch.ops import coarse_cuda as cc

    args = _field_card_case(cuda_device, *FIELD_CARD_CASES[case])
    want = field_dot_plain(*args, precision=precision)
    before = field_dot.launches
    whole = field_dot(*args, precision)
    chunked = cc._field_dot(*args, precision, cap=128)
    assert field_dot.launches == before + 2
    torch.testing.assert_close(whole, want, rtol=2e-5, atol=0.0)
    assert torch.equal(whole, field_dot(*args, precision))
    assert torch.equal(chunked, whole)


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [None, 128])
@pytest.mark.parametrize("case", list(FIELD_CARD_CASES))
def test_field_ave_kernel_matches_plain_bit_for_bit(cuda_device, case, cap):
    """The culling kernel's "ave" statistic: the plain version's float64
    mean bit for bit, with the target whole and in chunks of 128 rows, 0
    for a fully masked source; each launch counted in field_ave's counts."""
    from kss_icp_torch.ops import coarse_cuda as cc

    args = _field_card_case(cuda_device, *FIELD_CARD_CASES[case])
    before, grids = field_ave.launches, field_ave.launch_grids[args[4].shape[0]]
    got = field_ave(*args) if cap is None else cc._field_cull("field_ave", field_ave, "ave", *args, cap=cap)
    assert field_ave.launches == before + 1 and field_ave.launch_grids[args[4].shape[0]] == grids + 1
    assert torch.equal(got, field_ave_plain(*args))


# Target rows a block stages at once: the wrapper's plan (the whole target
# at every FIELD_CARD_CASES shape) and 128 rows, walked in chunks.
CULL_CAPS = (None, 128)


def _cull(stat, args, cap, scanned=None):
    """The field_trim kernel at `stat` on args (source, masks, target,
    rotations): the public wrapper at the plan's share of the target, the
    wrapper's launch with `cap` rows a chunk otherwise."""
    from kss_icp_torch.ops import coarse_cuda as cc

    counter = cc.field_trim if stat in ("trim", "distances") else cc.field_sq
    if cap is None:
        if stat == "trim":
            return cc.field_trim(*args, 0.7, scanned=scanned)
        probe = {"distances": cc.field_trim_distances, "sqdistances": cc.field_sq_distances}
        if stat in probe:
            return probe[stat](*args, scanned=scanned)
        return cc.field_sq(*args, stat, scanned=scanned)
    return cc._field_cull(counter.__name__, counter, stat, *args, scanned=scanned, cap=cap)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FIELD_CARD_CASES))
def test_field_trim_kernel_matches_plain_bit_for_bit(cuda_device, case):
    """The probe mode: every (rotation, point) distance equals the plain
    version's bits (the culled min is exact), 0 at masked source points,
    with the target whole and in chunks; the fused trimmed field equals the
    plain one's bits at both, and each launch is counted."""
    from kss_icp_torch.ops.coarse_cuda import field_trim, field_trim_plain, rotate_sources
    from kss_icp_torch.ops.nn import nn_distances

    src, smask, tgt, tmask, rots = _field_card_case(cuda_device, *FIELD_CARD_CASES[case])
    want = nn_distances(rotate_sources(rots, src), smask, tgt, tmask)
    fused = field_trim_plain(src, smask, tgt, tmask, rots, 0.7)
    before = field_trim.launches
    args = (src, smask, tgt, tmask, rots)
    for cap in CULL_CAPS:
        assert torch.equal(_cull("distances", args, cap), want), cap
        assert torch.equal(_cull("trim", args, cap), fused), cap
    assert field_trim.launches == before + 2 * len(CULL_CAPS)


@pytest.mark.cuda
def test_icp_on_the_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(3)
    tgt = random_cloud(rng, 2048).astype(np.float32)
    base = tgt[rng.permutation(2048)[:512]] + rng.normal(0, 0.01, size=(512, 3)).astype(np.float32)
    rots = euler_xyz_matrix(_t(rng.uniform(-0.4, 0.4, size=(8, 3)).astype(np.float32)))
    src = torch.einsum("lij,nj->lni", rots, _t(base)) + 0.05
    smask, tmask = torch.ones(512, dtype=torch.bool), torch.ones(2048, dtype=torch.bool)
    params = ICPParams.from_config(KSSICPConfig())._replace(max_iterations=40)
    cpu = icp(src, smask, _t(tgt), tmask, params)
    gpu = icp(*(x.to(cuda_device) for x in (src, smask, _t(tgt), tmask)), params)
    assert int((gpu.iterations.cpu() - cpu.iterations).abs().max()) <= 1  # see the rotation-gate knife edge
    np.testing.assert_allclose(gpu.rotation.cpu().numpy(), cpu.rotation.numpy(), atol=1e-4)
    np.testing.assert_allclose(gpu.translation.cpu().numpy(), cpu.translation.numpy(), atol=1e-4)


@pytest.mark.cuda
def test_pipeline_on_the_card_matches_cpu_and_launches_every_kernel(cuda_device):
    cfg = KSSICPConfig(rotation_steps=4, max_candidates=4, max_resample_points=128, resample_pad=128,
                       max_icp_iterations=20, auto_escalate=False, coarse_points=64, coarse_target_points=64,
                       refine_candidates=2, refine_tier_iterations=3, refine_tier_target_points=64,
                       refine_max_iterations=4)
    meta = json.loads((FIXTURES / "remesh_transfer.json").read_text())
    for counter in (nn1, fps, field_ave):
        counter.launches = 0
    with np.load(FIXTURES / "remesh_transfer.npz") as z:
        for rec in meta[:3]:
            src, tgt = z[rec["name"] + "_src"], z[rec["name"] + "_tgt"]
            rmse = []
            for device in ("cpu", cuda_device):
                res = kt.register_pair(src, tgt, cfg, device=device)
                aligned = kt.apply_similarity(res.transform, _t(src, device))
                rmse.append(kt.registration_measure(aligned, tgt, device=device)["rmse"])
            assert abs(rmse[0] - rmse[1]) <= 1e-4, (rec["name"], rmse)
    assert nn1.launches > 0 and fps.launches > 0 and field_ave.launches > 0


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["vpu", "dot"])
def test_escalated_pair_on_the_card_matches_cpu(cuda_device, method):
    cfg = KSSICPConfig(rotation_steps=4, max_candidates=4, max_resample_points=128, resample_pad=128,
                       max_icp_iterations=8, screen_points=64, refine_candidates=2, overlap_escalate=False,
                       escalate_threshold=1e-9, escalate_rotation_steps=6, escalate_max_candidates=6,
                       escalate_coarse_points=64, escalate_coarse_target_points=64, coarse_method=method)
    meta = json.loads((FIXTURES / "remesh_transfer.json").read_text())
    with np.load(FIXTURES / "remesh_transfer.npz") as z:
        src, tgt = z[meta[7]["name"] + "_src"], z[meta[7]["name"] + "_tgt"]
    field = field_dot if method == "dot" else field_ave
    field.launches = 0
    rmse = []
    for device in ("cpu", cuda_device):
        res = kt.register_pair(src, tgt, cfg, device=device)
        aligned = kt.apply_similarity(res.transform, _t(src, device))
        rmse.append(kt.registration_measure(aligned, tgt, device=device)["rmse"])
        assert res.coarse.field.shape in ((4, 4, 4), (6, 6, 6))
    assert abs(rmse[0] - rmse[1]) <= 1e-4, rmse
    assert field.launches == 2  # the base grid and the escalation grid


@pytest.mark.cuda
def test_trimmed_scaled_icp_on_the_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(4)
    tgt = random_cloud(rng, 2048).astype(np.float32)
    base = tgt[rng.permutation(2048)[:512]] + rng.normal(0, 0.01, size=(512, 3)).astype(np.float32)
    base[:100] += 0.3  # points without a counterpart: the trim's work
    rots = euler_xyz_matrix(_t(rng.uniform(-0.4, 0.4, size=(8, 3)).astype(np.float32)))
    src = 1.2 * torch.einsum("lij,nj->lni", rots, _t(base)) + 0.05
    smask, tmask = torch.ones(512, dtype=torch.bool), torch.ones(2048, dtype=torch.bool)
    params = ICPParams.from_config(KSSICPConfig(rotation_epsilon=-1.0))._replace(max_iterations=40)
    kw = dict(trim_fraction=0.7, estimate_scale=True)
    cpu = icp(src, smask, _t(tgt), tmask, params, **kw)
    gpu = icp(*(x.to(cuda_device) for x in (src, smask, _t(tgt), tmask)), params, **kw)
    assert torch.equal(gpu.iterations.cpu(), cpu.iterations)
    for f in ("rotation", "translation", "scale"):
        np.testing.assert_allclose(getattr(gpu, f).cpu().numpy(), getattr(cpu, f).numpy(), atol=1e-4)


@pytest.mark.cuda
def test_overlap_ladder_on_the_card_matches_cpu(cuda_device):
    """A partial pair through the whole ladder at tiny sizes: the same rungs
    run on the card as on the CPU, field_trim and nn1's per-lane references
    launched."""
    from kss_icp_torch.challenge import partial_corpus
    from kss_icp_torch.ops.coarse_cuda import field_trim

    cfg = KSSICPConfig(rotation_steps=4, max_candidates=4, max_resample_points=160, resample_pad=192,
                       max_icp_iterations=12, screen_points=64, refine_candidates=2, escalate_rotation_steps=5,
                       escalate_max_candidates=5, escalate_coarse_points=64, escalate_coarse_target_points=64,
                       overlap_screen_steps=4, overlap_screen_iters=4, overlap_iterations=2,
                       escalate_threshold=1e-9, overlap_threshold=1e-9, overlap_adopt_margin=0.8)
    name, src, tgt, gt = partial_corpus(n_points=1500)[7]
    field_trim.launches = 0
    runs = []
    for device in ("cpu", cuda_device):
        stages = []
        res = kt.register_pair(src, tgt, cfg, device=device, timer=lambda s: stages.append(s) or _null())
        runs.append((stages, res))
    assert runs[0][0] == runs[1][0] and {"overlap8", "overlap16", "overlap_screen"} <= set(runs[0][0])
    for f in ("rotation", "translation", "scale"):
        np.testing.assert_allclose(getattr(runs[1][1].transform, f).cpu().numpy(),
                                   getattr(runs[0][1].transform, f).numpy(), atol=1e-4)
    # Two overlap solves of 2 fields each (the 4^3 and 5^3 grids).
    assert field_trim.launches == 4


@pytest.mark.cuda
def test_overlap_mode_on_the_card_matches_cpu(cuda_device):
    """overlap_mode=True as the JAX package's CLI sets it (`--overlap`:
    cfg.overlap_config()): the overlap solve alone, its 2 trimmed fields on
    the card."""
    from kss_icp_torch.challenge import partial_corpus
    from kss_icp_torch.ops.coarse_cuda import field_trim

    cfg = KSSICPConfig(rotation_steps=4, max_candidates=4, max_resample_points=160, resample_pad=192,
                       max_icp_iterations=12, screen_points=64, refine_candidates=2,
                       overlap_iterations=2).overlap_config()
    name, src, tgt, gt = partial_corpus(n_points=1500)[2]
    field_trim.launches = 0
    cpu, gpu = (kt.register_pair(src, tgt, cfg, device=d) for d in ("cpu", cuda_device))
    for f in ("rotation", "translation", "scale"):
        np.testing.assert_allclose(getattr(gpu.transform, f).cpu().numpy(), getattr(cpu.transform, f).numpy(),
                                   atol=1e-4)
    np.testing.assert_allclose(float(gpu.fitness), float(cpu.fitness), rtol=1e-3)
    assert field_trim.launches == 2


def _null():
    import contextlib

    return contextlib.nullcontext()


@pytest.mark.cuda
def test_unbuilt_or_foreign_inputs_raise(cuda_device):
    q = torch.zeros((1, 4, 3), device=cuda_device)
    with pytest.raises(TypeError):
        nn1(q.double(), q.double(), torch.ones((1, 4), dtype=torch.bool, device=cuda_device))
    with pytest.raises(ValueError):
        nn1(q, q.cpu(), torch.ones((1, 4), dtype=torch.bool))
    with pytest.raises(ValueError):
        nn1(q[:, ::2], q, torch.ones((1, 4), dtype=torch.bool, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("pairs, lanes, q_n, r_n", [(3, 32, 512, 2048), (3, 4, 2048, 2048), (3, 1, 8192, 8192),
                                                    (5, 3, 301, 777)])
def test_nn1_kernel_matches_plain_with_a_cloud_a_pair(cuda_device, pairs, lanes, q_n, r_n):
    """The batched path's shapes: pair b's lanes against pair b's cloud
    (lane_ref = the lane's pair), each cloud with its own padded tail."""
    rng = np.random.default_rng(pairs * lanes + q_n)
    q = _t(np.stack([random_cloud(rng, q_n) for _ in range(pairs * lanes)]).astype(np.float32), cuda_device)
    r = _t(np.stack([random_cloud(rng, r_n) for _ in range(pairs)]).astype(np.float32), cuda_device)
    m = torch.ones((pairs, r_n), dtype=torch.bool, device=cuda_device)
    for b in range(pairs):
        m[b, r_n - (b + 1) * r_n // 11:] = False
    lane_ref = torch.arange(pairs, dtype=torch.int32, device=cuda_device).repeat_interleave(lanes)
    _same_nn(nn1(q, r, m, lane_ref), nn1_plain(q, r, m, lane_ref))


@pytest.mark.cuda
def test_register_many_on_the_card_matches_cpu(cuda_device):
    """Three partial pairs through register_many and the whole ladder at tiny
    sizes: the same ladder and poses on the card as on the CPU, one fps
    launch for the batch's resample and one field launch a pair and grid."""
    from kss_icp_torch.ladder_log import LadderLog
    from kss_icp_torch import escalate
    from kss_icp_torch.challenge import partial_corpus
    from kss_icp_torch.ops.coarse_cuda import field_trim

    cfg = KSSICPConfig(rotation_steps=4, max_candidates=4, max_resample_points=160, resample_pad=192,
                       max_icp_iterations=12, screen_points=64, refine_candidates=2, escalate_rotation_steps=5,
                       escalate_max_candidates=5, escalate_coarse_points=64, escalate_coarse_target_points=64,
                       overlap_screen_steps=4, overlap_screen_iters=4, overlap_iterations=2,
                       escalate_threshold=1e-9, overlap_threshold=1e-9, overlap_adopt_margin=0.8)
    pairs = [(s, t) for i, (_, s, t, _) in enumerate(partial_corpus(n_points=1500)) if i in (0, 2, 7)]
    runs = []
    for device in ("cpu", cuda_device):
        for counter in (nn1, fps, field_ave, field_trim):
            counter.launches = 0
        with LadderLog(escalate, len(pairs)) as ladder:
            res, metrics = kt.register_many(pairs, cfg, full_pad=1536, device=device)
        runs.append((res, metrics, ladder, {c.__name__: c.launches for c in (nn1, fps, field_ave, field_trim)}))
    (cpu, m_cpu, l_cpu, _), (gpu, m_gpu, l_gpu, launches) = runs
    for f in ("escalated", "won", "finisher"):
        assert getattr(l_gpu, f).tolist() == getattr(l_cpu, f).tolist(), f
    assert [[(r["ran"], r["adopted"]) for r in rows] for rows in l_gpu.rungs] == \
        [[(r["ran"], r["adopted"]) for r in rows] for rows in l_cpu.rungs]
    for f in ("rotation", "translation", "scale"):
        np.testing.assert_allclose(getattr(gpu.transform, f).cpu().numpy(), getattr(cpu.transform, f).numpy(),
                                   atol=1e-4)
    np.testing.assert_allclose(m_gpu["rmse"], m_cpu["rmse"], atol=1e-4)
    field_rungs = sum(r["ran"] for rows in l_gpu.rungs for r in rows if r["rung"] != "overlap_screen")
    # fps once; field_ave on the base and the escalation grid for each pair;
    # field_trim twice (overlap_iterations) a pair and field rung that ran.
    assert launches["fps"] == 1 and launches["nn1"] > 0
    assert launches["field_ave"] == 2 * len(pairs) and launches["field_trim"] == 2 * field_rungs > 0


@pytest.mark.cuda
def test_fps_kernel_at_the_large_scan_pad(cuda_device):
    """The large-scan resample: two clouds at the widest compacted pad, 151552
    points, with the octree survivors of seed 2 valid (93625 and 148008), to
    2048 samples in 2000 steps: bit-identical to the plain version."""
    rng = np.random.default_rng(151552)
    pts = _t(np.stack([random_cloud(rng, 151552) for _ in range(2)]).astype(np.float32), cuda_device)
    rows = torch.arange(151552, device=cuda_device)
    mask = torch.stack([rows < 93625, rows < 148008])
    from kss_icp_torch.ops.nn_cuda import sm_count
    from kss_icp_torch.ops.resample_cuda import fps_plan

    plan = fps_plan(2, 151552, sm_count(cuda_device.index))
    assert plan.cluster > 1 and 93625 < plan.slice * (plan.cluster - 1)  # the first cloud leaves blocks masked
    before = fps.launches
    idx, sm = fps(pts, mask, 2048, 2000)
    assert fps.launches == before + 1
    idx_p, sm_p = farthest_point_sampling(pts, mask, 2048, 2000)
    assert torch.equal(idx, idx_p) and torch.equal(sm, sm_p)


@pytest.mark.cuda
def test_nn1_kernel_at_131072_squared_on_a_query_subset(cuda_device):
    """The full-resolution metric's regime, 1 x 131072 x 131072 with a padded
    reference tail: the kernel over every query, the plain version on 4096
    queries spread over the cloud and the last 1024 (bits equal)."""
    rng = np.random.default_rng(131072)
    n = 131072
    q = _t(random_cloud(rng, n).astype(np.float32)[None], cuda_device)
    r = _t(random_cloud(rng, n).astype(np.float32)[None], cuda_device)
    m = torch.arange(n, device=cuda_device)[None] < n - 3000
    d2, idx = nn1(q, r, m)
    rows = torch.cat([torch.arange(0, n, 32, device=cuda_device), torch.arange(n - 1024, n, device=cuda_device)])
    d2_p, idx_p = nn1_plain(q[:, rows].contiguous(), r, m)
    assert torch.equal(idx[:, rows], idx_p) and torch.equal(d2[:, rows], d2_p)


@pytest.mark.cuda
@pytest.mark.parametrize("n_points, target", [(20_000, 5_000), (200_000, 80_000)])
def test_octree_simplify_on_the_card_matches_cpu(cuda_device, n_points, target):
    """The Room pair's octree survivors on the card equal the CPU's bit for
    bit (the CPU's equal JAX's: tests/test_torch_largescan.py)."""
    from kss_icp_torch import largescan
    from kss_icp_torch.ops.simplify import octree_simplify

    src, tgt, _ = largescan.room_pair(n_points, 0)
    center = tgt.mean(axis=0)
    nscale = float(np.abs(tgt - center).max())
    pad = ((n_points + 4095) // 4096) * 4096
    for x in (src, tgt):
        pts, mask = largescan._pad(((x - center) / nscale).astype(np.float32), pad)
        cpu = octree_simplify(_t(pts), _t(mask), target)
        gpu = octree_simplify(_t(pts, cuda_device), _t(mask, cuda_device), target)
        assert torch.equal(gpu[1].cpu(), cpu[1]) and torch.equal(gpu[0].cpu(), cpu[0])


@pytest.mark.cuda
def test_run_largescan_on_the_card_matches_cpu(cuda_device):
    """run_largescan at 20k points on the tiny config of tests/test_largescan.py:
    the same survivors, pnumber and escalation on the card as on the CPU, the
    unit-scale RMSE within the 0.006 parity bar, one fps launch and the
    metric as one nn1 launch at 1 x 20480 x 20480."""
    from kss_icp_torch import largescan

    cfg = KSSICPConfig(max_candidates=6, coarse_points=512, coarse_target_points=512, refine_candidates=2,
                       refine_tier_iterations=12, refine_max_iterations=48)
    cpu = largescan.run_largescan(20_000, 5_000, cfg, seed=0, device="cpu")
    fps.launches = nn1.launches = 0
    nn1.launch_shapes.clear()
    gpu = largescan.run_largescan(20_000, 5_000, cfg, seed=0, device=cuda_device)
    assert fps.launches == 1 and nn1.launch_shapes[(1, 20480, 20480, 1)] == 1
    for k in ("n_s", "n_t", "resample_count", "pnumber", "escalated"):
        assert gpu[k] == cpu[k], k
    assert abs(gpu["unit_rmse"] - cpu["unit_rmse"]) <= 0.006 and gpu["pose_rmse"] < 0.3


@pytest.mark.cuda
@pytest.mark.parametrize("pairs, lanes", [(1, 12), (25, 12)])
def test_nn1_kernel_matches_plain_at_the_polish_shapes(cuda_device, pairs, lanes):
    """Precision mode's lanes (models/kss_icp.py::neighborhood_polish): 12 a
    pair at 2048 x 2048, one pair (register_pair) or the remesh 25 as one
    batch (register_many), each pair's target with its own valid prefix."""
    rng = np.random.default_rng(pairs)
    q = _t(np.stack([random_cloud(rng, 2048) for _ in range(pairs * lanes)]).astype(np.float32), cuda_device)
    r = _t(np.stack([random_cloud(rng, 2048) for _ in range(pairs)]).astype(np.float32), cuda_device)
    m = torch.arange(2048, device=cuda_device)[None] < _t(rng.integers(378, 1535, size=(pairs, 1)), cuda_device)
    lane_ref = torch.arange(pairs, dtype=torch.int32, device=cuda_device).repeat_interleave(lanes)
    _same_nn(nn1(q, r, m, lane_ref), nn1_plain(q, r, m, lane_ref))


@pytest.mark.cuda
def test_precise_register_on_the_card_matches_cpu(cuda_device):
    """neighborhood_fracs on a tiny config, one pair and a batch of three:
    the same poses on the card as on the CPU, and the polish's 12 lanes a
    pair launched as one nn1 shape."""
    cfg = KSSICPConfig(rotation_steps=4, max_candidates=4, max_resample_points=128, resample_pad=128,
                       max_icp_iterations=40, screen_points=64, refine_candidates=2, auto_escalate=False,
                       neighborhood_fracs=(0.25, 0.5))
    meta = json.loads((FIXTURES / "remesh_transfer.json").read_text())
    with np.load(FIXTURES / "remesh_transfer.npz") as z:
        pairs = [(z[r["name"] + "_src"], z[r["name"] + "_tgt"]) for r in meta[:3]]
    nn1.launch_shapes.clear()
    for src, tgt in pairs:
        cpu = kt.register_pair(src, tgt, cfg, device="cpu")
        gpu = kt.register_pair(src, tgt, cfg, device=cuda_device)
        assert abs(float(gpu.fitness) - float(cpu.fitness)) <= 1e-3 * float(cpu.fitness)
        np.testing.assert_allclose(gpu.transform.rotation.cpu().numpy(), cpu.transform.rotation.numpy(), atol=1e-3)
    assert nn1.launch_shapes[(12, 128, 128, 1)] > 0
    res, metrics = kt.register_many(pairs, cfg, full_pad=8192, device=cuda_device)
    assert nn1.launch_shapes[(36, 128, 128, 3)] > 0 and np.isfinite(metrics["rmse"]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FIELD_CARD_CASES))
def test_field_sq_kernel_matches_plain_bit_for_bit(cuda_device, case):
    """The squared probe mode: every (rotation, point) squared distance
    equals the plain version's bits (the raw min, 1e30-biased against a fully
    masked target), 0 at masked source points, with the target whole and in
    chunks; the fused "max" and "diff" fields equal the plain ones' bits."""
    from kss_icp_torch.ops.coarse_cuda import SQ_PLAIN, field_sq, rotate_sources
    from kss_icp_torch.ops.nn import nn_sqdistances

    src, smask, tgt, tmask, rots = args = _field_card_case(cuda_device, *FIELD_CARD_CASES[case])
    want = nn_sqdistances(rotate_sources(rots, src), smask, tgt, tmask)
    before = field_sq.launches
    for cap in CULL_CAPS:
        assert torch.equal(_cull("sqdistances", args, cap), want), cap
        for metric, plain in SQ_PLAIN.items():
            assert torch.equal(_cull(metric, args, cap), plain(*args)), (metric, cap)
    assert field_sq.launches == before + 3 * len(CULL_CAPS)


@pytest.mark.cuda
def test_field_sq_kernel_against_a_fully_masked_target(cuda_device):
    """The biased path: no valid target row, every valid point's value the
    plain version's 1e30 + d², bit for bit."""
    from kss_icp_torch.ops.coarse_cuda import field_sq_distances, rotate_sources
    from kss_icp_torch.ops.nn import nn_sqdistances

    rng = np.random.default_rng(11)
    src, tgt = (_t(random_cloud(rng, n).astype(np.float32), cuda_device) for n in (700, 600))
    smask = torch.arange(700, device=cuda_device) < 650
    tmask = torch.zeros(600, dtype=torch.bool, device=cuda_device)
    rots = euler_xyz_matrix(coarse.rotation_grid(3, 6.3, cuda_device))
    got = field_sq_distances(src, smask, tgt, tmask, rots)
    assert torch.equal(got, nn_sqdistances(rotate_sources(rots, src), smask, tgt, tmask))
    assert bool((got[:, smask] == 1e30).all()) and not got[:, ~smask].any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(cull_probe_cases()))
def test_field_cull_probes_on_the_card(cuda_device, case):
    """The culling probes (tile faces and corners, duplicate rows, near-equal
    distances, one valid row, a single tile, P not a multiple of 32): both
    probe modes and the three fields equal the plain versions' bits, whole
    and in chunks, and the counter of scanned pairs stays within the pairs
    there are."""
    from kss_icp_torch.ops.coarse_cuda import SQ_PLAIN, field_trim_plain, rotate_sources
    from kss_icp_torch.ops.nn import nn_distances, nn_sqdistances

    src, smask, tgt, tmask, rots = args = tuple(_t(x, cuda_device) for x in cull_probe_cases()[case])
    rotated = rotate_sources(rots, src)
    for cap in CULL_CAPS:
        scanned = torch.zeros(2, dtype=torch.int64, device=cuda_device)
        got = _cull("sqdistances", args, cap, scanned)
        assert torch.equal(got, nn_sqdistances(rotated, smask, tgt, tmask)), cap
        pairs = rots.shape[0] * int(smask.sum()) * int(tmask.sum())
        assert 0 < int(scanned[0]) <= pairs and int(scanned[1]) > 0
        assert torch.equal(_cull("distances", args, cap), nn_distances(rotated, smask, tgt, tmask)), cap
        assert torch.equal(_cull("trim", args, cap), field_trim_plain(*args, 0.7)), cap
        for metric, plain in SQ_PLAIN.items():
            assert torch.equal(_cull(metric, args, cap), plain(*args)), (metric, cap)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["scattered", "T not a multiple of the tile", "few rotations, small P, long T",
                                  "target fully masked"])
def test_field_keys_kernel_matches_plain(cuda_device, case):
    """field_order's keys from the keys kernel: the plain version's bits
    (the same rounding of the cell), one counted launch."""
    from kss_icp_torch.ops.coarse_cuda import field_keys, field_keys_plain

    src, smask, tgt, tmask, _ = _field_card_case(cuda_device, *FIELD_CARD_CASES[case])
    before = field_keys.launches
    got = field_keys(src, smask, tgt, tmask)
    assert field_keys.launches == before + 1
    assert torch.equal(got, field_keys_plain(src, smask, tgt, tmask))


@pytest.mark.cuda
def test_field_trim_at_4096_rotations_allocates_no_per_point_buffer(cuda_device):
    """The 16³ overlap field at full resolution, 4096 x 2048 x 2048: the fused
    call's peak allocation stays far below the (C, P) buffer (33.5 MB) and
    the (C, P, 3) rotated source (100 MB) the per-point path held; the field
    equals the plain version's bits, and a block's share of pairs scanned is
    below the whole."""
    from kss_icp_torch.ops.coarse_cuda import field_trim, field_trim_plain

    rng = np.random.default_rng(4096)
    src, tgt = (_t(random_cloud(rng, 2048).astype(np.float32), cuda_device) for _ in range(2))
    smask = (torch.arange(2048, device=cuda_device) < 2000) & _t(rng.uniform(size=2048) < 0.7, cuda_device)
    tmask = (torch.arange(2048, device=cuda_device) < 2000) & _t(rng.uniform(size=2048) < 0.7, cuda_device)
    rots = euler_xyz_matrix(coarse.rotation_grid(16, 6.3, cuda_device))
    field_trim(src, smask, tgt, tmask, rots, 0.7)  # the library built, the constants cached
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda_device)
    base = torch.cuda.memory_allocated(cuda_device)
    scanned = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    got = field_trim(src, smask, tgt, tmask, rots, 0.7, scanned=scanned)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(cuda_device) - base
    assert peak < 4 << 20, peak  # the sort's keys and indices, the (C,) output
    assert torch.equal(got, field_trim_plain(src, smask, tgt, tmask, rots, 0.7))
    assert 0 < int(scanned[0]) < 4096 * int(smask.sum()) * int(tmask.sum())


@pytest.mark.cuda
def test_field_sq_past_shared_memory_matches_plain_bit_for_bit(cuda_device):
    """A source past FIELD_MAX_POINTS (the mins in a (C, P) device scratch)
    against a target longer than a block's share (walked in chunks): the
    squared probe values and the "max" and "diff" fields equal the plain
    versions' bits, one counted launch each."""
    from kss_icp_torch.ops.coarse_cuda import FIELD_MAX_POINTS, SQ_PLAIN, field_cull_plan, field_sq, rotate_sources
    from kss_icp_torch.ops.nn import nn_sqdistances

    p_n, t_n = FIELD_MAX_POINTS + 3000, 14000
    rng = np.random.default_rng(37)
    src, tgt = (_t(random_cloud(rng, n).astype(np.float32), cuda_device) for n in (p_n, t_n))
    smask = _t(rng.uniform(size=p_n) < 0.8, cuda_device)
    tmask = _t(rng.uniform(size=t_n) < 0.95, cuda_device)
    rots = euler_xyz_matrix(coarse.rotation_grid(2, 6.3, cuda_device))
    args = (src, smask, tgt, tmask, rots)
    assert field_cull_plan(p_n, t_n, "max") < int(tmask.sum())  # two chunks
    before = field_sq.launches
    assert torch.equal(_cull("sqdistances", args, None), nn_sqdistances(rotate_sources(rots, src), smask, tgt, tmask))
    for metric, plain in SQ_PLAIN.items():
        assert torch.equal(_cull(metric, args, None), plain(*args)), metric
    assert field_sq.launches == before + 3


@pytest.mark.cuda
def test_aivs_on_the_card_matches_cpu(cuda_device):
    """AIVS of a batch of clouds: the card's picks and packing equal the
    CPU's bit for bit (the box centroids' sums add in index order on both),
    twice in a row."""
    from kss_icp_torch.ops.aivs import aivs_resample_packed

    rng = np.random.default_rng(12)
    pts = np.stack([random_cloud(rng, 3000) for _ in range(4)]).astype(np.float32)
    mask = np.arange(3000)[None] < np.array([[3000], [2500], [1200], [2999]])
    samples = np.array([1000, 800, 600, 1400])
    cpu = aivs_resample_packed(_t(pts), _t(mask), _t(samples), 2048, 10)
    for _ in range(2):
        gpu = aivs_resample_packed(*(_t(x, cuda_device) for x in (pts, mask, samples)), 2048, 10)
        for g, c in zip(gpu, cpu):
            assert torch.equal(g.cpu(), c)


@pytest.mark.cuda
def test_normals_and_point_to_plane_on_the_card_match_cpu(cuda_device):
    """PCA normals of a batch (cuSOLVER's eigh) against the CPU's (LAPACK's)
    to |n · n_cpu| >= 1 - 1e-5, and point-to-plane ICP lanes against them:
    the same iterations, the pose within 1e-4."""
    from kss_icp_torch.ops.normals import estimate_normals

    rng = np.random.default_rng(13)
    tgt = np.stack([random_cloud(rng, 2048) for _ in range(3)]).astype(np.float32)
    tmask = np.arange(2048)[None] < np.array([[2048], [2000], [1500]])
    n_cpu = estimate_normals(_t(tgt), _t(tmask))
    n_gpu = estimate_normals(_t(tgt, cuda_device), _t(tmask, cuda_device))
    assert float((n_gpu.cpu() * n_cpu).sum(-1).abs()[_t(tmask)].min()) >= 1 - 1e-5
    base = tgt[0][rng.permutation(2000)[:512]] + rng.normal(0, 0.005, size=(512, 3)).astype(np.float32)
    rots = euler_xyz_matrix(_t(rng.uniform(-0.3, 0.3, size=(8, 3)).astype(np.float32)))
    src = torch.einsum("lij,nj->lni", rots, _t(base)) + 0.03
    smask = torch.ones(512, dtype=torch.bool)
    params = ICPParams.from_config(KSSICPConfig())._replace(max_iterations=30)
    cpu = icp(src, smask, _t(tgt[0]), _t(tmask[0]), params, variant="point_to_plane", target_normals=n_cpu[0])
    gpu = icp(*(x.to(cuda_device) for x in (src, smask, _t(tgt[0]), _t(tmask[0]))), params,
              variant="point_to_plane", target_normals=n_cpu[0].to(cuda_device))
    assert torch.equal(gpu.iterations.cpu(), cpu.iterations)
    for f in ("rotation", "translation"):
        np.testing.assert_allclose(getattr(gpu, f).cpu().numpy(), getattr(cpu, f).numpy(), atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", [dict(resampler="aivs"), dict(icp_variant="point_to_plane"),
                                   dict(coarse_error_metric="max"), dict(coarse_error_metric="diff")])
def test_register_pair_knobs_on_the_card_match_cpu(cuda_device, knobs):
    """A remesh pair through register_pair with each knob at a small config:
    the RMSE on the card within 1e-4 of the CPU's; the "max" and "diff"
    fields through field_sq."""
    from kss_icp_torch.ops.coarse_cuda import field_sq

    cfg = KSSICPConfig(rotation_steps=4, max_candidates=4, max_resample_points=512, resample_pad=512,
                       max_icp_iterations=30, screen_points=128, refine_candidates=2, auto_escalate=False, **knobs)
    meta = json.loads((FIXTURES / "remesh_transfer.json").read_text())
    with np.load(FIXTURES / "remesh_transfer.npz") as z:
        src, tgt = z[meta[3]["name"] + "_src"], z[meta[3]["name"] + "_tgt"]
    field_sq.launches = 0
    rmse = []
    for device in ("cpu", cuda_device):
        res = kt.register_pair(src, tgt, cfg, device=device)
        aligned = kt.apply_similarity(res.transform, _t(src, device))
        rmse.append(kt.registration_measure(aligned, tgt, device=device)["rmse"])
    assert abs(rmse[0] - rmse[1]) <= 1e-4, rmse
    assert field_sq.launches == (1 if "coarse_error_metric" in knobs else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n, s", [(4096, 512), (40960, 8000)])
def test_fps_points_on_the_card_matches_plain(cuda_device, n, s):
    """fps_points through one fps launch: the plain version's points and
    mask exactly, at a test cloud and at WLOP's start of a 40960-point
    original."""
    from kss_icp_torch.ops.resample import fps_points

    pts = random_cloud(np.random.default_rng(14), n).astype(np.float32)
    mask = np.ones(n, bool)
    mask[-7:] = False
    fps.launches = 0
    got = fps_points(_t(pts, cuda_device), _t(mask, cuda_device), s)
    assert fps.launches == 1
    want = fps_points(_t(pts), _t(mask), s)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_wlop_on_the_card_matches_cpu(cuda_device):
    """WLOP on the card (one fps launch, then plain PyTorch) against the CPU
    run at the WLOP bar: the same start and mask, samples within a median
    |Δ| of 5e-5 and a max of 2e-3 bounding-box diagonals."""
    from kss_icp_torch.ops.wlop import wlop_resample

    pts = random_cloud(np.random.default_rng(15), 4096).astype(np.float32)
    mask = np.ones(4096, bool)
    fps.launches = 0
    gx, gm = wlop_resample(_t(pts, cuda_device), _t(mask, cuda_device), 512)
    assert fps.launches == 1
    cx, cm = wlop_resample(_t(pts), _t(mask), 512)
    assert torch.equal(gm.cpu(), cm)
    start_g, _ = wlop_resample(_t(pts, cuda_device), _t(mask, cuda_device), 512, iterations=0)
    assert torch.equal(start_g.cpu(), wlop_resample(_t(pts), _t(mask), 512, iterations=0)[0])
    d = (gx.cpu() - cx).norm(dim=1).numpy() / np.linalg.norm(pts.max(0) - pts.min(0))
    assert np.median(d) <= 5e-5 and d.max() <= 2e-3, (np.median(d), d.max())


@pytest.mark.cuda
@pytest.mark.parametrize("n, cluster, variation", [(8192, 10, 1 / 3), (40960, 10, 1 / 3), (4096, 64, 0.05)])
def test_hierarchy_simplify_on_the_card_matches_cpu(cuda_device, n, cluster, variation):
    """The card's kept set equals the CPU's bit for bit: the segment sums
    add in index order on both (ops/spatial.py::segment_reduce), and the
    variation stop's eigenvalues (cuSOLVER against LAPACK) decide no split
    otherwise on this cloud."""
    from kss_icp_torch.ops.simplify import hierarchy_simplify

    pts = random_cloud(np.random.default_rng(16), n).astype(np.float32)
    mask = np.ones(n, bool)
    mask[-5:] = False
    gp, gk = hierarchy_simplify(_t(pts, cuda_device), _t(mask, cuda_device), cluster, variation)
    cp, ck = hierarchy_simplify(_t(pts), _t(mask), cluster, variation)
    assert torch.equal(gk.cpu(), ck) and torch.equal(gp.cpu(), cp)


@pytest.mark.cuda
def test_vcm_on_the_card_matches_cpu(cuda_device):
    """vcm_edges on the card (one nn1 launch for the sample owners) against
    the CPU on the same samples: the owners bit for bit, the matrices within
    rtol 1e-5 of their largest entry (the matmul sums in another order), the
    flags equal away from the threshold."""
    from kss_icp_torch.ops import vcm

    pts = random_cloud(np.random.default_rng(17), 2048).astype(np.float32)
    mask = np.arange(2048) < 2000
    samples = vcm.ball_samples(_t(pts), 0.15, 8, torch.Generator().manual_seed(0))
    nn1.launches = 0
    owner, dom = vcm.sample_owners(samples.to(cuda_device), _t(pts, cuda_device), _t(mask, cuda_device), 0.15)
    assert nn1.launches == 1
    cowner, cdom = vcm.sample_owners(samples, _t(pts), _t(mask), 0.15)
    assert torch.equal(owner.cpu(), cowner) and torch.equal(dom.cpu(), cdom)
    g = vcm.vcm_edges(_t(pts, cuda_device), _t(mask, cuda_device), 0.15, 0.1, samples=samples.to(cuda_device),
                      samples_per_point=8)
    c = vcm.vcm_edges(_t(pts), _t(mask), 0.15, 0.1, samples=samples, samples_per_point=8)
    np.testing.assert_allclose(g[1].cpu().numpy(), c[1].numpy(), atol=1e-5)
    firm = (c[1] - 0.16).abs() > 1e-5
    assert torch.equal(g[0].cpu()[firm], c[0][firm])


@pytest.mark.cuda
def test_lloyd_relax_on_the_card_matches_cpu(cuda_device):
    """lloyd_relax on the card (an nn1 launch a step for the labels) equals
    the CPU's bits: exact labels, segment sums in pixel order on both."""
    from kss_icp_torch.ops.voronoi2d import lloyd_relax

    sites = np.random.default_rng(18).uniform(0, 1, (300, 2)).astype(np.float32)
    mask = np.arange(300) < 290
    nn1.launches = 0
    got = lloyd_relax(_t(sites, cuda_device), _t(mask, cuda_device), (0.0, 0.0, 1.0, 1.0), 256, 5)
    assert nn1.launches == 5
    assert torch.equal(got.cpu(), lloyd_relax(_t(sites), _t(mask), (0.0, 0.0, 1.0, 1.0), 256, 5))


@pytest.mark.cuda
def test_mesh_angles_and_two_stage_on_the_card_match_cpu(cuda_device):
    """mesh_angle_report on the card within 1e-6 rad of the CPU's angles on a
    well-shaped mesh (a jittered torus grid; a float32 arccos near 0 or π
    amplifies a rounding difference) and with its histogram; register_pair
    with the two-stage converge on the card continues the capped pair and
    lands at the CPU's pose."""
    import contextlib

    from kss_icp_torch.measure_mesh import mesh_angle_report, triangle_angles

    rng = np.random.default_rng(19)
    m = 41
    u, v = np.meshgrid(np.linspace(0, 2 * np.pi, m), np.linspace(0, 2 * np.pi, m), indexing="ij")
    verts = np.stack([(1 + 0.4 * np.cos(v)) * np.cos(u), (1 + 0.4 * np.cos(v)) * np.sin(u), 0.4 * np.sin(v)], -1)
    verts = (verts.reshape(-1, 3) + rng.normal(0, 0.005, (m * m, 3))).astype(np.float32)
    ij = np.arange(m * m).reshape(m, m)[:-1, :-1].ravel()
    faces = np.concatenate([np.stack([ij, ij + 1, ij + m], -1), np.stack([ij + 1, ij + m + 1, ij + m], -1)])
    g, c = triangle_angles(verts, faces, device=cuda_device), triangle_angles(verts, faces, device="cpu")
    np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), atol=1e-6)
    got, want = mesh_angle_report(verts, faces, device=cuda_device), mesh_angle_report(verts, faces, device="cpu")
    near = int((np.abs(c.numpy().ravel()[:, None] - want["bin_edges"][None]).min(axis=1) < 1e-6).sum())
    assert np.abs(got["histogram"] - want["histogram"]).sum() <= 2 * near
    cfg = KSSICPConfig(max_resample_points=400, resample_pad=512, refine_max_iterations=2, refine_polish_iterations=200)
    tgt = random_cloud(rng, 1200).astype(np.float32)
    src = (tgt[::-1] @ np.asarray(euler_xyz_matrix(torch.tensor([0.3, -0.2, 0.4]))).T * 1.2 + 0.1
           + rng.normal(0, 0.005, tgt.shape)).astype(np.float32)
    stages = []
    res = kt.register_pair(src, tgt, cfg, device=cuda_device,
                           timer=lambda s: stages.append(s) or contextlib.nullcontext())
    ref = kt.register_pair(src, tgt, cfg, device="cpu")
    assert "two_stage" in stages and not bool(res.refine_hit_cap)
    np.testing.assert_allclose(res.transform.rotation.cpu().numpy(), ref.transform.rotation.numpy(), atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("world, backend", [(2, "gloo"), (1, "nccl")])
def test_mesh_on_the_card_matches_the_unsharded_kernels(cuda_device, tmp_path, world, backend):
    """The device mesh on cuda:0 (tests/torch_parallel_worker.py's "card"
    case): 2 gloo ranks sharing the card, and an NCCL group of world size 1
    through make_mesh. The sharded 8³ field is the unsharded field's bits
    (field_ave launched in the ranks); the sharded metric at 1 x 65536 x
    65536 (nn1 on each rank's rows) within rtol 1e-5 of the unsharded one."""
    import torch_parallel_worker as w

    out = w.spawn(world, tmp_path, ("card",), backend)
    assert out["card/field"].shape == (w.CARD_STEPS,) * 3
    assert np.array_equal(out["card/field"], out["card/field_unsharded"])
    np.testing.assert_allclose(float(out["card/metric"]), float(out["card/metric_unsharded"]), rtol=1e-5)
    assert out["card/launches"].tolist() == [1, 1]


# --- the lockstep ICP step's update kernel (csrc/icp_step.cu, ops/icp_cuda.py) ---

# (lanes, points a lane, target clouds, trimmed with scale): the cells' steps.
ICP_UPDATE_SHAPES = [(2048, 512, 64, False),  # the remesh batch's screen: 64 pairs x 32 lanes
                     (256, 2048, 64, False),  # its refine: 64 pairs x 4 lanes
                     (8192, 512, 16, True),   # the overlap screen: 16 pairs x 512 lanes, trimmed with scale
                     (1, 2000, 1, False)]     # one lane of 2000 points: a room's finisher
# A gate quantity this close to its threshold may fall on either side of it
# with the kernel's float64 sums and SVD.
GATE_MARGIN = 1e-5
BATCH_POSE_BAND = 1.75e-2  # chip_smoke.py: a batch's pose against another batch's (ROADMAP queue 3)


def _icp_update_case(device, lanes, n, groups, trimmed, seed=0):
    """A step's inputs: lanes against their pairs' padded clouds, sources that
    the state maps near their clouds (a tenth of the points outliers when
    trimmed), a tenth of the lanes inactive, mixed iterations."""
    from kss_icp_torch.ops.icp_cuda import ICPState, positions
    from kss_icp_torch.ops.nn import masked_quantile_threshold

    rng = np.random.default_rng(seed + lanes + n)
    t_n, valid = 2048, 2048 - 2048 // 40
    tgt = np.stack([random_cloud(rng, t_n) for _ in range(groups)]).astype(np.float32)
    tmask = np.zeros((groups, t_n), bool)
    tmask[:, :valid] = True
    ref = np.repeat(np.arange(groups), lanes // groups).astype(np.int32)
    base = tgt[ref[:, None], rng.integers(0, valid, size=(lanes, n))] + rng.normal(0, 0.005, (lanes, n, 3))
    if trimmed:
        base[:, : n // 10] += 0.3
    turn = euler_xyz_matrix(_t(rng.uniform(-0.2, 0.2, size=(lanes, 3)).astype(np.float32))).numpy()
    src = np.einsum("lij,lnj->lni", turn, base) + rng.uniform(-0.05, 0.05, size=(lanes, 1, 3))
    smask = np.ones((lanes, n), bool)
    smask[::3, n - n // 20:] = False
    active = rng.uniform(size=lanes) > 0.1
    active[0] = True
    state = ICPState(
        _t(euler_xyz_matrix(_t(rng.uniform(-0.05, 0.05, size=(lanes, 3)).astype(np.float32))).numpy(), device),
        _t(rng.uniform(-0.02, 0.02, size=(lanes, 3)).astype(np.float32), device),
        _t((rng.uniform(0.9, 1.1, size=lanes) if trimmed else np.ones(lanes)).astype(np.float32), device),
        _t(np.full(lanes, np.finfo(np.float32).max / 4, np.float32), device),
        _t(rng.choice([0, 1, 2, 5], size=lanes).astype(np.int32), device),
        _t(~active, device), _t(active, device))
    source = _t(src.astype(np.float32), device)
    smask_t, tgt_t, tmask_t, ref_t = _t(smask, device), _t(tgt, device), _t(tmask, device), _t(ref, device)
    cur = positions(source, *state[:3])
    d2, idx = nn1(cur, tgt_t, tmask_t, ref_t)
    thr = masked_quantile_threshold(d2, smask_t, 0.7) if trimmed else None
    return dict(cur=cur, d2=d2, idx=idx, source=source, source_mask=smask_t, target=tgt_t, lane_ref=ref_t,
                state=state, threshold=thr, estimate_scale=trimmed)


def _copy_state(state):
    return type(state)(*(x.clone() for x in state))


def _gates_near(case, params):
    """Each lane: whether a gate quantity of the plain step (translation,
    rotation, scale and MSE) lies within GATE_MARGIN of its threshold."""
    from kss_icp_torch.models.icp import kabsch

    keep = case["source_mask"] & (case["d2"] <= np.float32(params.max_correspondence_distance) ** 2)
    if case["threshold"] is not None:
        keep = keep & (case["d2"] <= case["threshold"][:, None])
    w = keep.float()
    corr = case["target"][case["lane_ref"].long()[:, None], case["idx"].long()]
    dr, dt, *ds = kabsch(case["cur"], corr, w, estimate_scale=case["estimate_scale"])
    diff = case["cur"] - corr
    mse = ((diff * diff).sum(-1) * w).sum(-1) / w.sum(-1).clamp_min(1.0)
    rel = (mse - case["state"].corr_mse).abs() / mse.clamp_min(torch.finfo(torch.float32).tiny)
    pairs = [((dt * dt).sum(-1), params.transformation_epsilon),
             (1.0 - (dr.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0, params.rotation_epsilon),
             (rel, params.euclidean_fitness_epsilon)]
    if ds:
        pairs.append(((ds[0] - 1.0) ** 2, params.transformation_epsilon))
    return torch.stack([(q - thr).abs() <= GATE_MARGIN for q, thr in pairs]).any(0)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes, n, groups, trimmed", ICP_UPDATE_SHAPES)
def test_icp_update_kernel_matches_plain_at_the_cells_shapes(cuda_device, lanes, n, groups, trimmed):
    """icp_update against icp_update_plain on one step: R and t within 2e-5,
    s and the MSE within rtol 2e-5, iterations equal, the gate flags equal
    but where a plain gate quantity lies within GATE_MARGIN of its threshold;
    inactive lanes' state and cur bit for bit; the next cur the plain
    positions of the kernel's own state, bit for bit; the stop flag the
    lanes' `active.any()`, the other parity's flag zeroed."""
    from kss_icp_torch.ops.icp_cuda import icp_update, icp_update_plain, positions

    case = _icp_update_case(cuda_device, lanes, n, groups, trimmed)
    params = ICPParams.from_config(KSSICPConfig())._replace(max_iterations=6)
    # Half the lanes' last MSE 5e-4 relative above this step's: their MSE gate holds.
    first, _, _ = icp_update_plain(**dict(case, cur=case["cur"].clone(), state=_copy_state(case["state"])),
                                   params=params)
    half = torch.arange(lanes, device=cuda_device) % 2 == 0
    case["state"] = case["state"]._replace(corr_mse=torch.where(half, first.corr_mse * (1 + 5e-4),
                                                                 case["state"].corr_mse))
    old = _copy_state(case["state"])
    want, want_cur, want_flag = icp_update_plain(**dict(case, cur=case["cur"].clone(), state=_copy_state(old)),
                                                 params=params)
    # The call's first step finds its own flag zeroed; the other parity's is the kernel's to zero.
    stop = torch.tensor([0, 7], dtype=torch.int32, device=cuda_device)
    before = icp_update.launches
    got, got_cur, flag = icp_update(**dict(case, cur=case["cur"].clone(), state=_copy_state(old)), params=params,
                                    stop=stop, step=0)
    torch.cuda.synchronize()
    assert icp_update.launches == before + 1
    frozen = ~old.active
    for name, x, y in zip(old._fields, got, old):
        assert torch.equal(x[frozen], y[frozen]), name
    assert torch.equal(got_cur[frozen], case["cur"][frozen])
    assert torch.equal(got_cur, positions(case["source"], got.rotation, got.translation, got.scale))
    assert float((got.rotation - want.rotation).abs().max()) <= 2e-5
    assert float((got.translation - want.translation).abs().max()) <= 2e-5
    torch.testing.assert_close(got.scale, want.scale, rtol=2e-5, atol=0.0)
    torch.testing.assert_close(got.corr_mse, want.corr_mse, rtol=2e-5, atol=0.0)
    assert torch.equal(got.iteration, want.iteration)
    far = ~_gates_near(dict(case, state=old), params)
    assert torch.equal(got.converged[far], want.converged[far]) and torch.equal(got.active[far], want.active[far])
    assert bool((got.converged & old.active & far).any()), "no lane converged: the MSE gate was not exercised"
    assert int(flag) == int(got.active.any()) == int(bool(want_flag)) and int(stop[1]) == 0
    # The next step takes the other parity and zeroes this one.
    d2, idx = nn1(got_cur, case["target"], torch.ones_like(case["target"][..., 0], dtype=torch.bool),
                  case["lane_ref"])
    again, _, flag = icp_update(**dict(case, cur=got_cur, d2=d2, idx=idx, state=got), params=params, stop=stop,
                                step=1)
    assert int(stop[0]) == 0 and int(flag) == int(stop[1]) == int(again.active.any())


def _icp_batch_case(device, lanes=64, groups=8, n=512):
    rng = np.random.default_rng(21)
    tgt = np.stack([random_cloud(rng, 2048) for _ in range(groups)]).astype(np.float32)
    ref = np.repeat(np.arange(groups), lanes // groups).astype(np.int32)
    base = tgt[ref[:, None], rng.integers(0, 2048, size=(lanes, n))] + rng.normal(0, 0.01, (lanes, n, 3))
    base[:, : n // 8] += 0.3
    turn = euler_xyz_matrix(_t(rng.uniform(-0.4, 0.4, size=(lanes, 3)).astype(np.float32))).numpy()
    src = (1.1 * np.einsum("lij,lnj->lni", turn, base) + 0.05).astype(np.float32)
    smask = np.ones((lanes, n), bool)
    smask[::5, n - 40:] = False
    return _t(src, device), _t(smask, device), _t(tgt, device), torch.ones((groups, 2048), dtype=torch.bool,
                                                                          device=device), _t(ref, device)


@pytest.mark.cuda
@pytest.mark.parametrize("trimmed", [False, True])
def test_icp_lane_alone_and_in_a_batch_of_64_give_the_same_bits(cuda_device, trimmed):
    """The card's ICP is lane-invariant: a lane solved alone against its cloud
    ends with the bits it ends with among 64 lanes of 8 clouds (its pose,
    scale, iterations and flags; the fitness, an eager sum over the lanes,
    within 1e-6)."""
    src, smask, tgt, tmask, ref = _icp_batch_case(cuda_device)
    params = ICPParams.from_config(KSSICPConfig())._replace(max_iterations=30)
    kw = dict(trim_fraction=0.7, estimate_scale=True) if trimmed else {}
    steps, fused = icp.lockstep_iterations, icp.fused_steps
    full = icp(src, smask, tgt, tmask, params, lane_ref=ref, **kw)
    assert icp.fused_steps - fused == icp.lockstep_iterations - steps > 0
    for k in (0, 17, 63):
        g = int(ref[k])
        one = icp(src[k:k + 1], smask[k:k + 1], tgt[g], tmask[g], params, **kw)
        for f in ("rotation", "translation", "scale", "iterations", "converged"):
            assert torch.equal(getattr(one, f)[0], getattr(full, f)[k]), (k, f)
        torch.testing.assert_close(one.fitness[0], full.fitness[k], rtol=1e-6, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("corpus", ["remesh", "partial"])
def test_register_many_fused_step_within_the_batch_band_of_the_eager_step(cuda_device, monkeypatch, corpus):
    """register_many at DEFAULT_CONFIG with the fused step against the same
    call through the eager step (icp_update_plain on the card): every pair's
    transform within BATCH_POSE_BAND and its RMSE within 0.006."""
    import importlib

    from kss_icp_torch.challenge import partial_corpus
    from kss_icp_torch.ops.icp_cuda import icp_update_plain

    icp_module = importlib.import_module("kss_icp_torch.models.icp")  # the package re-exports `icp` over it

    if corpus == "remesh":
        meta = json.loads((FIXTURES / "remesh_transfer.json").read_text())
        with np.load(FIXTURES / "remesh_transfer.npz") as z:
            pairs = [(z[r["name"] + "_src"], z[r["name"] + "_tgt"]) for r in meta]
    else:
        pairs = [(s, t) for _, s, t, _ in partial_corpus()[:8]]
    runs = []
    for eager in (False, True):
        if eager:
            monkeypatch.setattr(icp_module, "icp_update", icp_update_plain)
        res, metrics = kt.register_many(pairs, KSSICPConfig(), full_pad=8192, device=cuda_device)
        runs.append((res.transform, np.asarray(metrics["rmse"])))
    (fused, rmse_f), (eager, rmse_e) = runs
    pose = torch.stack([(getattr(fused, f) - getattr(eager, f)).abs().reshape(len(pairs), -1).amax(-1)
                        for f in ("scale", "rotation", "translation")]).amax(0)
    assert float(pose.max()) <= BATCH_POSE_BAND, pose.tolist()
    assert float(np.abs(rmse_f - rmse_e).max()) <= 0.006


@pytest.mark.cuda
def test_register_many_over_four_nccl_cards_within_the_batch_band_of_one_card(cuda_device):
    """256 remesh pairs (a call of the cell objects.full-overlap.b256-mesh4)
    through register_many over a "pairs" mesh of 4 NCCL ranks, one a card
    (regbench/entries/register_many_mesh.py), against the same 256 pairs as
    one batch on one card: every rank's rows are rank 0's bit for bit (their
    digests), and every pair's transform is within BATCH_POSE_BAND and its
    RMSE within 0.006 of the one-card batch's."""
    import gc

    from regbench import generate, harness
    from regbench.entries import register_many_mesh

    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices (the mesh puts a rank on each card)")
    spec = harness.load_cell("objects.full-overlap.b256-mesh4")
    pairs = generate.make_calls(spec["config"], spec["mix"], 2718281828)[0]
    call = register_many_mesh.prepare(spec["config"], spec["mix"], cuda_device)
    mesh = call(pairs, None)
    digests = dict(call.digests)
    del call
    gc.collect()
    assert sorted(digests) == [0, 1, 2, 3] and len(set(digests.values())) == 1
    res, metrics = kt.register_many([(p.src, p.tgt) for p in pairs], KSSICPConfig(),
                                    full_pad=spec["config"]["full_pad"], device=cuda_device)
    tr = res.transform
    scale, rot, trans = (x.cpu().numpy() for x in (tr.scale, tr.rotation, tr.translation))
    pose = [max(abs(a.scale - scale[b]), float(np.abs(a.rotation - rot[b]).max()),
                float(np.abs(a.translation - trans[b]).max())) for b, a in enumerate(mesh)]
    assert len(mesh) == len(pairs) == 256
    assert max(pose) <= BATCH_POSE_BAND, max(pose)
    assert max(abs(a.rmse - float(metrics["rmse"][b])) for b, a in enumerate(mesh)) <= 0.006


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["objects.full-overlap.b64", "room.scan-pair", "objects.partial-overlap.b64"])
def test_every_lockstep_step_of_each_cells_entry_is_fused(cuda_device, cell):
    """One call of each benchmark cell's entry (regbench/entries): every
    lockstep ICP step ran the update kernel."""
    import importlib

    from regbench import generate, harness

    spec = harness.load_cell(cell)
    calls = generate.make_calls(spec["config"], spec["mix"], 2718281828)
    call = importlib.import_module(f"regbench.entries.{spec['mix']['entry']}").prepare(spec["config"], spec["mix"],
                                                                                       cuda_device)
    steps, fused = icp.lockstep_iterations, icp.fused_steps
    call(calls[0], None)
    assert icp.fused_steps - fused == icp.lockstep_iterations - steps > 0
