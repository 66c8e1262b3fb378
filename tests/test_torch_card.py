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
from torch_helpers import cuda_device  # noqa: F401  (fixture)

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
# Registers (1 to 16 points a thread), then shared memory (12801) and global memory.
@pytest.mark.parametrize("p", [1, 757, 3072, 8192, 12801, 20000, 65536])
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
@pytest.mark.parametrize("p", [700, 5000, 9000])
def test_fps_kernel_ties_short_clouds_and_steps(cuda_device, p):
    """Duplicate points (tied scores), more samples than valid points, an
    invalid first point, and steps < S."""
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


@pytest.mark.cuda
def test_fps_kernel_refuses_clouds_past_65536(cuda_device):
    pts = torch.zeros((1, 65537, 3), device=cuda_device)
    with pytest.raises(ValueError, match="65536"):
        fps(pts, torch.ones((1, 65537), dtype=torch.bool, device=cuda_device), 8)


@pytest.mark.cuda
def test_field_kernel_matches_plain_and_jax(cuda_device):
    args = _field_case(cuda_device)
    before = field_ave.launches
    got = field_ave(*args)
    assert field_ave.launches == before + 1
    torch.testing.assert_close(got, field_ave_plain(*args), rtol=2e-5, atol=0.0)
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
    """Masked rows skipped, exactly: the kernel within rtol 2e-5 of the plain
    version, the same bits on a second run and, for suffix masks, the bits of
    the field of the valid prefix alone."""
    kernel, plain, kw = _field_kernel(name, precision)
    steps, p, t, s_valid, t_valid = FIELD_CARD_CASES[case]
    args = _field_card_case(cuda_device, *FIELD_CARD_CASES[case])
    before = kernel.launches
    got = kernel(*args, **kw)
    assert kernel.launches == before + 1
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
@pytest.mark.parametrize("case", ["scattered", "target fully masked", "few rotations, small P, long T"])
def test_field_kernels_give_the_same_bits_under_every_plan(cuda_device, case):
    """Every group-slots count the C entry points take: the sums keep their
    bits (the min is exact, the sum's tree fixed), and each launch is
    counted."""
    from kss_icp_torch.ops.coarse_cuda import FIELD_SLOTS, dot_operands, field_ave_sums, field_dot_sums

    src, smask, tgt, tmask, rots = _field_card_case(cuda_device, *FIELD_CARD_CASES[case])
    rotated, q2, weight, ra = dot_operands(src, smask, tgt, tmask, rots)
    runs = {"ave": [], "dot": [], "dot bf16": []}
    before = field_ave.launches, field_dot.launches
    for slots in FIELD_SLOTS:
        runs["ave"].append(field_ave_sums(rotated, weight, tgt, tmask, slots))
        runs["dot"].append(field_dot_sums(rotated, q2, weight, ra, tmask, False, slots))
        runs["dot bf16"].append(field_dot_sums(rotated, q2, weight, ra, tmask, True, slots))
    plans = len(FIELD_SLOTS)
    assert (field_ave.launches, field_dot.launches) == (before[0] + plans, before[1] + 2 * plans)
    for key, sums in runs.items():
        assert all(torch.equal(sums[0], s) for s in sums[1:]), key
    torch.testing.assert_close(runs["ave"][0] / weight.sum(), field_ave_plain(src, smask, tgt, tmask, rots),
                               rtol=2e-5, atol=0.0)


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
def test_unbuilt_or_foreign_inputs_raise(cuda_device):
    q = torch.zeros((1, 4, 3), device=cuda_device)
    with pytest.raises(TypeError):
        nn1(q.double(), q.double(), torch.ones((1, 4), dtype=torch.bool, device=cuda_device))
    with pytest.raises(ValueError):
        nn1(q, q.cpu(), torch.ones((1, 4), dtype=torch.bool))
    with pytest.raises(ValueError):
        nn1(q[:, ::2], q, torch.ones((1, 4), dtype=torch.bool, device=cuda_device))
