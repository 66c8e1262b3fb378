"""The field_trim kernel's preparation and culling rule on the CPU
(kss_icp_torch/csrc/field_trim.cu, ops/coarse_cuda.py): the wrapper's
Morton order and launch plan, the rank k, the float64 sums of the plain
versions ("ave", "trim", "diff"), and a plain PyTorch model of the kernel's
scan (tiles of 16 rows, runs of 8 tiles, the nearest tile first, a box
skipped when its rounded-down bound is above every valid lane's min so far)
held to the brute-force min bit for bit, and with the "ave" epilogue to
`field_ave`'s plain version. The kernel itself runs in
tests/test_torch_card.py."""

from fractions import Fraction

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from helpers import random_cloud
from kss_icp_torch.core.transforms import euler_xyz_matrix
from kss_icp_torch.models.coarse import rotation_grid
from kss_icp_torch.ops import coarse_cuda as cc
from kss_icp_torch.ops.nn import _sorted_rank, nn_sqdistances, trimmed_masked_mean
from torch_helpers import cull_probe_cases

torch.set_num_threads(1)


def _t(*xs):
    return [torch.as_tensor(np.asarray(x)) for x in xs]


def _morton_np(pts):
    """An independent Morton code: the bits of each axis' 9-bit cell interleaved, x lowest."""
    lo, hi = pts.min(0), pts.max(0)
    scale = np.float32(512) / np.maximum(hi - lo, np.float32(1e-30))
    cell = np.clip(((pts - lo) * scale).astype(np.int64), 0, 511)
    code = np.zeros(len(pts), np.int64)
    for b in range(9):
        for a in range(3):
            code |= ((cell[:, a] >> b) & 1) << (3 * b + a)
    return code


# --- the preparation ---

@pytest.mark.parametrize("p_n, t_n", [(100, 300), (45, 45), (2048, 2048)])
def test_field_order_puts_each_clouds_valid_rows_first_in_morton_order(p_n, t_n):
    rng = np.random.default_rng(p_n + t_n)
    src, tgt = random_cloud(rng, p_n).astype(np.float32), random_cloud(rng, t_n).astype(np.float32)
    smask, tmask = rng.uniform(size=p_n) < 0.7, rng.uniform(size=t_n) < 0.6
    order = cc.field_order(*_t(src, smask, tgt, tmask)).numpy()
    code = _morton_np(np.concatenate([src, tgt]))
    key = code + (~np.concatenate([smask, tmask])).astype(np.int64) * 2**27 + (np.arange(p_n + t_n) >= p_n) * 2**28
    np.testing.assert_array_equal(cc.field_keys(*_t(src, smask, tgt, tmask)).numpy(), key)
    np.testing.assert_array_equal(order, np.argsort(key, kind="stable"))
    assert sorted(order[:p_n]) == list(range(p_n))
    ns, m = smask.sum(), tmask.sum()
    assert smask[order[:ns]].all() and not smask[order[ns:p_n]].any()
    assert tmask[order[p_n:p_n + m] - p_n].all() and not tmask[order[p_n + m:] - p_n].any()


def test_field_order_keeps_duplicates_in_index_order():
    pts = np.repeat(np.array([[0.5, 0.1, 0.2], [-0.3, 0.4, 0.0]], np.float32), 5, axis=0)
    order = cc.field_order(*_t(pts, np.ones(10, bool), pts, np.ones(10, bool))).numpy()
    for lo in (0, 10):
        run = order[lo:lo + 10]
        for a, b in zip(run, run[1:]):
            if np.array_equal(pts[a % 10], pts[b % 10]):
                assert a < b


def test_field_cull_plan_stages_the_whole_target_where_it_fits():
    assert cc.field_cull_plan(2048, 2048, "trim") == 2048
    assert cc.field_cull_plan(2048, 4173, "max") == 4224
    assert cc.field_cull_plan(200, 3000, "trim") == 3072
    assert cc.field_cull_plan(8191, 4173, "trim") == 4224
    cap = cc.field_cull_plan(32768, 100_000, "max")  # chunks: the most rows that fit beside the mins
    assert cap % cc.FIELD_RUN == 0 and 0 < cap < 100_000
    assert cc.cull_smem_bytes(cap, 32768) <= cc.FIELD_SMEM < cc.cull_smem_bytes(cap + cc.FIELD_RUN, 32768)
    assert cc.cull_smem_bytes(2048, 2048) == 2048 * 16 + 128 * 32 + 16 * 32 + 2048 * 4
    # past FIELD_MAX_POINTS the mins leave shared memory and the rows take it all
    assert cc.smem_points(cc.FIELD_MAX_POINTS) == cc.FIELD_MAX_POINTS and cc.smem_points(40000) == 0
    assert cc.field_cull_plan(40000, 100_000, "max") == cc.FIELD_SMEM // cc.cull_smem_bytes(cc.FIELD_RUN, 0) * 128
    assert 2 * cc.cull_smem_bytes(2048, 2048) <= cc.FIELD_SMEM  # two blocks an SM at the main shapes


@pytest.mark.parametrize("stat", ["trim", "distances"])
def test_field_cull_refuses_wide_rows_before_any_launch(monkeypatch, stat):
    """P >= 8192 at "trim" (the rank's rounding guard) raises in the
    plan, before the library is built or the inputs are sorted; the other
    stats take any P (past FIELD_MAX_POINTS through a device scratch), so
    their call reaches the preparation."""
    from kss_icp_torch import _build

    def no_library(*_):
        raise AssertionError("the library was asked for")

    monkeypatch.setattr(_build, "library", no_library)
    monkeypatch.setattr(cc, "field_order", no_library)
    p_n = 8192 if stat == "trim" else cc.FIELD_MAX_POINTS + 1
    src = torch.zeros((p_n, 3))
    args = (src, torch.ones(p_n, dtype=torch.bool), src[:5], torch.ones(5, dtype=torch.bool), torch.eye(3)[None])
    with pytest.raises(ValueError if stat == "trim" else AssertionError, match="8192" if stat == "trim" else "asked"):
        cc._field_cull("field_trim", cc.field_trim, stat, *args)
    cc.field_cull_plan(8191, 100, "trim")
    with pytest.raises(ValueError, match="8192"):
        cc.field_trim_plain(src, torch.ones(p_n, dtype=torch.bool), src[:5], torch.ones(5, dtype=torch.bool),
                            torch.eye(3)[None])


def trim_rank(n: int, q: float) -> int:
    """csrc/field_trim.cu::trim_rank in numpy float32."""
    k = int(np.ceil(np.float32(np.float32(q) * np.float32(n)) - np.float32(1e-3)))
    return min(max(k, 1), max(n, 1))


@pytest.mark.parametrize("q", [0.7, 0.5, 0.6, 1.0, 0.3, 0.95, 0.123456])
def test_kernel_rank_is_sorted_ranks_k(q):
    n = torch.cat([torch.arange(0, 64), torch.arange(64, 8192, 11), torch.arange(8150, 8192)]).to(torch.int32)
    mask = torch.arange(8191)[None, :] < n[:, None]
    _, k = _sorted_rank(torch.zeros(mask.shape), mask, q, "x")
    assert [trim_rank(int(i), q) for i in n] == k.tolist()


# --- the float64 sums ---

def test_float64_trimmed_mean_gives_todays_cpu_bits():
    """PyTorch's CPU float32 cumsum accumulates in float64: the float64
    path of trimmed_masked_mean (the plain fields') gives the bits of the
    default (the ICP's) on the CPU."""
    rng = np.random.default_rng(3)
    values = torch.as_tensor(rng.gamma(2.0, 0.02, size=(5120, 512)).astype(np.float32))
    mask = torch.as_tensor(rng.uniform(size=(5120, 512)) < 0.8)
    mask[::7, 300:] = False
    for q in (0.7, 0.5):
        assert torch.equal(trimmed_masked_mean(values, mask, q, dtype=torch.float64),
                           trimmed_masked_mean(values, mask, q))


def _kernel_trim(values: np.ndarray, q: float, threads: int = 512) -> np.float32:
    """The kernel's trim epilogue in numpy: the k-th smallest value tau, the
    float64 sum of the values below it taken thread by thread (strided),
    then across threads, plus (k - their count) * tau, over float32(k)."""
    k = trim_rank(len(values), q)
    tau = np.sort(values)[k - 1]
    below = values < tau
    part = [sum(float(v) for v in values[t::threads][below[t::threads]]) for t in range(threads)]
    total = sum(part) + (k - int(below.sum())) * float(tau)
    return np.float32(np.float32(total) / np.float32(k))


@pytest.mark.parametrize("ties", [False, True])
def test_kernel_trim_sum_matches_the_sorted_float64_cumsum(ties):
    """The kernel's order of the float64 sum, threshold and ties gives the
    plain version's float32 bits on every row tried."""
    rng = np.random.default_rng(7 + ties)
    rows = rng.gamma(2.0, 0.03, size=(400, 2000)).astype(np.float32)
    if ties:
        rows = (np.round(rows * 200) / 200).astype(np.float32)
    n_valid = rng.integers(1, 2001, size=400)
    for row, n in zip(rows, n_valid):
        want = trimmed_masked_mean(*_t(row[None, :n], np.ones((1, n), bool)), 0.7, dtype=torch.float64)
        assert _kernel_trim(row[:n], 0.7) == want.item()


def test_diff_mean_sums_in_float64():
    from kss_icp_torch.ops.nn import sq_error

    rng = np.random.default_rng(5)
    d2 = torch.as_tensor(rng.gamma(2.0, 0.001, size=(64, 1000)).astype(np.float32))
    mask = torch.as_tensor(rng.uniform(size=1000) < 0.7)
    d = torch.sqrt(d2).double() * mask
    want = (torch.sqrt(d2).masked_fill(~mask, -1e30).amax(-1)
            - d.sum(-1).float() / mask.sum().float())
    assert torch.equal(sq_error(d2, mask, "diff"), want)


def test_float64_diff_mean_moves_the_diff_field_by_at_most_two_ulps():
    """The "diff" field's mean in float64 (`sq_error`) does not keep the
    float32 sum's CPU bits, unlike the trimmed mean's cumsum: against the
    float32 masked_mean it took before, the field moves on some rows (three
    in ten here), each time by at most two float32 ulps of its value."""
    from kss_icp_torch.ops.nn import BIG, masked_mean, sq_error

    rng = np.random.default_rng(6)
    d2 = torch.as_tensor(rng.gamma(2.0, 0.001, size=(2048, 2048)).astype(np.float32))
    mask = torch.as_tensor(rng.uniform(size=(2048, 2048)) < 0.7)
    d = torch.sqrt(d2)
    mean = masked_mean(d, mask)
    old = torch.where(mask, d, torch.full_like(d, -BIG)).amax(-1) - mean
    new = sq_error(d2, mask, "diff")
    assert bool((old != new).any())
    assert bool(((old - new).abs() <= 2 * torch.as_tensor(np.spacing(np.abs(new.numpy())))).all())


def test_float64_ave_mean_moves_the_ave_field_by_at_most_two_ulps():
    """The "ave" field's mean in float64 (`masked_mean_nn_distance`, the
    culling kernel's "ave" statistic) against the float32 masked_mean it
    took before, the JAX package's rule: the field moves on some rows, each
    time by at most two float32 ulps of its value."""
    from kss_icp_torch.ops.nn import masked_mean

    rng = np.random.default_rng(8)
    d = torch.sqrt(torch.as_tensor(rng.gamma(2.0, 0.001, size=(2048, 2048)).astype(np.float32)))
    mask = torch.as_tensor(rng.uniform(size=(2048, 2048)) < 0.7)
    old, new = masked_mean(d, mask), masked_mean(d, mask, torch.float64)
    assert bool((old != new).any())
    assert bool(((old - new).abs() <= 2 * torch.as_tensor(np.spacing(np.abs(new.numpy())))).all())


def _kernel_ave(mins: np.ndarray, threads: int = 512) -> np.float32:
    """The kernel's "ave" epilogue in numpy: float64 sums of sqrt(max(v, 0))
    thread by thread (strided), then across threads, rounded once to
    float32 and divided by float32(max(n, 1)); 0 with no valid point."""
    n = len(mins)
    if n == 0:
        return np.float32(0.0)
    d = np.sqrt(np.maximum(mins, np.float32(0)))
    total = sum(sum(float(v) for v in d[t::threads]) for t in range(threads))
    return np.float32(np.float32(total) / np.float32(n))


# --- the culling rule ---

def _round_down32(x: Fraction) -> np.float32:
    """The largest float32 at most x."""
    f = np.float32(float(x))
    while Fraction(float(f)) > x:
        f = np.nextafter(f, np.float32(-np.inf))
    while Fraction(float(np.nextafter(f, np.float32(np.inf)))) <= x:
        f = np.nextafter(f, np.float32(np.inf))
    return f


def _box_bound_rd(lo, hi, q) -> np.float32:
    """csrc/field_trim.cu::box_bound exactly: every operation rounded down (from exact fractions)."""
    sq = []
    for a in range(3):
        e = max(_round_down32(Fraction(float(lo[a])) - Fraction(float(q[a]))),
                _round_down32(Fraction(float(q[a])) - Fraction(float(hi[a]))), np.float32(0))
        sq.append(_round_down32(Fraction(float(e)) ** 2))
    s = _round_down32(Fraction(float(sq[0])) + Fraction(float(sq[1])))
    return _round_down32(Fraction(float(s)) + Fraction(float(sq[2])))


def _sq_dist_rn(t, q) -> np.float32:
    d = (t - q).astype(np.float32)
    s = d * d
    return np.float32(np.float32(s[0] + s[1]) + s[2])


@pytest.mark.parametrize("case", list(cull_probe_cases()))
def test_round_down_box_bound_never_exceeds_a_rows_distance(case):
    """The design note's claim, at the bit level: for every tile of the
    probe's sorted target and every rotated probe point, the kernel's
    rounded-down bound is at most every row's round-to-nearest distance."""
    src, smask, tgt, tmask, rots = cull_probe_cases()[case]
    order = cc.field_order(*_t(src, smask, tgt, tmask)).numpy()
    rows = tgt[order[len(src):len(src) + tmask.sum()] - len(src)]
    pts = np.asarray(torch.einsum("cij,pj->cpi", *_t(rots[:3], src)).reshape(-1, 3), np.float32)[::9]
    rotated = cc.rotate_sources(*_t(rots[:2], src)).reshape(-1, 3).numpy()[::5]
    for qp in np.concatenate([pts, rotated]):
        for t0 in range(0, len(rows), cc.FIELD_TILE):
            tile = rows[t0:t0 + cc.FIELD_TILE]
            bound = _box_bound_rd(tile.min(0), tile.max(0), qp)
            assert all(bound <= _sq_dist_rn(t, qp) for t in tile)


def _bound_model(lo, hi, q):
    """A conservative float32 bound per lane, from float64: below the
    kernel's rounded-down bound (each of its 6 roundings is within 2^-24)."""
    e = torch.clamp(torch.maximum(lo.double() - q.double(), q.double() - hi.double()), min=0.0)
    b = (e * e).sum(-1) * (1.0 - 2.0 ** -19) - 1e-38
    f = b.float()
    return torch.where(f.double() > b, torch.nextafter(f, torch.tensor(-np.inf)), f)


def cull_model(source, source_mask, target, target_mask, rotations, cap=None):
    """A plain PyTorch model of the kernel's scan: ((C, P) mins, 0 at masked
    points, in the caller's order; the (point, row) pairs scanned)."""
    p_n, t_n = source.shape[0], target.shape[0]
    cap = cap or cc.field_cull_plan(p_n, t_n, "max")
    order = cc.field_order(source, source_mask, target, target_mask)
    ns, m = int(source_mask.sum()), int(target_mask.sum())
    biased = m == 0
    rows_all = target if biased else target[order[p_n:p_n + m] - p_n]
    src = source[order[:ns]]
    out = torch.zeros((rotations.shape[0], p_n))
    pairs = 0
    for c, rot in enumerate(rotations):
        q = cc.rotate_sources(rot[None], src)[0]
        best = torch.full((ns,), np.inf)
        for base in range(0, len(rows_all), cap):
            chunk = rows_all[base:base + cap]
            mc = len(chunk)
            tiles = -(-mc // cc.FIELD_TILE)
            pad = torch.arange(tiles * cc.FIELD_TILE)
            pad = torch.where(pad < mc, pad, pad // cc.FIELD_TILE * cc.FIELD_TILE)
            rows = chunk[pad].view(tiles, cc.FIELD_TILE, 3)
            tlo, thi = rows.amin(1), rows.amax(1)
            runs = -(-tiles // 8)
            rlo = torch.stack([tlo[r * 8:r * 8 + 8].amin(0) for r in range(runs)])
            rhi = torch.stack([thi[r * 8:r * 8 + 8].amax(0) for r in range(runs)])
            for g in range(0, ns, 32):
                qw, bw = q[g:g + 32], best[g:g + 32]

                def scan(t):
                    d = ((rows[t][None] - qw[:, None]) ** 2)
                    d = (d[..., 0] + d[..., 1]) + d[..., 2]
                    if biased:
                        d = d + 1e30
                    return torch.minimum(bw, d.amin(1))

                def needed(lo, hi):
                    return bool((_bound_model(lo[None], hi[None], qw) <= bw).any())

                if biased:
                    for t in range(tiles):
                        bw = scan(t)
                    pairs += mc * len(qw)
                else:
                    cen = qw.mean(0)
                    first = int(torch.argmin(_bound_model(tlo, thi, cen[None])))
                    order_t = [first] + [t for r in [first // 8 + (s + 1) // 2 if s & 1 else first // 8 - s // 2
                                                     for s in range(2 * runs)] if 0 <= r < runs
                                         and needed(rlo[r], rhi[r]) for t in range(r * 8, min(tiles, r * 8 + 8))
                                         if t != first]
                    for t in order_t:
                        if needed(tlo[t], thi[t]):
                            bw = scan(t)
                            pairs += min(cc.FIELD_TILE, mc - t * cc.FIELD_TILE) * len(qw)
                best[g:g + 32] = bw
        out[c, order[:ns]] = best
    return out, pairs


@pytest.mark.parametrize("case", list(cull_probe_cases()))
def test_cull_model_equals_the_brute_force_min_bit_for_bit(case):
    args = _t(*cull_probe_cases()[case])
    got, _ = cull_model(*args)
    src, smask, tgt, tmask, rots = args
    assert torch.equal(got, nn_sqdistances(cc.rotate_sources(rots, src), smask, tgt, tmask))


def _ave_cases():
    """The probe cases, and a fully masked source and a fully masked target
    (the kernel's biased path) of the last one."""
    cases = dict(cull_probe_cases())
    src, smask, tgt, tmask, rots = cases["P not a multiple of 32"]
    cases["source fully masked"] = (src, np.zeros_like(smask), tgt, tmask, rots)
    cases["target fully masked"] = (src, smask, tgt, np.zeros_like(tmask), rots)
    return cases


@pytest.mark.parametrize("case", list(_ave_cases()))
def test_ave_epilogue_on_the_cull_model_gives_the_plain_fields_bits(case):
    """The "ave" statistic: the culled mins of the model, reduced as the
    kernel reduces them (its valid points in Morton order, the float64 sum
    in the kernel's thread order), equal `field_ave`'s plain version bit for
    bit; a fully masked source scores 0, and a fully masked target takes the
    biased path over every row (each min + 1e30), as the plain version."""
    args = _t(*_ave_cases()[case])
    mins, _ = cull_model(*args)
    src, smask, tgt, tmask, rots = args
    order = cc.field_order(src, smask, tgt, tmask)[:int(smask.sum())]
    got = np.array([_kernel_ave(row[order].numpy()) for row in mins])
    want = cc.field_ave_plain(*args).numpy()
    np.testing.assert_array_equal(got, want)
    if not smask.any():
        assert not want.any()
    if not tmask.any():
        assert (want > 1e14).all()


@pytest.mark.parametrize("t_valid", [300, 0])
def test_cull_model_in_chunks_culls_and_keeps_the_bits(t_valid):
    """A target walked in chunks of 128 rows, each with its own boxes; on
    wavy-surface clouds the rule skips most pairs; the biased path (no valid
    target row) scans them all. (Sparse, widely rotated clouds: the share
    scanned on the main path's shapes is the smoke run's to measure.)"""
    rng = np.random.default_rng(9)
    src, tgt = random_cloud(rng, 200).astype(np.float32), random_cloud(rng, 400).astype(np.float32)
    smask, tmask = rng.uniform(size=200) < 0.8, np.arange(400) < t_valid
    rots = euler_xyz_matrix(rotation_grid(2, 6.3, "cpu"))
    args = _t(src, smask, tgt, tmask) + [rots]
    want = nn_sqdistances(cc.rotate_sources(rots, args[0]), *args[1:4])
    total = rots.shape[0] * smask.sum() * (t_valid or 400)
    for cap in (128, None):
        got, pairs = cull_model(*args, cap=cap)
        assert torch.equal(got, want)
        if t_valid:
            assert pairs < total
        else:
            assert pairs == total


def test_field_prep_runs_no_more_ops_than_the_per_point_path():
    """The fused call's preparation (field_order and the output) takes no
    more PyTorch operations than the per-point kernel's wrapper ran around
    it (the rotation, the weights, the (C, P) buffer and the trimmed mean's
    sort, cumulative sum and gather)."""

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    rng = np.random.default_rng(2)
    src, smask, tgt, tmask = _t(random_cloud(rng, 256).astype(np.float32), rng.uniform(size=256) < 0.7,
                                random_cloud(rng, 256).astype(np.float32), rng.uniform(size=256) < 0.7)
    rots = euler_xyz_matrix(rotation_grid(3, 6.3, "cpu"))
    cc.field_order(src, smask, tgt, tmask)  # the cached constants
    with Count() as new:
        cc.field_order(src, smask, tgt, tmask)
        torch.empty((rots.shape[0],))
    with Count() as old:
        cc.rotate_sources(rots, src)
        smask.to(torch.float32).contiguous()
        dist = torch.empty((rots.shape[0], 256))
        trimmed_masked_mean(dist, smask.expand(dist.shape), 0.7)
    assert new.n <= old.n, (new.n, old.n)
