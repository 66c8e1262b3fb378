"""A plain PyTorch model of the `nn1` kernel's scan (csrc/nn.cu), held bit
for bit to the plain version (ops/nn_cuda.py::nn1_plain) on the CPU.

The kernel runs only on the card, so its algorithm is modelled here, step
for step: each cluster rank's slice staged 1024 rows at a time, a masked
row and a tile's padding to whole 32-row chunks as +inf; a running min a
query with no index, compared with a strict '<' at each chunk's end to
record the chunk where it fell; at the end of the tile where the min
fell, the winning chunk's staged rows rescanned for the first whose
distance equals the min; the ranks' partials merged in rank order with a
strict '<'; the output mapping. The
cases put ties across chunk, tile and slice borders, masked rows at a
chunk's first and last row, fully masked lanes and duplicate rows."""

import numpy as np
import pytest
import torch

from helpers import random_cloud
from kss_icp_torch.ops.nn_cuda import NN1Plan, nn1_plain, nn1_plan

TILE = 1024  # rows staged at a time (csrc/nn.cu kTile)
CHUNK = 32  # rows between two checks of the running min (kChunk)
BIG = 1e30
INF = float("inf")


def _sq(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """((dx*dx + dy*dy) + dz*dz) of queries (Q, 3) against rows (Q, n, 3)
    or (n, 3), in float32, each operation rounded as the kernel rounds it."""
    rows = rows.expand(q.shape[0], *rows.shape[-2:])
    dx, dy, dz = (q[:, None, k] - rows[..., k] for k in range(3))
    return (dx * dx + dy * dy) + dz * dz


def _rank_scan(q, ref, mask, r_lo, r_hi):
    """One cluster rank's (min, first index) of each query over rows [r_lo, r_hi)."""
    q_n = q.shape[0]
    run = torch.full((q_n,), INF)
    best = torch.full((q_n,), INF)
    win = torch.full((q_n,), -1, dtype=torch.int64)
    first = torch.zeros((q_n,), dtype=torch.int64)
    for base in range(r_lo, r_hi, TILE):
        n = min(TILE, r_hi - base)
        tile = torch.full((-(-n // CHUNK) * CHUNK, 3), INF)  # masked rows and the padding: +inf
        keep = mask[base:base + n]
        tile[:n][keep] = ref[base:base + n][keep]
        d = _sq(q, tile)
        for c in range(0, tile.shape[0], CHUNK):
            run = torch.fmin(run, d[:, c:c + CHUNK].amin(dim=1))  # fminf: a NaN never wins
            fell = run < best  # strict: the earliest chunk that holds the min wins
            best = torch.where(fell, run, best)
            win = torch.where(fell, torch.full_like(win, base + c), win)
        # Where the min fell in this tile: the first row of its chunk, from the staged tile.
        here = win >= base
        rows = (win - base).clamp_min(0)[:, None] + torch.arange(CHUNK)
        match = _sq(q, tile[rows]) == best[:, None]
        first = torch.where(here, win + match.to(torch.int64).argmax(dim=1), first)
    return best, first


def scan_model(query, ref, mask, lane_ref, plan: NN1Plan):
    """(d2 (L, Q) float32, idx (L, Q) int32) as csrc/nn.cu computes them
    at `plan`; a lane_ref outside [0, G) gives NaN / -1."""
    lanes, q_n = query.shape[:2]
    groups, r_n = ref.shape[:2]
    d2 = torch.empty((lanes, q_n), dtype=torch.float32)
    idx = torch.empty((lanes, q_n), dtype=torch.int32)
    for lane in range(lanes):
        g = int(lane_ref[lane])
        if not 0 <= g < groups:
            d2[lane], idx[lane] = float("nan"), -1
            continue
        b = torch.full((q_n,), INF)
        bi = torch.zeros((q_n,), dtype=torch.int64)
        for rank in range(plan.cluster):  # rank order = row order
            r_lo = min(r_n, rank * plan.slice)
            part, part_i = _rank_scan(query[lane], ref[g], mask[g], r_lo, min(r_n, r_lo + plan.slice))
            take = part < b
            b, bi = torch.where(take, part, b), torch.where(take, part_i, bi)
        d2[lane] = torch.where(b >= 0.5 * BIG, torch.full_like(b, BIG), b.clamp_min(0.0))
        idx[lane] = bi.clamp(0, r_n - 1).to(torch.int32)
    return d2, idx


def _same(got, want):
    assert torch.equal(got[1], want[1]), f"indices differ at {int((got[1] != want[1]).sum())} queries"
    assert torch.equal(got[0], want[0])


def _lattice(rng, shape, step=0.125):
    """float32 points on a coarse lattice: many exact distance ties between different rows."""
    return (rng.integers(-8, 9, size=shape) * step).astype(np.float32)


def _border_case():
    """Two clouds of 3000 rows: exact ties across chunk (31/32), tile
    (1023/1024) and far rows, a chunk of 32 duplicates, masked rows at a
    chunk's first and last row with a valid twin later; cloud 1 fully
    masked. Queries: the tied rows' points, then random ones."""
    r_n = 3000
    rng = np.random.default_rng(23)
    r = random_cloud(rng, 2 * r_n).astype(np.float32).reshape(2, r_n, 3)
    for a, b in ((31, 32), (63, 95), (1023, 1024), (5, 1500), (2047, 2048), (2990, 2999), (374, 375), (749, 2250)):
        r[0, b] = r[0, a]
    r[0, 640:672] = r[0, 640]
    m = np.ones((2, r_n), bool)
    m[1] = False
    for row in (64, 127, 1055, 2016, 0, 2999 - 7):
        m[0, row] = False
        r[0, row + 7] = r[0, row]
    picks = [31, 32, 63, 95, 1023, 1024, 5, 1500, 2047, 2990, 640, 650, 64, 127, 1055, 2016, 375, 2250, 0, 2992]
    q = np.concatenate([r[0, picks], random_cloud(rng, 100).astype(np.float32)])
    q = np.broadcast_to(q, (2, len(q), 3)).copy()
    return tuple(torch.as_tensor(x) for x in (q, r, m, np.array([0, 1], np.int32)))


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("queries", [2, 4])
def test_model_keeps_the_first_index_across_chunk_tile_and_slice_borders(cluster, queries):
    q, r, m, lane_ref = _border_case()
    plan = NN1Plan(cluster, -(-r.shape[1] // cluster), queries)
    got = scan_model(q, r, m, lane_ref, plan)
    _same(got, nn1_plain(q, r, m, lane_ref))
    assert got[1][0, :12].tolist() == [31, 31, 63, 63, 1023, 1023, 5, 5, 2047, 2990, 640, 640]
    assert got[1][0, 12:20].tolist() == [71, 134, 1062, 2023, 374, 749, 7, 2999]
    assert bool((got[0][1] == BIG).all()) and bool((got[1][1] == 0).all())


# (L, Q, R): main-path shapes whose plan sets the slices; the model runs a
# few of the lanes and queries against every reference row.
PLAN_SHAPES = [(32, 512, 2048), (4, 2048, 2048), (1, 3072, 8192), (512, 512, 2048), (8192, 512, 2048),
               (25, 8192, 8192), (1, 65536, 65536), (7, 8192, 8192), (1, 200704, 200704), (6, 700, 1500)]


@pytest.mark.parametrize("lanes, q_n, r_n", PLAN_SHAPES, ids=[f"{a}x{b}x{c}" for a, b, c in PLAN_SHAPES])
def test_model_matches_plain_at_the_plans_slices(lanes, q_n, r_n):
    """Lattice clouds (many exact ties between different rows), a padded
    tail and scattered masked rows, at the plan nn1_plan picks."""
    plan = nn1_plan(lanes, q_n, r_n)
    rng = np.random.default_rng(r_n + lanes)
    groups, q_used = 2, 48
    q = torch.as_tensor(_lattice(rng, (groups, q_used, 3)))
    r = torch.as_tensor(_lattice(rng, (groups, r_n, 3)))
    m = torch.as_tensor(rng.uniform(size=(groups, r_n)) < 0.9) & (torch.arange(r_n) < r_n - r_n // 40)
    lane_ref = torch.arange(groups, dtype=torch.int32)
    _same(scan_model(q, r, m, lane_ref, plan), nn1_plain(q, r, m, lane_ref))


def test_model_fully_masked_duplicate_and_foreign_lanes():
    """A cloud of one point repeated (every row ties), one fully masked, and
    a lane_ref outside [0, G): the first row, 1e30 and index 0, NaN / -1."""
    rng = np.random.default_rng(3)
    r = np.broadcast_to(random_cloud(rng, 1).astype(np.float32), (3, 2100, 3)).copy()
    r[2] = random_cloud(rng, 2100)
    m = np.ones((3, 2100), bool)
    m[1] = False
    m[0, :40] = False
    q = torch.as_tensor(random_cloud(rng, 3 * 50).astype(np.float32).reshape(3, 50, 3))
    r, m = torch.as_tensor(r), torch.as_tensor(m)
    for plan in (NN1Plan(1, 2100, 4), NN1Plan(4, 525, 2)):
        d2, idx = scan_model(q, r, m, torch.tensor([0, 1, 2], dtype=torch.int32), plan)
        _same((d2, idx), nn1_plain(q, r, m, torch.tensor([0, 1, 2], dtype=torch.int32)))
        assert bool((idx[0] == 40).all()) and bool((d2[1] == BIG).all()) and bool((idx[1] == 0).all())
        d2, idx = scan_model(q, r, m, torch.tensor([0, -1, 3], dtype=torch.int32), plan)
        assert bool(torch.isnan(d2[1:]).all()) and bool((idx[1:] == -1).all())


def test_plus_inf_staging_gives_the_plain_bias_answer():
    """Masked rows at +inf in place of a 1e30 bias: a valid row's d + 0
    below 1e30 always beats a masked row's d + 1e30, and over a fully
    masked reference every d + 1e30 under 3.8e22 rounds to 1e30, so the
    plain argmin is index 0, as an untouched index is."""
    big = torch.tensor(BIG, dtype=torch.float32)
    d = torch.tensor([0.0, 1e-30, 3.0, 1e10, 1e20, 3.7e22], dtype=torch.float32)
    assert bool((d + big == big).all())
    assert float(torch.tensor(4e22, dtype=torch.float32) + big) > BIG
    q = torch.zeros((1, 3, 3))
    r = torch.as_tensor(random_cloud(np.random.default_rng(1), 300).astype(np.float32))[None] * 1e5
    m = torch.zeros((1, 300), dtype=torch.bool)
    want = nn1_plain(q, r, m)
    assert bool((want[1] == 0).all()) and bool((want[0] == BIG).all())
    _same(scan_model(q, r, m, torch.zeros(1, dtype=torch.int32), NN1Plan(1, 300, 2)), want)
