"""The launch plans of the `nn1`, `fps` and `field_dot` kernels
(ops/nn_cuda.py::nn1_plan, ops/resample_cuda.py::fps_plan,
ops/coarse_cuda.py::dot_plan), at the shapes the main path gives them.

The kernels run only on the card; their plans are plain Python, so the
partition of work they imply is checked here: every reference row falls in
exactly one cluster slice, the cluster size is one the card takes, every
query has one thread and one merge share, 4 queries a thread exactly where
the launch still gives every SM two blocks, and R is split until every SM
has two blocks or the cluster is at its cap; every (rotation, source point) pair of a field_dot
launch is finished by exactly one warp, and the staged target fits the
block's shared memory; every point of an `fps` cloud lies in
exactly one block's contiguous slice, within what a block holds."""

import pytest

from kss_icp_torch.ops.coarse_cuda import (DOT_MAX_POINTS, DOT_POINTS, DOT_SM_SMEM, DOT_STATIC_SMEM, DOT_TILE,
                                           dot_plan, dot_stage_bytes)
from kss_icp_torch.ops.nn_cuda import MAX_CLUSTER, MIN_SLICE, QUERIES, SMS, THREADS, nn1_plan
from kss_icp_torch.ops.resample_cuda import (CLUSTER_MIN_POINTS, CLUSTER_POINTS, CLUSTER_THREADS, CLUSTERS,
                                             MAX_POINTS, MAX_THREADS, MIN_CLUSTER, REGISTER_POINTS, REGISTER_SLICE,
                                             SHARED_K, SHARED_SLICE, SHARED_THREADS, FPSPlan, block_plan,
                                             empty_step_plan, fps_plan)
from kss_icp_torch.ops.resample_cuda import MIN_SLICE as FPS_MIN_SLICE

# (L, Q, R, label, (queries a thread, cluster)): the ICP screen, refine and
# escalation screen, the metric at the smallest and largest remesh pair's
# padded shape, the K4 regime, the batches' screen, the overlap screen's rung
# and metric, the room's metric and a mesh rank's quarter of it, and small
# shapes of the tests.
NN1_SHAPES = [
    (32, 512, 2048, "screen", (2, 8)),
    (4, 2048, 2048, "refine", (2, 8)),
    (2, 2048, 2048, "two-tier refine", (2, 8)),
    (1, 2048, 2048, "final converge", (2, 8)),
    (16, 512, 2048, "escalation screen", (2, 8)),
    (3, 2048, 2048, "escalation refine", (2, 8)),
    (1, 3072, 8192, "metric, largest remesh pair", (2, 8)),
    (1, 768, 4096, "metric, smallest remesh pair", (2, 8)),
    (1, 65536, 65536, "K4 regime", (2, 2)),
    (2048, 512, 2048, "boards batch screen", (4, 2)),
    (8192, 512, 2048, "overlap screen rung", (4, 2)),
    (64, 8192, 8192, "boards batch metric", (4, 2)),
    (1, 200704, 200704, "room metric", (4, 2)),
    (1, 50176, 200704, "a mesh rank's room metric", (2, 2)),
    (224, 512, 2048, "a mesh rank's screen", (2, 2)),
    (300, 512, 300, "4 queries a thread, R unsplit", (4, 1)),
    (1, 40, 300, "tiny", (2, 1)),
    (6, 700, 1500, "lanes", (2, 4)),
    (1, 1001, 2037, "ragged", (2, 4)),
    (1, 1, 1, "one row", (2, 1)),
]


def _slices(plan, r_n):
    """The rows block rank c scans, as csrc/nn.cu computes them."""
    out = []
    for c in range(plan.cluster):
        lo = min(r_n, c * plan.slice)
        out.append(range(lo, min(r_n, lo + plan.slice)))
    return out


@pytest.mark.parametrize("lanes, q_n, r_n, label, chosen", NN1_SHAPES, ids=[s[3] for s in NN1_SHAPES])
def test_nn1_plan_partitions_the_work(lanes, q_n, r_n, label, chosen):
    plan = nn1_plan(lanes, q_n, r_n)
    assert (plan.queries, plan.cluster) == chosen
    assert plan.queries in QUERIES and plan.cluster in (1, 2, 4, 8) and plan.cluster <= MAX_CLUSTER
    rows = [r for s in _slices(plan, r_n) for r in s]
    assert rows == list(range(r_n))  # every row in exactly one slice, in rank order
    assert plan.cluster == 1 or plan.slice >= MIN_SLICE
    # The merge: rank c writes queries [c * QT // C, (c + 1) * QT // C) of the tile of QT queries.
    tile = plan.tile_queries
    shares = [range(c * tile // plan.cluster, (c + 1) * tile // plan.cluster) for c in range(plan.cluster)]
    assert [q for s in shares for q in s] == list(range(tile))
    _assert_two_blocks_an_sm(plan, lanes, q_n, r_n, SMS)


def _assert_two_blocks_an_sm(plan, lanes, q_n, r_n, sms):
    """4 queries a thread exactly where the launch, R unsplit, gives every
    SM two blocks; R split over 2 blocks where it holds two slices of 256
    rows, further no more than two blocks an SM need, and as far as that
    while it can."""
    assert (plan.queries == 4) == (lanes * -(-q_n // (THREADS * 4)) >= 2 * sms)
    assert (plan.cluster >= 2) == (r_n >= 2 * MIN_SLICE)
    blocks = lanes * -(-q_n // plan.tile_queries) * plan.cluster
    assert plan.cluster <= 2 or blocks // 2 < 2 * sms
    assert blocks >= 2 * sms or plan.cluster == MAX_CLUSTER or r_n < 2 * plan.cluster * MIN_SLICE


@pytest.mark.parametrize("sms, cluster", [(132, 8), (114, 4), (48, 2), (16, 2)])
def test_nn1_plan_follows_the_sm_count(sms, cluster):
    """The card's SM count sets the split: the screen's 32 lanes x 512 queries are 64 tiles."""
    plan = nn1_plan(32, 512, 8192, sms)
    assert plan.cluster == cluster and plan.cluster * plan.slice >= 8192
    _assert_two_blocks_an_sm(plan, 32, 512, 8192, sms)


@pytest.mark.parametrize("lanes, q_n, sms", [(1, 200704, 132), (1, 135168, 132), (1, 134656, 132), (263, 512, 132),
                                             (264, 512, 132), (8, 8192, 8), (7, 8192, 8), (32, 512, 16),
                                             (2048, 512, 132), (1, 1, 1)])
def test_nn1_plan_queries_a_thread_give_every_query_one_thread(lanes, q_n, sms):
    """4 queries a thread where the launch of 512-query tiles still gives
    every SM two blocks, else 2; every query of a tile has exactly one
    (thread, slot): query q0 + tid + u * 128 of csrc/nn.cu, and the tiles
    cover Q."""
    plan = nn1_plan(lanes, q_n, 2048, sms)
    tiles4 = lanes * -(-q_n // 512)
    assert plan.queries == (4 if tiles4 >= 2 * sms else 2)
    tile = plan.tile_queries
    assert sorted(tid + u * THREADS for tid in range(THREADS) for u in range(plan.queries)) == list(range(tile))
    assert -(-q_n // tile) * tile >= q_n > (-(-q_n // tile) - 1) * tile
    _assert_two_blocks_an_sm(plan, lanes, q_n, 2048, sms)


def _assert_block_holds_its_slice(plan, p_n):
    """The slices [r * slice, (r + 1) * slice) of the C blocks cover the
    cloud in rank order, every block holds a point, and a block's slice fits
    what csrc/fps.cu takes: registers (1-16 points a thread, <= 512 threads)
    or shared memory (32 scores a thread, 512 threads), and, in registers,
    the fewest points a thread with no whole idle warp."""
    slices = [range(r * plan.slice, min(p_n, (r + 1) * plan.slice)) for r in range(plan.cluster)]
    assert [i for s in slices for i in s] == list(range(p_n))
    assert all(len(s) > 0 for s in slices)
    assert plan.cluster in CLUSTERS and plan.threads % 32 == 0
    if plan.registers:
        assert plan.k in REGISTER_POINTS and 32 <= plan.threads <= MAX_THREADS and plan.slice <= REGISTER_SLICE
        assert plan.k * plan.threads >= plan.slice > plan.k * (plan.threads - 32)  # no whole idle warp
        if plan.cluster == 1:  # the fewest points a thread
            assert plan.k == 1 or plan.slice > plan.k // 2 * MAX_THREADS
        elif plan.threads <= CLUSTER_THREADS:  # the fewest of 4+ points a thread within CLUSTER_THREADS
            assert plan.k == CLUSTER_MIN_POINTS or plan.slice > plan.k // 2 * CLUSTER_THREADS
        else:  # past 16 x CLUSTER_THREADS points: 16 a thread
            assert plan.k == 16 and plan.slice > 16 * CLUSTER_THREADS
    else:  # the kernel's constant stride: 512 threads, 32 scores each
        assert (plan.k, plan.threads) == (SHARED_K, SHARED_THREADS) == (32, 512)
        assert REGISTER_SLICE < plan.slice <= SHARED_SLICE


@pytest.mark.parametrize("p_n", [1, 31, 32, 757, 768, 1024, 1025, 2048, 3072, 4096, 6144, 8192, 8193, 12801,
                                 65536, 65537, 151552, MAX_POINTS])
def test_fps_plan_covers_the_cloud(p_n):
    """Since clusters: one block a cloud up to 8192 points where no cluster
    of 4+ blocks pays, else a cluster whose contiguous slices cover the
    cloud (it was (0, 512) above 8192, one block walking a workspace)."""
    plan = fps_plan(2, p_n)
    _assert_block_holds_its_slice(plan, p_n)
    if p_n <= CLUSTER_POINTS:
        assert plan.cluster == 1 and plan.registers and plan.slice == p_n
    else:
        assert plan.cluster >= MIN_CLUSTER


# (B, P, sms, cluster): the main path's batches at full_pad 8192 (register_
# pair's one cloud, a mesh rank's 14, the remesh 25's 50, the boards' 128), the
# remesh source, the large scan's widest pad and others, WLOP's start,
# MAX_POINTS, clusters the card's SMs cut short, and a batch too large for the
# card, whose slices still have to fit a block.
FPS_PLANS = [
    (1, 8192, 132, 16), (2, 8192, 132, 16), (14, 8192, 132, 8), (50, 8192, 132, 1), (128, 8192, 132, 1),
    (1, 3072, 132, 1), (1, CLUSTER_POINTS, 132, 1), (1, CLUSTER_POINTS + 1, 132, 8), (33, 8192, 132, 4),
    (34, 8192, 132, 1), (2, 151552, 132, 16), (2, 135168, 132, 16), (1, 40960, 132, 16), (1, MAX_POINTS, 132, 16),
    (40, 20000, 132, 2), (20, 20000, 132, 4), (16, 20000, 132, 8), (2, 8193, 132, 16), (2, 151552, 48, 16),
    (4, 65536, 48, 8), (2, 151552, 16, 16), (50, 151552, 132, 16), (66, 40960, 132, 4), (33, 40960, 132, 4),
    (16, 40960, 132, 8), (1, 16385, 132, 16), (200, 9000, 132, 2), (1, 5000, 8, 1),
]


@pytest.mark.parametrize("batch, p_n, sms, cluster", FPS_PLANS,
                         ids=[f"{b}x{p}-sms{s}" for b, p, s, _ in FPS_PLANS])
def test_fps_plan_fits_the_card(batch, p_n, sms, cluster):
    """The smallest cluster whose slices fit a block, grown while B x C <=
    SMs, the slices keep MIN_SLICE points and C <= 16; one block a cloud up
    to CLUSTER_POINTS, and up to 8192 points where the batch leaves room for
    a cluster of fewer than MIN_CLUSTER blocks (the 50 and 128 clouds of
    register_many's batches)."""
    plan = fps_plan(batch, p_n, sms)
    assert plan.cluster == cluster
    _assert_block_holds_its_slice(plan, p_n)
    smallest = next(c for c in CLUSTERS if -(-p_n // c) <= (REGISTER_SLICE if c == 1 else SHARED_SLICE))
    if plan.cluster > smallest:  # grown: B x C fits the card and the slices keep their floor
        assert batch * plan.cluster <= sms and plan.slice >= FPS_MIN_SLICE
    grown = plan.cluster * 2
    assert (grown > CLUSTERS[-1] or batch * grown > sms or -(-p_n // grown) < FPS_MIN_SLICE
            or (plan.cluster == 1 and p_n <= REGISTER_SLICE))
    if plan.cluster == 1:
        assert p_n <= CLUSTER_POINTS or (p_n <= REGISTER_SLICE and batch * MIN_CLUSTER > sms)


def test_fps_block_plan_refuses_a_slice_past_shared_memory():
    with pytest.raises(ValueError, match=str(SHARED_SLICE)):
        block_plan(MAX_POINTS, 8)
    assert block_plan(MAX_POINTS, 16) == FPSPlan(16, SHARED_SLICE, SHARED_K, SHARED_THREADS, False)


@pytest.mark.parametrize("batch, p_n", [(2, 8192), (2, 151552), (1, 40960)])
def test_fps_empty_step_plan_keeps_the_shape(batch, p_n):
    """The empty step's plan: the cluster, threads and kind of slice of the
    run's plan, one point a block, and a slice its threads hold."""
    plan = fps_plan(batch, p_n)
    floor = empty_step_plan(plan)
    assert (floor.cluster, floor.threads, floor.registers) == (plan.cluster, plan.threads, plan.registers)
    assert floor.slice == 1 and floor.k * floor.threads >= 1 and floor.k in (1, SHARED_K)


# (C, P, label): the 8³ and 16³ grids at the main path's padded clouds, the
# bench config's 512-point prefixes, and small shapes of the tests.
FIELD_SHAPES = [
    (512, 2048, "8³ grid, padded clouds"),
    (4096, 512, "16³ grid, 512-point prefixes"),
    (512, 512, "8³ grid, bench prefixes"),
    (729, 2048, "9³ grid: C not a multiple of the grid"),
    (27, 2048, "3³ grid"),
    (27, 200, "small P"),
    (64, 256, "one group"),
    (8, 150, "tests' tiny field"),
    (2, 10, "two rotations"),
    (1, 1, "one of each"),
    (65535, 1, "the most rotations"),
]


def _dot_cover(plan, c_n, p_n, groups):
    """The (rotation, point) pairs the field_dot kernel's warps finish, as
    csrc/field_dot.cu walks them: block b holds rotations b, b + blocks, ...;
    its items, (local rotation, index into `groups`, the 64-point groups
    with a valid point), go to its 8 warps in turn; an item is 4 m16 tiles,
    rows g and g + 8 of each of 8 quads."""
    finished = []
    for b in range(plan.blocks):
        rotations = list(range(b, c_n, plan.blocks))
        items = len(rotations) * len(groups)
        for warp in range(8):
            for item in range(warp, items, 8):
                c, grp = rotations[item // len(groups)], groups[item % len(groups)]
                finished += [(c, p) for tile in range(4) for g in range(8) for h in range(2)
                             if (p := grp * DOT_POINTS + tile * 16 + g + 8 * h) < p_n]
    return finished


@pytest.mark.parametrize("c_n, p_n, label", FIELD_SHAPES, ids=[s[2] for s in FIELD_SHAPES])
def test_field_dot_plan_covers_every_rotation_and_point_once(c_n, p_n, label):
    """Every (rotation, source point) pair finished exactly once at either
    precision; skipping a group of masked points drops exactly its pairs;
    the grid is persistent (no more than two blocks an SM, none idle) and
    the staged whole target fits the plan's blocks an SM."""
    groups = list(range(-(-p_n // DOT_POINTS)))
    want = [(c, p) for c in range(c_n) for p in range(p_n)]
    for precision, words in (("highest", 3), ("default", 1)):
        plan = dot_plan(c_n, p_n, 2048, precision, 132)
        assert plan.blocks == min(c_n, 264) and plan.cap == 2048
        assert 2 * (dot_stage_bytes(plan.cap, words) + DOT_STATIC_SMEM + 1024) <= DOT_SM_SMEM
        assert sorted(_dot_cover(plan, c_n, p_n, groups)) == want  # each once
    if len(groups) > 1:
        plan = dot_plan(c_n, p_n, 2048, "highest")
        assert sorted(_dot_cover(plan, c_n, p_n, groups[1:])) == [(c, p) for c, p in want if p >= DOT_POINTS]


@pytest.mark.parametrize("t_n, precision, per_sm, cap", [(4173, "highest", 1, 4224), (100_000, "highest", 1, 4608),
                                                         (100_000, "default", 1, 13952), (4173, "default", 2, 4224),
                                                         (64, "highest", 2, 64)])
def test_field_dot_plan_stages_the_whole_target_where_it_fits(t_n, precision, per_sm, cap):
    """Two blocks an SM where two hold the padded target, else one; the rows
    a block stages at once the whole padded target where one block holds
    it, else the most that fit, a multiple of 64 (the kernel walks chunks)."""
    words = 1 if precision == "default" else 3
    plan = dot_plan(4096, 2048, t_n, precision, 132)
    assert plan.blocks == per_sm * 132 and plan.cap == cap and plan.cap % DOT_TILE == 0
    assert per_sm * (dot_stage_bytes(plan.cap, words) + DOT_STATIC_SMEM + 1024) <= DOT_SM_SMEM
    if plan.cap < t_n:
        assert dot_stage_bytes(plan.cap + DOT_TILE, words) + DOT_STATIC_SMEM + 1024 > DOT_SM_SMEM
    with pytest.raises(ValueError, match="source points"):
        dot_plan(8, DOT_MAX_POINTS + 1, 100, precision)
    with pytest.raises(ValueError, match="precision"):
        dot_plan(8, 100, 100, "tf32")
