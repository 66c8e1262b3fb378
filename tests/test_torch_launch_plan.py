"""The launch plans of the `nn1`, `fps` and field kernels (ops/nn_cuda.py::
nn1_plan, ops/resample_cuda.py::fps_plan, ops/coarse_cuda.py::field_plan), at
the shapes the main path gives them.

The kernels run only on the card; their plans are plain Python, so the
partition of work they imply is checked here: every reference row falls in
exactly one cluster slice, the cluster size is one the card takes, every
query has a thread, and R is split until every SM has two blocks or the
cluster is at its cap; every (rotation, source point) pair of a field is
finished by exactly one block."""

import pytest

from kss_icp_torch.ops.coarse_cuda import FIELD_GROUP, FIELD_Q, FIELD_SLOTS, field_plan
from kss_icp_torch.ops.nn_cuda import MAX_CLUSTER, MIN_SLICE, SMS, TILE_QUERIES, nn1_plan
from kss_icp_torch.ops.resample_cuda import MAX_POINTS, MAX_THREADS, fps_plan

# (L, Q, R, label, cluster): the ICP screen, refine and escalation screen,
# the metric at the smallest and largest remesh pair's padded shape, the K4
# regime, and small shapes of the tests.
NN1_SHAPES = [
    (32, 512, 2048, "screen", 8),
    (4, 2048, 2048, "refine", 8),
    (2, 2048, 2048, "two-tier refine", 8),
    (1, 2048, 2048, "final converge", 8),
    (16, 512, 2048, "escalation screen", 8),
    (3, 2048, 2048, "escalation refine", 8),
    (1, 3072, 8192, "metric, largest remesh pair", 8),
    (1, 768, 4096, "metric, smallest remesh pair", 8),
    (1, 65536, 65536, "K4 regime", 2),
    (1, 40, 300, "tiny", 1),
    (6, 700, 1500, "lanes", 4),
    (1, 1001, 2037, "ragged", 4),
    (1, 1, 1, "one row", 1),
]


def _slices(plan, r_n):
    """The rows block rank c scans, as csrc/nn.cu computes them."""
    out = []
    for c in range(plan.cluster):
        lo = min(r_n, c * plan.slice)
        out.append(range(lo, min(r_n, lo + plan.slice)))
    return out


@pytest.mark.parametrize("lanes, q_n, r_n, label, cluster", NN1_SHAPES, ids=[s[3] for s in NN1_SHAPES])
def test_nn1_plan_partitions_the_work(lanes, q_n, r_n, label, cluster):
    plan = nn1_plan(lanes, q_n, r_n)
    assert plan.cluster == cluster and plan.cluster in (1, 2, 4, 8) and plan.cluster <= MAX_CLUSTER
    rows = [r for s in _slices(plan, r_n) for r in s]
    assert rows == list(range(r_n))  # every row in exactly one slice, in rank order
    assert plan.cluster == 1 or plan.slice >= MIN_SLICE
    # The merge: rank c writes queries [c * 256 // C, (c + 1) * 256 // C) of the tile.
    shares = [range(c * TILE_QUERIES // plan.cluster, (c + 1) * TILE_QUERIES // plan.cluster)
              for c in range(plan.cluster)]
    assert [q for s in shares for q in s] == list(range(TILE_QUERIES))
    _assert_two_blocks_an_sm(plan, lanes, q_n, r_n, SMS)


def _assert_two_blocks_an_sm(plan, lanes, q_n, r_n, sms):
    """R is split no further than two blocks an SM, and as far as that while it can."""
    blocks = lanes * -(-q_n // TILE_QUERIES) * plan.cluster
    assert plan.cluster == 1 or blocks // 2 < 2 * sms
    assert blocks >= 2 * sms or plan.cluster == MAX_CLUSTER or r_n < 2 * plan.cluster * MIN_SLICE


@pytest.mark.parametrize("sms, cluster", [(132, 8), (114, 4), (48, 2), (16, 1)])
def test_nn1_plan_follows_the_sm_count(sms, cluster):
    """The card's SM count sets the split: the screen's 32 lanes x 512 queries are 64 tiles."""
    plan = nn1_plan(32, 512, 8192, sms)
    assert plan.cluster == cluster and plan.cluster * plan.slice >= 8192
    _assert_two_blocks_an_sm(plan, 32, 512, 8192, sms)


@pytest.mark.parametrize("p_n", [1, 31, 32, 757, 768, 1024, 1025, 2048, 3072, 4096, 6144, 8192, 8193, 12801,
                                 65536, 65537, 151552, MAX_POINTS])
def test_fps_plan_covers_the_cloud(p_n):
    plan = fps_plan(p_n)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= MAX_THREADS
    if p_n <= 8192:
        assert plan.k in (1, 2, 4, 8, 16)
        assert plan.k * plan.threads >= p_n > plan.k * (plan.threads - 32)  # no whole idle warp
        assert plan.k == 1 or p_n > plan.k // 2 * MAX_THREADS  # the fewest points a thread
    else:
        assert plan == (0, MAX_THREADS)


# (C, P, label, slots): the 8³ and 16³ grids at the main path's padded clouds,
# the bench config's 512-point prefixes, and small shapes of the tests.
FIELD_SHAPES = [
    (512, 2048, "8³ grid, padded clouds", 4),
    (4096, 512, "16³ grid, 512-point prefixes", 2),
    (512, 512, "8³ grid, bench prefixes", 2),
    (729, 2048, "9³ grid: C not a multiple of q", 4),
    (27, 2048, "3³ grid", 4),
    (27, 200, "small P", 1),
    (64, 256, "one group", 1),
    (8, 150, "tests' tiny field", 1),
    (2, 10, "two rotations", 1),
    (1, 1, "one of each", 1),
    (65535, 1, "the most rotations", 1),
]


def _field_cover(slots, c_n, p_n):
    """The (rotation, point) pairs the kernels' blocks finish, as
    csrc/field_kernel.cuh computes them: block b holds rotations b * 4 +
    [0, 4) and walks the points in steps of `slots` groups of 256, a thread
    a point."""
    groups = -(-p_n // FIELD_GROUP)
    finished = []
    for b in range(-(-c_n // FIELD_Q)):
        rotations = [c for c in range(b * FIELD_Q, (b + 1) * FIELD_Q) if c < c_n]
        for g0 in range(0, groups, slots):
            finished += [(c, p) for c in rotations for p in range(g0 * FIELD_GROUP, (g0 + slots) * FIELD_GROUP)
                         if p < p_n]
    return finished


@pytest.mark.parametrize("c_n, p_n, label, expected", FIELD_SHAPES, ids=[s[2] for s in FIELD_SHAPES])
def test_field_plan_partitions_the_work(c_n, p_n, label, expected):
    slots = field_plan(p_n)
    assert slots == expected
    assert sorted(_field_cover(slots, c_n, p_n)) == [(c, p) for c in range(c_n) for p in range(p_n)]  # each once
    # What kss_field_ave and kss_field_dot accept (csrc/field_kernel.cuh::
    # launch_field), else they return cudaErrorInvalidValue.
    assert slots in FIELD_SLOTS and c_n <= 65535
    assert slots == 1 or slots * FIELD_GROUP < p_n + FIELD_GROUP  # no group slot left idle


@pytest.mark.parametrize("p_n, slots", [(1, 1), (256, 1), (257, 2), (512, 2), (768, 2), (1024, 4), (2048, 4),
                                        (8192, 4)])
def test_field_plan_slots_follow_the_source(p_n, slots):
    """As many group slots as the source has groups of 256 points, up to 4:
    256 to 1024 threads a block."""
    assert field_plan(p_n) == slots
