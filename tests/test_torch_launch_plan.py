"""The launch plans of the `nn1` and `fps` kernels (ops/nn_cuda.py::nn1_plan,
ops/resample_cuda.py::fps_plan), at the shapes the main path gives them.

The kernels run only on the card; their plans are plain Python, so the
partition of work they imply is checked here: every reference row falls in
exactly one cluster slice, the cluster size is one the card takes, every
query has a thread, and R is split until every SM has two blocks or the
cluster is at its cap."""

import pytest

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
                                 MAX_POINTS])
def test_fps_plan_covers_the_cloud(p_n):
    plan = fps_plan(p_n)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= MAX_THREADS
    if p_n <= 8192:
        assert plan.k in (1, 2, 4, 8, 16)
        assert plan.k * plan.threads >= p_n > plan.k * (plan.threads - 32)  # no whole idle warp
        assert plan.k == 1 or p_n > plan.k // 2 * MAX_THREADS  # the fewest points a thread
    else:
        assert plan == (0, MAX_THREADS)
