"""The traffic mixes: one seed gives the same inputs, another seed others,
every call the same spread of work; the frozen generators give the port's
arrays."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from regbench import generate, harness  # noqa: E402
from regbench.sources import _shapes  # noqa: E402
from regbench.tests.small import small_spec  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
BIG_SEED = 2 ** 31 + 12345


def _calls(cell, seed):
    spec = small_spec(cell)
    return generate.make_calls(spec["config"], spec["mix"], seed)


def _flat(calls):
    return [(p.src, p.tgt, p.truth["R"], p.truth["s"], p.truth["t"]) for c in calls for p in c]


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_inputs(cell):
    a, b = _flat(_calls(cell, BIG_SEED)), _flat(_calls(cell, BIG_SEED))
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            assert np.array_equal(u, v)


@pytest.mark.parametrize("cell", CELLS)
def test_other_seed_other_inputs(cell):
    a, b = _flat(_calls(cell, BIG_SEED)), _flat(_calls(cell, BIG_SEED + 1))
    assert not all(np.array_equal(x[0], y[0]) for x, y in zip(a, b))


@pytest.mark.parametrize("cell", CELLS)
def test_every_seed_runs_the_pool_calls_in_one_sequence(cell):
    spec = small_spec(cell)
    assert "pool" in spec["mix"]
    a, b = _calls(cell, BIG_SEED), _calls(cell, BIG_SEED + 1)
    assert [sorted(p.name for p in c) for c in a] == [sorted(p.name for p in c) for c in b]


@pytest.mark.parametrize("cell", CELLS)
def test_calls_have_the_mix_shape(cell):
    spec = harness.load_cell(cell)
    calls = generate.make_calls(spec["config"], spec["mix"], 7)
    assert len(calls) == spec["mix"]["calls"] and all(len(c) == spec["mix"]["batch"] for c in calls)
    for c in calls:
        for p in c:
            assert p.src.dtype == np.float32 and p.tgt.dtype == np.float32
            assert np.isfinite(p.src).all() and np.isfinite(p.tgt).all()


def test_remesh_calls_hold_every_fixture_and_the_same_pose_spread():
    spec = harness.load_cell("objects.full-overlap.b64")
    calls = generate.make_calls(spec["config"], spec["mix"], BIG_SEED)
    for c in calls:
        names = [p.name.split("/")[0] for p in c]
        assert len(set(names)) == 25 and min(names.count(n) for n in set(names)) >= 2
        scales = sorted(p.truth["s"] for p in c)
        lo, hi = spec["mix"]["pose"]["scale"]
        assert lo <= scales[0] and scales[-1] < hi
        # One draw in each of 64 strata of the log range.
        strata = np.floor(len(c) * np.log(np.array(scales) / lo) / np.log(hi / lo)).astype(int)
        assert list(strata) == list(range(len(c)))


def test_remesh_truth_undoes_the_pose():
    from regbench.reference.registration import truth_aligned
    from regbench.sources.remesh import fixtures

    spec = harness.load_cell("objects.full-overlap.b64")
    calls = generate.make_calls(spec["config"], dict(spec["mix"], calls=1), 3)
    src0 = {name: s for name, s, _ in fixtures(spec["mix"]["fixture"])}
    for p in calls[0][:8]:
        assert np.abs(truth_aligned(p.src, p.truth) - src0[p.name.split("/")[0]]).max() < 1e-5


def test_frozen_generators_equal_the_ports():
    from kss_icp_torch import challenge, largescan, transfer

    for f in range(len(_shapes.FAMILIES)):
        assert np.array_equal(_shapes.instance(f, 3, 2000, 1), challenge._instance(f, 3, 2000, 1))
    assert np.array_equal(_shapes.room_scene(30000, 11, 1), largescan.room_scene(30000, 11, 1))
    assert np.array_equal(_shapes.rot_xyz(0.3, 1.2, 2.9), challenge.rot_xyz(0.3, 1.2, 2.9))
    pts = np.random.default_rng(0).normal(size=(50, 3))
    rec = transfer.TransferRecord("x", "y", 1.1, 0.7, 0.5)
    assert np.allclose(_shapes.unapply_record(pts, "y", 1.1, 0.7, 0.5), transfer.unapply_record(pts, rec))



def test_remesh_fixture_is_checked_by_its_hash():
    from regbench.sources.remesh import fixtures

    fixture = harness.load_cell("objects.full-overlap.b64")["mix"]["fixture"]
    bad = dict(fixture, sha256=dict(fixture["sha256"], **{".npz": "0" * 64}))
    with pytest.raises(ValueError, match="SHA-256"):
        fixtures(bad)


@pytest.mark.parametrize("cell", CELLS)
def test_fresh_calls_come_from_the_seed_not_the_pool(cell):
    spec = small_spec(cell)
    config, mix = spec["config"], spec["mix"]
    window = {p.src.tobytes() for c in generate.make_calls(config, mix, BIG_SEED) for p in c}
    a, b = generate.fresh_calls(config, mix, BIG_SEED), generate.fresh_calls(config, mix, BIG_SEED + 1)
    assert len(a) == mix["fresh_calls"] and all(len(c) == mix["batch"] for c in a)
    assert _flat(a) and all(np.array_equal(u, v) for x, y in zip(_flat(a), _flat(generate.fresh_calls(
        config, mix, BIG_SEED))) for u, v in zip(x, y))
    assert not any(np.array_equal(x[0], y[0]) for x, y in zip(_flat(a), _flat(b)))
    assert not {p.src.tobytes() for c in a for p in c} & window


def test_room_pose_is_drawn_from_the_seed_within_the_mix_ranges():
    spec = small_spec("room.scan-pair")
    config, mix = spec["config"], spec["mix"]
    a, b = generate.make_calls(config, mix, BIG_SEED), generate.make_calls(config, mix, BIG_SEED + 1)
    assert {p.name for c in a for p in c} == {p.name.split("/")[0] + "/" + p.name.split("/")[1]
                                              for c in b for p in c}  # the pool's rooms
    ta = sorted(tuple(p.truth["t"]) for c in a for p in c)
    assert ta != sorted(tuple(p.truth["t"]) for c in b for p in c)
    for (lo, hi), t in zip(mix["pose"]["shift"], np.array(ta).T):
        assert (lo <= t).all() and (t < hi).all()
