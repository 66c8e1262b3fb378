"""The mesh cell's entry (regbench/entries/register_many_mesh.py) and its
readers (regbench/mesh_spans.py and the three mesh metrics), on the CPU at
the small sizes of small.py, over gloo in a world of 2: the entry's
answers are the one-process entry's bits and judged alike; a call hands a
rank pool pairs by key and other pairs whole; every rank times its slice
for the wait; a rank that raises fails the call within the deadline and
every later call at once; dropping the call stops the ranks and leaves the
group; the ranks' shares of the cores; the readers on hand-built traces
and waits."""

from __future__ import annotations

import contextlib
import gc
import sys
import time
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from regbench import generate, harness  # noqa: E402
from regbench.entries import register_many as one_process  # noqa: E402
from regbench.entries import register_many_mesh as mesh_entry  # noqa: E402
from regbench.metrics import mesh_collectives, mesh_slice_ms, mesh_wait_ms  # noqa: E402
from regbench.tests.small import small_spec  # noqa: E402

CELL = "objects.full-overlap.b256-mesh4"
SEED = 2 ** 31 + 23
SPAN_READERS = (mesh_slice_ms, mesh_collectives)


def _spec(deadline_s=None):
    spec = small_spec(CELL)
    spec["config"]["mesh"]["ranks"] = 2
    if deadline_s is not None:
        spec["config"]["mesh"]["deadline_s"] = deadline_s
    return spec


def _group_left() -> bool:
    import torch.distributed as dist

    return not dist.is_initialized()


def test_mesh_answers_are_the_one_process_entrys_bits_and_judged_alike():
    spec = _spec()
    config, mix = spec["config"], spec["mix"]
    calls = generate.make_calls(config, mix, SEED)
    records = {}
    for name, entry in (("mesh", mesh_entry), ("one", one_process)):
        call = entry.prepare(config, mix, "cpu")
        records[name] = [(k, call(c, None), 0.0) for k, c in enumerate(calls)]
        del call
        gc.collect()
    # Every rank timed its slice of every call after the warm-up; a wait is the slowest slice less the mean.
    assert len(mesh_entry.WAITS) == len(calls) - mix["warm_calls"] and min(mesh_entry.WAITS) >= 0
    for (_, mesh, _), (_, one, _) in zip(records["mesh"], records["one"]):
        assert len(mesh) == len(one) == mix["batch"]
        for a, b in zip(mesh, one):
            assert a.scale == b.scale and a.rmse == b.rmse and a.mae == b.mae
            assert np.array_equal(a.rotation, b.rotation) and np.array_equal(a.translation, b.translation)
    import torch

    verdicts = [harness.judge(spec, calls, records[name], torch.device("cpu"), SEED) for name in ("mesh", "one")]
    assert verdicts[0] == verdicts[1]
    assert verdicts[0]["checked_pairs"] == len(calls) * mix["batch"]


def test_pool_pairs_go_by_key_and_other_pairs_whole():
    spec = _spec()
    config, mix = spec["config"], spec["mix"]
    pool = mesh_entry.pool_of(config, mix)
    assert len(pool) == mix["calls"] * mix["batch"]
    window = generate.make_calls(config, mix, SEED)[1]
    fresh = generate.fresh_calls(config, mix, SEED)[0]
    # A fresh pair can carry a pool pair's name (both are "<fixture>/<call>.<j>"): its truth tells them apart.
    impostor = fresh[0]._replace(name=window[0].name)
    pairs = window[:2] + [impostor] + window[2:]
    keys, whole = mesh_entry.handoff(pairs, set(pool))
    assert list(whole) == [2] and keys[2] is None
    assert all(k is not None and k[0] == p.name for i, (k, p) in enumerate(zip(keys, pairs)) if i != 2)
    got = mesh_entry.received(keys, whole, pool)
    assert len(got) == len(pairs)
    for (src, tgt), p in zip(got, pairs):
        assert np.array_equal(src, p.src) and np.array_equal(tgt, p.tgt)


def test_a_rank_that_raises_fails_the_call_within_the_deadline():
    deadline = 30.0
    spec = _spec(deadline)
    config, mix = spec["config"], spec["mix"]
    calls = generate.make_calls(config, mix, SEED)
    call = mesh_entry.prepare(config, mix, "cpu")
    bad = list(calls[0])
    p = generate.fresh_calls(config, mix, SEED)[0][0]  # outside the pool, so it goes whole
    bad[-1] = p._replace(src=np.ascontiguousarray(p.src[:, :2]))  # rank 1's: two columns, which it refuses
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1"):
        call(bad, None)
    assert time.perf_counter() - t0 < deadline + mesh_entry.STOP_S
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="failed on an earlier call"):
        call(calls[1], None)
    assert time.perf_counter() - t0 < 1.0
    procs = call.ranks.procs
    assert not any(p.is_alive() for p in procs) and _group_left()  # stopped on the failure, not on the drop


def test_dropping_the_call_stops_the_ranks_and_leaves_the_group():
    spec = _spec()
    call = mesh_entry.prepare(spec["config"], spec["mix"], "cpu")
    assert len(call.ranks.procs) == 1 and all(p.is_alive() for p in call.ranks.procs)
    procs = call.ranks.procs
    del call
    gc.collect()
    assert [p.exitcode for p in procs] == [0] and _group_left()


def test_a_traced_small_run_reports_the_host_metric_and_loads_no_jax():
    r = harness.run(CELL, SEED, 0.1, True, device="cpu", spec=_spec())
    assert r["correct"] and r["failed"] == 0, r["compared"]
    m = r["metrics"]
    assert m["mesh_slice_ms"]["value"] > 0 and m["mesh_slice_ms"]["unit"] == "ms/call"
    assert m["mesh_wait_ms"]["value"] >= 0 and m["mesh_wait_ms"]["unit"] == "ms/call"
    assert "mesh_collectives" not in m  # gloo on the CPU launches no NCCL kernel
    assert harness.forbidden_modules() == [] and _group_left()


# --- the readers, on hand-built chrome traces ---

def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# Two calls on rank 0: each a slice (3000 and 5000 us) then a gather. The
# first gather launches two NCCL all-gathers through the driver API and one
# through the runtime, and a concatenation; the second one NCCL kernel. An
# NCCL kernel launched outside the gathers is theirs neither.
TRACE = [
    _x("user_annotation", "kss.register_many", 0, 4000),
    _x("user_annotation", "kss.mesh.slice", 0, 3000),
    _x("cuda_runtime", "cudaLaunchKernel", 100, 5, corr=1),
    _x("user_annotation", "kss.mesh.gather", 3000, 900),
    _x("cuda_driver", "cuLaunchKernelEx", 3010, 5, corr=2),
    _x("cuda_driver", "cuLaunchKernelEx", 3100, 5, corr=3),
    _x("cuda_runtime", "cudaLaunchKernel", 3200, 5, corr=4),
    _x("cuda_runtime", "cudaLaunchKernel", 3300, 5, corr=5),
    _x("user_annotation", "kss.mesh.slice", 10000, 5000),
    _x("user_annotation", "kss.mesh.gather", 15000, 500),
    _x("cuda_driver", "cuLaunchKernelEx", 15010, 5, corr=6),
    _x("cuda_driver", "cuLaunchKernelEx", 16000, 5, corr=7),
    _x("kernel", "void nn1_kernel(float const*)", 120, 50, corr=1),
    _x("kernel", "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)", 3020, 2000, corr=2),
    _x("kernel", "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)", 5030, 30, corr=3),
    _x("kernel", "ncclKernel_AllGather_RING_LL_Sum_int8_t(ncclWorkElem)", 5070, 20, corr=4),
    _x("kernel", "void at::native::CatArrayBatchedCopy<float>()", 5100, 10, corr=5),
    _x("kernel", "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)", 15020, 450, corr=6),
    _x("kernel", "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)", 16010, 40, corr=7),
]
CTX = {"host_trace": TRACE}


def test_slice_time_is_a_calls_mean():
    assert mesh_slice_ms.read(CTX) == pytest.approx((3000 + 5000) / 2 / 1e3)


def test_collectives_count_driver_and_runtime_launches_inside_the_gathers_only():
    assert mesh_collectives.read(CTX) == pytest.approx(4 / 2)


def test_a_driver_api_launch_alone_is_counted():
    driver_only = [e for e in TRACE if e.get("args", {}).get("correlation") not in (4, 5)
                   or e["cat"] == "user_annotation"]
    assert mesh_collectives.read({"host_trace": driver_only}) == pytest.approx(3 / 2)


@pytest.mark.parametrize("reader", SPAN_READERS, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_none_without_mesh_spans(reader):
    parent = [e for e in TRACE if not e["name"].startswith("kss.mesh.")]
    assert reader.read({"host_trace": parent}) is None
    assert reader.read({"host_trace": None}) is None
    assert reader.read({}) is None


@pytest.mark.parametrize("reader", (mesh_collectives,), ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_device_readers_are_none_without_nccl_kernels(reader):
    host_only = [e for e in TRACE if e["cat"] != "kernel"]
    assert reader.read({"host_trace": host_only}) is None
    assert mesh_slice_ms.read({"host_trace": host_only}) == pytest.approx(4.0)


@pytest.mark.parametrize("waits, ms", [([], None), ([0.002, 0.004, 0.0], 2.0)], ids=("untimed", "timed"))
def test_wait_is_the_mean_of_the_calls_waits_and_none_where_no_rank_timed_a_slice(monkeypatch, waits, ms):
    monkeypatch.setattr(mesh_entry, "WAITS", waits)
    got = mesh_wait_ms.read(CTX)
    assert got is None if ms is None else got == pytest.approx(ms)


def test_the_slice_clock_times_the_slice_and_hands_every_stage_to_the_benchmarks_timer():
    seen = []

    @contextlib.contextmanager
    def inner(name):
        seen.append(name)
        yield

    for timer in (inner, None):
        clock = mesh_entry.SliceClock(timer)
        assert clock.seconds is None  # a program that never enters "mesh.slice" (the parent's) leaves it None
        with clock("mesh.slice"):
            with clock("resample"):
                time.sleep(0.01)
        assert clock.seconds >= 0.01
    assert seen == ["mesh.slice", "resample"]


@pytest.mark.parametrize("world", [1, 2, 4])
def test_core_sets_deal_each_rank_an_equal_share_of_its_own(world):
    import os

    allowed = sorted(os.sched_getaffinity(0))
    sets = mesh_entry.core_sets(world)
    if len(allowed) < world:
        assert sets is None
        return
    flat = [c for s in sets for c in s]
    assert len(sets) == world and len(flat) == len(set(flat)) and set(flat) <= set(allowed)
    assert {len(s) for s in sets} == {len(allowed) // world}


def test_core_sets_refuse_more_ranks_than_cpus():
    import os

    assert mesh_entry.core_sets(len(os.sched_getaffinity(0)) + 1) is None
