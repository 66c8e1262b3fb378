"""The readers of the program's own spans (regbench/program_spans.py and the
four metrics on it) on a hand-built chrome trace: nested "kss." ranges on
the host, runtime launches inside and outside the lockstep steps, and their
kernels on the device; None on a trace without "kss." spans (a program that
opens none). Then a traced run of a small cell on the CPU, whose line
carries the host's three."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from regbench import harness, program_spans  # noqa: E402
from regbench.metrics import host_syncs, icp_step_device_us, icp_step_host_us, sync_wait_ms  # noqa: E402
from regbench.tests.small import small_spec  # noqa: E402

READERS = (icp_step_host_us, icp_step_device_us, host_syncs, sync_wait_ms)


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# Two lockstep steps, each with its stop read (40 and 80 us) and its
# launches (kernels of 20 + 30 and 25 us); a ladder read and the result's
# read outside them (60 and 50 us), and a launch outside the steps (100 us).
TRACE = [
    _x("user_annotation", "regbench.refine", 0, 1000),
    _x("user_annotation", "kss.register_many", 0, 1000),
    _x("user_annotation", "kss.icp", 100, 500),
    _x("user_annotation", "kss.icp.step", 100, 200),
    _x("cuda_runtime", "cudaLaunchKernel", 110, 5, corr=1),
    _x("cuda_runtime", "cudaLaunchKernelExC", 150, 5, corr=2),
    _x("user_annotation", "kss.sync.icp_stop", 250, 40),
    _x("cpu_op", "aten::_local_scalar_dense", 252, 36),
    _x("user_annotation", "kss.icp.step", 300, 200),
    _x("cuda_runtime", "cudaLaunchKernel", 310, 5, corr=3),
    _x("user_annotation", "kss.sync.icp_stop", 420, 80),
    _x("cuda_runtime", "cudaLaunchKernel", 650, 5, corr=4),
    _x("user_annotation", "kss.sync.ladder", 700, 60),
    _x("user_annotation", "kss.sync.result", 900, 50),
    _x("kernel", "void nn1_kernel(float const*)", 120, 20, corr=1),
    _x("kernel", "void at::native::reduce_kernel<512>()", 160, 30, corr=2),
    _x("kernel", "void nn1_kernel(float const*)", 320, 25, corr=3),
    _x("kernel", "void field_cull_kernel()", 660, 100, corr=4),
    _x("gpu_user_annotation", "kss.icp.step", 120, 300),
]
CTX = {"host_trace": TRACE, "metric_rows": [(100, 100), (200, 200)]}


def test_step_host_time_leaves_out_the_waits_inside_it():
    # ((200 - 40) + (200 - 80)) / 2 steps.
    assert icp_step_host_us.read(CTX) == pytest.approx(140.0)


def test_step_device_time_is_its_launches_kernels():
    # (20 + 30 + 25) / 2 steps; the kernel launched outside the steps is not theirs.
    assert icp_step_device_us.read(CTX) == pytest.approx(37.5)


def test_syncs_and_their_wait_a_pair():
    assert host_syncs.read(CTX) == pytest.approx(4 / 2)
    assert sync_wait_ms.read(CTX) == pytest.approx((40 + 80 + 60 + 50) / 1e3 / 2)


def test_overlap_counts_only_the_covered_part():
    assert program_spans.overlap_us([(0, 10), (20, 30)], [(5, 25), (8, 9), (29, 40)]) == pytest.approx(11.0)
    assert program_spans.overlap_us([(0, 10)], []) == 0.0


@pytest.mark.parametrize("reader", READERS, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_none_without_program_spans(reader):
    parent = [e for e in TRACE if not e["name"].startswith("kss.")]
    assert reader.read({"host_trace": parent, "metric_rows": CTX["metric_rows"]}) is None
    assert reader.read({"host_trace": None, "metric_rows": []}) is None
    assert reader.read({}) is None


def test_device_time_is_none_on_a_trace_without_kernels():
    host_only = [e for e in TRACE if e["cat"] != "kernel"]
    assert icp_step_device_us.read({"host_trace": host_only, "metric_rows": CTX["metric_rows"]}) is None
    assert icp_step_host_us.read({"host_trace": host_only, "metric_rows": CTX["metric_rows"]}) == pytest.approx(140.0)


def test_a_traced_small_run_reports_the_host_metrics():
    cell = "objects.full-overlap.b64"
    r = harness.run(cell, 2 ** 31 + 11, 0.1, True, device="cpu", spec=small_spec(cell))
    m = r["metrics"]
    assert m["icp_step_host_us"]["value"] > 0 and m["icp_step_host_us"]["unit"] == "us/iter"
    assert m["host_syncs"]["value"] >= 1 and m["sync_wait_ms"]["value"] > 0
    assert "icp_step_device_us" not in m  # the CPU launches no kernel
