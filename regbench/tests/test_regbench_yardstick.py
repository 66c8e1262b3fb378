"""The benchmark's arithmetic on a small synthetic chrome trace, and the
bound of the large-scan metric row of the port's kernel table."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from regbench import harness, yardstick  # noqa: E402
from regbench.metrics import device_idle_pct, kernel_ms, metric_nn1_roofline  # noqa: E402


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# Host: a "metric" span launching an nn1 kernel, a "screen" span launching two
# kernels with a host op between them; the device: overlapping kernels, a
# memcpy, gaps.
TRACE = [
    _x("user_annotation", "regbench.screen", 0, 100),
    _x("cpu_op", "aten::item", 30, 40),
    _x("cuda_runtime", "cudaLaunchKernel", 5, 2, corr=1),
    _x("cuda_runtime", "cudaLaunchKernel", 75, 2, corr=2),
    _x("user_annotation", "regbench.metric", 100, 50),
    _x("cuda_runtime", "cudaLaunchKernelExC", 110, 2, corr=3),
    _x("kernel", "void nn1_kernel(float const*)", 10, 20, corr=1),
    _x("kernel", "void at::native::reduce_kernel<512>()", 25, 10, corr=9),
    _x("kernel", "void fps_kernel(float const*)", 80, 10, corr=2),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 95, 5),
    _x("kernel", "void nn1_kernel(float const*)", 115, 30, corr=3),
    {"ph": "i", "cat": "kernel", "name": "marker", "ts": 0},
]


def test_device_busy_is_the_union_of_device_intervals():
    # [10, 35] + [80, 90] + [95, 100] + [115, 145] = 25 + 10 + 5 + 30.
    assert yardstick.device_busy_us(TRACE) == 70
    assert yardstick.merged([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]


def test_device_ops_sum_by_name_longest_first():
    ops = yardstick.device_ops(TRACE)
    assert ops[0] == ["void nn1_kernel(float const*)", pytest.approx(50e-6)]
    assert [n for n, _ in ops] == ["void nn1_kernel(float const*)", "void at::native::reduce_kernel<512>()",
                                   "void fps_kernel(float const*)", "Memcpy DtoH (Device -> Pageable)"]


def test_kernels_launched_in_a_span_follow_their_correlation():
    got = yardstick.kernels_launched_in(TRACE, "regbench.metric")
    assert [(e["ts"], e["dur"]) for e in got] == [(115, 30)]
    assert len(yardstick.kernels_launched_in(TRACE, "regbench.screen")) == 2


def test_idle_gaps_by_what_the_host_did():
    gaps = dict(yardstick.idle_gaps(TRACE))
    # Gaps: (35, 80) inside the screen span during aten::item; (90, 95) in the
    # screen span with no host op; (100, 115) in the metric span, whose launch
    # at 110 had not started.
    assert gaps == pytest.approx({"screen / aten::item (1 gaps)": 45e-6, "screen / no host op (1 gaps)": 5e-6,
                                  "metric / no host op (1 gaps)": 15e-6})


def test_bound_reproduces_the_large_scan_metric_row():
    # PERF.md's kernel table: nn1 at 1 x 200704 x 200704, 200000 queries against
    # 200704 rows, bound 5.3920 ms by operations.
    b = yardstick.bound(*yardstick.nn1_work(200_000, 200_704))
    assert b["bound_by"] == "operations"
    assert round(b["bound_ms"], 4) == 5.3920
    # The cell counts valid rows on both sides.
    assert round(yardstick.bound(*yardstick.nn1_work(200_000, 200_000))["bound_ms"], 4) == 5.3731


def test_bound_by_bytes_for_thin_work():
    b = yardstick.bound(*yardstick.nn1_work(1, 1_000_000))
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx((12 * 1_000_001 + 1_000_000 + 8) / 3.35e12 * 1e3)


def test_resample_count():
    assert yardstick.resample_count(757, 8000) == 378
    assert yardstick.resample_count(80_000, 81_000) == 2000
    assert yardstick.resample_count(1, 1) == 1


def test_readers_on_the_trace():
    ctx = {"trace": TRACE, "host_trace": TRACE, "trace_pairs": 2, "trace_window_s": 200e-6, "busy_s": 70e-6,
           "kernel_names": harness.kernel_names(), "metric_rows": [(1000, 2000), (3000, 4000)]}
    # The program's kernels: both nn1 launches and the fps launch, not PyTorch's.
    assert kernel_ms.read(ctx) == pytest.approx((20 + 10 + 30) / 1e3 / 2)
    assert device_idle_pct.read(ctx) == pytest.approx(65.0)
    least_ms = sum(yardstick.bound(*yardstick.nn1_work(q, r))["bound_ms"] for q, r in ctx["metric_rows"])
    assert metric_nn1_roofline.read(ctx) == pytest.approx(100 * least_ms * 1e3 / 30)
    assert metric_nn1_roofline.read({"host_trace": None}) is None


def test_kernel_names_are_the_programs():
    names = harness.kernel_names()
    assert {"nn1_kernel", "fps_kernel", "field_cull_kernel", "field_keys_kernel", "field_dot_kernel"} <= set(names)
    assert "__launch_bounds__" not in names
