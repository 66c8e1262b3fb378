"""The benchmark's arithmetic, kept apart from the program: the H100's
published peaks, the least time of a piece of work, the work of an exact
brute-force 1-NN, the working point count of a pair, and the reductions of a
profiler trace (device busy time, the busiest device operations, the device's
idle gaps by what the host was doing).

A trace here is a list of chrome-trace events, dicts with "ph" "X", "cat",
"name", "ts" and "dur" in microseconds and, for kernels and runtime calls,
"args": {"correlation": id}: as torch.profiler's export_chrome_trace writes
them, or as `events_of` builds them from the profiler's events in memory.
"""

from __future__ import annotations

import bisect
import json
import tempfile
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

# One NVIDIA H100 SXM, dense, NVIDIA's data sheet: float32 outside the tensor
# cores, bf16 on them, HBM3.
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def bound(ops: float, nbytes: float, bf16_ops: float = 0.0) -> Dict:
    """The least time for the work: the larger of its operations over their
    peak and its bytes (inputs once, outputs once) over HBM."""
    t_ops = max(ops / FP32_OPS_PER_S, bf16_ops / BF16_OPS_PER_S) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def nn1_work(queries: int, refs: int) -> Tuple[float, float]:
    """(float32 operations, bytes) of an exact brute-force 1-NN of `queries`
    points against `refs`: three differences, three products, two sums and a
    min a pair; the points read once (12 bytes, and a mask byte a reference
    row), a squared distance and an index written a query."""
    return 9.0 * queries * refs, 12.0 * (queries + refs) + refs + 8.0 * queries


def resample_count(n_source: int, n_target: int, max_points: int = 2000) -> int:
    """The working point count of a pair, min(|S|, |T|) // 2 within [1,
    max_points] (KSS_ICP.hpp:57-66)."""
    return max(1, min(min(n_source, n_target) // 2, max_points))


def _device_events(trace: Iterable[Dict]) -> List[Dict]:
    return [e for e in trace if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def merged(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of intervals, as sorted disjoint intervals."""
    out: List[List[float]] = []
    for a, z in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], z)
        else:
            out.append([a, z])
    return [(a, z) for a, z in out]


def device_busy_us(trace: Iterable[Dict]) -> float:
    """Microseconds in which a kernel, a memcpy or a memset ran: the union
    of their intervals."""
    return sum(z - a for a, z in merged((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                                        for e in _device_events(trace)))


def device_ops(trace: Iterable[Dict], top: int = 10) -> List[List]:
    """The device operations that took most time: [[name, seconds], ...],
    summed by name, the longest first."""
    by_name: Dict[str, float] = defaultdict(float)
    for e in _device_events(trace):
        by_name[e["name"]] += float(e.get("dur", 0)) * 1e-6
    return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]


def kernel_us(trace: Iterable[Dict], names: Iterable[str]) -> float:
    """Device microseconds of the kernels whose name holds one of `names`."""
    names = tuple(names)
    return sum(float(e.get("dur", 0)) for e in trace
               if e.get("ph") == "X" and e.get("cat") == "kernel" and any(n in e["name"] for n in names))


def kernels_launched_in(trace: List[Dict], span: str) -> List[Dict]:
    """The kernels launched while the host was inside a user annotation named
    `span`: each kernel's runtime launch (the event of its correlation id on
    the host) starts within one of the span's intervals."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in trace
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("name") == span)
    starts = [a for a, _ in spans]

    def inside(t: float) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= spans[i][1]

    launched = {e["args"]["correlation"] for e in trace
                if e.get("ph") == "X" and e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})
                and inside(float(e["ts"]))}
    return [e for e in trace if e.get("ph") == "X" and e.get("cat") == "kernel"
            and e.get("args", {}).get("correlation") in launched]


def idle_gaps(trace: List[Dict], top: int = 10) -> List[List]:
    """The device's idle time between its operations, summed by what the host
    was doing when each gap opened: the benchmark span ("regbench."
    annotations) and the innermost host operation at that instant. Returns
    [[label, seconds], ...], the most idle first; a label ends with its gaps'
    count."""
    busy = merged((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in _device_events(trace))

    def intervals(keep):
        return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"]) for e in trace
                      if e.get("ph") == "X" and keep(e))

    def innermost(host, points):
        """For each sorted instant, the latest-started host interval that
        covers it (intervals on one thread nest), or None: one sweep."""
        out, stack, i = [], [], 0
        for t in points:
            while i < len(host) and host[i][0] <= t:
                while stack and stack[-1][1] < host[i][0]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            out.append(stack[-1][2] if stack else None)
        return out

    gaps = [(z, a) for (_, z), (a, _) in zip(busy, busy[1:])]
    points = [z for z, _ in gaps]
    stages = innermost(intervals(lambda e: e.get("cat") == "user_annotation" and e["name"].startswith("regbench.")),
                       points)
    ops = innermost(intervals(lambda e: e.get("cat") in ("cpu_op", "cuda_runtime")), points)
    sums: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)
    for (z, a), stage, op in zip(gaps, stages, ops):
        label = f"{(stage or 'outside spans').removeprefix('regbench.')} / {op or 'no host op'}"
        sums[label] += (a - z) * 1e-6
        counts[label] += 1
    return [[f"{k} ({counts[k]} gaps)", v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:top]]


def events_of(prof) -> List[Dict]:
    """A finished torch.profiler.profile's events as chrome-trace dicts, from
    its chrome trace written to a temporary file (under TMPDIR) and deleted:
    the export says each event's category in every PyTorch version, where the
    profiler's own event objects do not."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())["traceEvents"]
    return [e for e in trace if e.get("ph") == "X"]
