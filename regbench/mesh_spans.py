"""The mesh's spans in the sub-window traced with the host, on rank 0 (the
benchmark's own process): "kss.mesh.slice", the rank's own slice of a
register_many call over a "pairs" mesh (its escalation ladder included), and
"kss.mesh.gather", the all-gathers of the result
(kss_icp_torch/parallel/batch.py::_over_pairs), one of each a call. NCCL may
launch its kernels through the driver API (cuLaunchKernelEx) rather than
the runtime's, so a kernel is linked to the span it was launched in by its
correlation id through either's events. A trace without a "kss.mesh." span
is a program that opens none, and the readers of these spans then return
None.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from regbench import program_spans as ps

SLICE = "kss.mesh.slice"
GATHER = "kss.mesh.gather"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def spans(ctx: Dict, name: str) -> List[Tuple[float, float]]:
    """(start, end) in microseconds of the host-traced sub-window's spans
    named `name`, sorted."""
    return ps.intervals(ctx.get("host_trace"), name)


def kernels_launched_in(trace: List[Dict], spans_: List[Tuple[float, float]]) -> List[Dict]:
    """The kernels whose launch (a runtime or driver API event of the same
    correlation id) starts within one of `spans_` (sorted, disjoint)."""
    starts = [a for a, _ in spans_]

    def inside(t: float) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= spans_[i][1]

    launched = {e["args"]["correlation"] for e in trace
                if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})
                and inside(float(e["ts"]))}
    return [e for e in trace if e.get("ph") == "X" and e.get("cat") == "kernel"
            and e.get("args", {}).get("correlation") in launched]


def nccl_in_gathers(ctx: Dict) -> Optional[Tuple[List[Dict], int]]:
    """(the NCCL kernels launched inside "kss.mesh.gather" spans, the number
    of those spans), or None where the trace holds no gather span or no NCCL
    kernel at all (a run on the CPU, over gloo)."""
    gathers = spans(ctx, GATHER)
    trace = ctx.get("host_trace") or []
    if not gathers or not any(e.get("cat") == "kernel" and "nccl" in e.get("name", "").lower() for e in trace):
        return None
    return [e for e in kernels_launched_in(trace, gathers) if "nccl" in e["name"].lower()], len(gathers)
