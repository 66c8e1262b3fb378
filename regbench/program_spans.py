"""The program's own spans in the sub-window traced with the host: the
"kss." profiler ranges that kss_icp_torch opens while a profiler records
(kss_icp_torch/utils/profiling.py::span), read from the chrome-trace events
of regbench/yardstick.py. "kss.icp.step" is one lockstep ICP iteration;
"kss.sync.<site>" a blocking host read of a device value (or a blocking copy
to the device) inside it or anywhere else on the path. A trace without any
"kss." span is a program that opens none, and every reader then returns
None.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from regbench.yardstick import merged

PREFIX = "kss."
STEP = "kss.icp.step"
SYNC = "kss.sync."


def intervals(trace, prefix: str) -> List[Tuple[float, float]]:
    """(start, end) in microseconds of the host spans whose name is `prefix`
    or starts with it when it ends in a dot, sorted."""
    def named(name: str) -> bool:
        return name.startswith(prefix) if prefix.endswith(".") else name == prefix

    return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in trace or ()
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation" and named(e.get("name", "")))


def overlap_us(spans: List[Tuple[float, float]], holes: List[Tuple[float, float]]) -> float:
    """Microseconds of `spans` (sorted, disjoint) covered by `holes`."""
    holes = merged(holes)
    total, j = 0.0, 0
    for a, z in spans:
        while j < len(holes) and holes[j][1] <= a:
            j += 1
        k = j
        while k < len(holes) and holes[k][0] < z:
            total += min(z, holes[k][1]) - max(a, holes[k][0])
            k += 1
    return total


def program_trace(ctx: Dict) -> Optional[list]:
    """The host-traced sub-window's events where the program opened spans in
    it, else None."""
    trace = ctx.get("host_trace")
    return trace if intervals(trace, PREFIX) else None


def pairs(ctx: Dict) -> int:
    """The host-traced sub-window's pairs: one metric row a pair."""
    return len(ctx.get("metric_rows") or ())
