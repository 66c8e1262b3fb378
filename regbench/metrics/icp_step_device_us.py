"""Device microseconds of a lockstep ICP iteration: the kernels launched
while the host was inside a "kss.icp.step" span (yardstick.
kernels_launched_in), over the steps of the sub-window traced with the
host. None where the trace holds no kernel (a CPU run)."""

from regbench import program_spans as ps
from regbench.yardstick import kernels_launched_in


def read(ctx):
    trace = ps.program_trace(ctx)
    steps = ps.intervals(trace, ps.STEP)
    if not steps or not any(e.get("cat") == "kernel" for e in trace):
        return None
    return sum(float(e.get("dur", 0)) for e in kernels_launched_in(trace, ps.STEP)) / len(steps)
