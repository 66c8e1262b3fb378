"""Host milliseconds a pair inside the program's "kss.sync.*" spans (their
union) in the sub-window traced with the host: the time the host waited on
the device."""

from regbench import program_spans as ps
from regbench.yardstick import merged


def read(ctx):
    trace = ps.program_trace(ctx)
    if trace is None or not ps.pairs(ctx):
        return None
    return sum(z - a for a, z in merged(ps.intervals(trace, ps.SYNC))) / 1e3 / ps.pairs(ctx)
