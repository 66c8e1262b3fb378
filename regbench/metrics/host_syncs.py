"""Host-device syncs a pair: the program's "kss.sync.*" spans in the
sub-window traced with the host, over its pairs. A lockstep ICP stop test is
one sync for every lane of the batch."""

from regbench import program_spans as ps


def read(ctx):
    trace = ps.program_trace(ctx)
    if trace is None or not ps.pairs(ctx):
        return None
    return len(ps.intervals(trace, ps.SYNC)) / ps.pairs(ctx)
