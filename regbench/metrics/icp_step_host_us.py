"""Host microseconds of a lockstep ICP iteration less its waits: each
"kss.icp.step" span's host time less the "kss.sync.*" spans inside it (the
stop test's read of the device's flag, and any other sync), averaged over the
steps of the sub-window traced with the host. The host's own work an
iteration: enqueueing its launches (inflated by the CPU profiler, the same on
both sides of a comparison)."""

from regbench import program_spans as ps


def read(ctx):
    trace = ps.program_trace(ctx)
    steps = ps.intervals(trace, ps.STEP)
    if not steps:
        return None
    host = sum(z - a for a, z in steps) - ps.overlap_us(steps, ps.intervals(trace, ps.SYNC))
    return host / len(steps)
