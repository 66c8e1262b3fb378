"""Milliseconds a call that the slowest rank's slice of a register_many call
over the "pairs" mesh takes beyond the ranks' mean slice: how long a
typical rank waits for the slowest, the time the mesh loses to imbalance. Each rank times its own "mesh.slice" on the host's clock and
sends the seconds with its digest (regbench/entries/register_many_mesh.py);
the mean over every call of the run after the warm-up (the timed window and
the traced sub-windows). None where no rank timed a slice: a program whose
mesh opens no "mesh.slice"."""

from regbench.entries import register_many_mesh


def read(ctx):
    waits = register_many_mesh.WAITS
    return 1e3 * sum(waits) / len(waits) if waits else None
