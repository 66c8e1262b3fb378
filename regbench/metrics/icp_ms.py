"""Milliseconds a pair in the screen and refine ICP stages, from the timed
window's spans."""

from regbench.metrics import span_ms


def read(ctx):
    return span_ms(ctx, "screen", "refine")
