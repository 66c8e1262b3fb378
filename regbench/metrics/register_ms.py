"""Milliseconds a pair in the "register" stage, from the timed window's spans."""

from regbench.metrics import span_ms


def read(ctx):
    return span_ms(ctx, "register")
