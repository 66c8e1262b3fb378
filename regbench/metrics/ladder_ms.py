"""Milliseconds a pair on the escalation ladder: the two-stage converge, the
16³ re-solve, the uncapped finisher and the three overlap rungs, from the
timed window's spans (0.0 where no pair climbed it)."""

from regbench.metrics import span_ms

STAGES = ("two_stage", "escalate", "finish", "overlap8", "overlap16", "overlap_screen")


def read(ctx):
    return span_ms(ctx, *STAGES)
