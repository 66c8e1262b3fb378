"""Lockstep ICP loop passes a call, every stage's loops together: the growth
of the program's `icp.lockstep_iterations` counter over the timed window,
over its calls."""


def read(ctx):
    n = ctx.get("counters", {}).get("icp.lockstep_iterations")
    return None if n is None or not ctx.get("calls") else n / ctx["calls"]
