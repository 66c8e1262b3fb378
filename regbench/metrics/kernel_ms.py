"""Device milliseconds a pair in the program's own kernels (the `__global__`
functions of kss_icp_torch/csrc), from the traced sub-window."""

from regbench.yardstick import kernel_us


def read(ctx):
    if not ctx.get("trace") or not ctx.get("trace_pairs"):
        return None
    us = kernel_us(ctx["trace"], ctx["kernel_names"])
    return us / 1e3 / ctx["trace_pairs"] if us > 0 else None
