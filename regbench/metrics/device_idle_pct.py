"""The device's idle share of the traced sub-window, in %: 100 less the
union of its kernel, memcpy and memset intervals over the sub-window's
host seconds."""


def read(ctx):
    if not ctx.get("trace") or not ctx.get("trace_window_s") or not ctx.get("busy_s"):
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["trace_window_s"])
