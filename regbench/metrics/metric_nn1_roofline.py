"""The full-resolution metric's `nn1` launches against their roofline, in %:
the least time of an exact brute-force 1-NN of every pair's valid source rows
against its valid target rows (yardstick.nn1_work: 9 float32 operations a
pair of points over 67e12/s, or the bytes once over 3.35 TB/s, the larger)
over the device time of the `nn1` kernels launched inside the benchmark's
"metric" span, in the sub-window traced with the host. The counts come from
the inputs, so they are the same whatever kernel does the work."""

from regbench.yardstick import bound, kernels_launched_in, nn1_work


def read(ctx):
    if not ctx.get("host_trace") or not ctx.get("metric_rows"):
        return None
    device_us = sum(float(e["dur"]) for e in kernels_launched_in(ctx["host_trace"], "regbench.metric")
                    if "nn1" in e["name"])
    if device_us <= 0:
        return None
    least_ms = sum(bound(*nn1_work(q, r))["bound_ms"] for q, r in ctx["metric_rows"])
    return 100.0 * least_ms * 1e3 / device_us
