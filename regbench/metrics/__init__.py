"""Per-layer metric readers, one module each, found by the metric's name in
BENCHMARK.json. A reader's `read(ctx)` returns the metric's value, or None
where its run holds nothing to read, and the harness then leaves the metric
out of the result line.

`ctx` holds what a traced run recorded:
  "spans"          seconds by stage, from the timed window (regbench/spans.py:
                   synced stage spans through the program's `timer=` hook,
                   or the benchmark's own spans around the program's calls);
  "pairs", "calls" the pairs and calls of that window;
  "counters"       the program's counters, their growth over that window;
  "trace"          the device's events, traced alone over a short sub-window
                   after it, as chrome-trace dicts (regbench/yardstick.py),
                   or None;
  "trace_pairs", "trace_calls", "trace_window_s"  that sub-window's pairs,
                   calls and host seconds;
  "busy_s"         the device's busy seconds in that sub-window;
  "host_trace"     the host's and the device's events over a second
                   sub-window of as many calls, with the benchmark's spans;
  "metric_rows"    (valid source rows, valid target rows) of every pair's
                   full-resolution metric in the second sub-window;
  "kernel_names"   the program's own kernels, by function name.
"""


def span_ms(ctx, *stages):
    """The stages' seconds a pair, in ms: 0.0 where the window ran none of
    them, None where the run has no spans."""
    if "spans" not in ctx or not ctx.get("pairs"):
        return None
    return 1e3 * sum(ctx["spans"].get(s, 0.0) for s in stages) / ctx["pairs"]
