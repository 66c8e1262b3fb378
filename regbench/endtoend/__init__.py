"""End-to-end metric readers, one module each, found by the metric's name in
BENCHMARK.json. A reader's `read(window)` returns the metric's value from
the untraced run's window: "pairs" (of whole calls), "seconds" (from the
first call's hand-off to the last call's answers on the host),
"pair_latencies_ms" (each pair's call's latency, a value a pair) and
"setup_s"."""
