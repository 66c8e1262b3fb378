"""Timing of calls on the card, for `chip_smoke.py` and the scripts.

Two ways, which measure different things and are reported under different
names: `time_ms` is a call made back to back, the host's cost of each call
included (what a loop of calls pays); `graph_ms` is the device time of the
calls replayed from one CUDA graph (the kernels' own time, which under about
0.05 ms a launch is less than a wrapper call's host work).
"""

from __future__ import annotations

from typing import Callable

import torch


def time_ms(fn: Callable[[], object], reps: int) -> float:
    """Mean milliseconds of fn() called `reps` times back to back, by CUDA
    events, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn: Callable[[], object], reps: int) -> float:
    """Mean device milliseconds of fn() replayed from one CUDA graph of
    `reps` calls, after a warm-up call on a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):  # the wrappers set kernel attributes
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
