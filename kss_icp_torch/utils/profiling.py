"""Per-stage timing and trace annotations (port of kss_icp_tpu/utils/profiling.py).

The reference's observability is clock() deltas printed to stdout
(initRegistrationKSS.hpp:66-70, Method_AIVS_SimPro.hpp:95,151-152,
Main_KSS_List.cpp:151-153). Here: a context-manager timer emitting JSON
lines, plus torch.profiler ranges that name a span in a profiler trace.

`span` is the port's own instrumentation: the pipeline's stages, each ICP
call, each lockstep iteration and each blocking host read of a device value
open one as a "kss.<name>" range while a torch.profiler session records, on
the clock of the profiler's device events, and enter the caller's `timer=`
hook where one is given. With no session recording, a span costs one check.

One difference from JAX: `trace_annotation` lets an exception in its body
propagate. JAX's version catches everything because jax's profiler may be
missing; torch.profiler.record_function is always present.
"""

from __future__ import annotations

import contextlib
import functools
import json
import sys
import time
from typing import Callable, Dict, Optional

import torch

# Whether a torch.profiler (or autograd profiler) session is recording.
_recording = torch._C._autograd._profiler_enabled


class StageTimer:
    """Collects named stage durations; optionally emits JSON lines."""

    def __init__(self, emit: bool = False, stream=sys.stderr):
        self.stages: Dict[str, float] = {}
        self.emit = emit
        self.stream = stream

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.stages[name] = self.stages.get(name, 0.0) + dt
            if self.emit:
                print(
                    json.dumps({"stage": name, "seconds": round(dt, 6)}),
                    file=self.stream,
                    flush=True,
                )

    def summary(self) -> Dict[str, float]:
        return dict(self.stages)


@contextlib.contextmanager
def trace_annotation(name: str):
    """A torch.profiler range named `name` around the body."""
    from torch.profiler import record_function

    with record_function(name):
        yield


def span(name: str, timer: Optional[Callable[[str], contextlib.AbstractContextManager]] = None):
    """A "kss.<name>" profiler range around the body while a profiler session
    records (`trace_annotation`), and nothing otherwise; in both cases the
    caller's `timer(name)` around the body where a timer is given."""
    if _recording():
        return _recorded(name, timer)
    return timer(name) if timer is not None else contextlib.nullcontext()


@contextlib.contextmanager
def _recorded(name: str, timer):
    with trace_annotation(f"kss.{name}"):
        if timer is None:
            yield
        else:
            with timer(name):
                yield


def spanned(name: str):
    """Decorate a function so that each call runs inside span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return run
    return wrap
