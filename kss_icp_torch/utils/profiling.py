"""Per-stage timing and trace annotations (port of kss_icp_tpu/utils/profiling.py).

The reference's observability is clock() deltas printed to stdout
(initRegistrationKSS.hpp:66-70, Method_AIVS_SimPro.hpp:95,151-152,
Main_KSS_List.cpp:151-153). Here: a context-manager timer emitting JSON
lines, plus torch.profiler ranges that name a span in a profiler trace.

One difference from JAX: `trace_annotation` lets an exception in its body
propagate. JAX's version catches everything because jax's profiler may be
missing; torch.profiler.record_function is always present.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from typing import Dict


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
