"""The benchmark's stage timer: the `timer=` hook the program's entries take
(register_many enters it around each of its stages) and the spans the
benchmark puts around the program's calls itself.

Each stage is a profiler range named "regbench.<stage>" (so a trace can say
what the host was doing), and, with timed=True, a host-clock span whose ends
wait for the device (`torch.cuda.synchronize()`), so that it times the
stage's work and not its enqueue (on a CPU device, which the tests use,
there is nothing to wait for).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class Spans:
    def __init__(self, timed: bool, device):
        import torch

        self._record = torch.profiler.record_function
        self._wait = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
        self.timed = timed
        self.seconds = defaultdict(float)

    @contextlib.contextmanager
    def __call__(self, name: str):
        with self._record(f"regbench.{name}"):
            if self.timed:
                self._wait()
            t0 = time.perf_counter()
            yield
            if self.timed:
                self._wait()
                self.seconds[name] += time.perf_counter() - t0
