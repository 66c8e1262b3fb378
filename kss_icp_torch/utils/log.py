"""Structured JSON-lines event logging (port of kss_icp_tpu/utils/log.py):
the observability upgrade over the reference's `cout` progress strings and
stdout tables (SURVEY.md §5.5: "initRegistration start.", per-kernel scores
at KSS_ICP.hpp:112, clock() deltas at Main_KSS_List.cpp:151-179).

Each event is one JSON object per line: {"ts": ..., "event": ..., **fields},
the JAX package's events, so downstream tooling can diff runs of either
package. The CLI's --log-json writes them."""

from __future__ import annotations

import json
import sys
import time
from contextlib import contextmanager
from pathlib import Path
from typing import IO, Optional, Union

PathLike = Union[str, Path]


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except TypeError:
        try:
            import numpy as np

            if isinstance(v, np.ndarray):
                return v.tolist()
            if isinstance(v, np.generic):
                return v.item()
        except ImportError:
            pass
        return str(v)


class JsonlLogger:
    """Append-only JSON-lines event stream (file path or open stream)."""

    def __init__(self, sink: Union[PathLike, IO, None] = None):
        if sink is None:
            self._stream, self._own = sys.stderr, False
        elif hasattr(sink, "write"):
            self._stream, self._own = sink, False
        else:
            self._stream, self._own = open(sink, "a"), True

    def emit(self, event: str, **fields) -> None:
        rec = {"ts": time.time(), "event": event}
        rec.update({k: _jsonable(v) for k, v in fields.items()})
        self._stream.write(json.dumps(rec) + "\n")
        self._stream.flush()

    @contextmanager
    def stage(self, name: str, **fields):
        """Emit <name>.start / <name>.end events with the wall duration."""
        self.emit(f"{name}.start", **fields)
        t0 = time.perf_counter()
        try:
            yield
        except Exception as e:
            self.emit(f"{name}.error", seconds=time.perf_counter() - t0,
                      error=repr(e), **fields)
            raise
        self.emit(f"{name}.end", seconds=time.perf_counter() - t0, **fields)

    def close(self) -> None:
        if self._own:
            self._stream.close()


_default: Optional[JsonlLogger] = None


def get_logger() -> JsonlLogger:
    """Process-wide default logger (stderr)."""
    global _default
    if _default is None:
        _default = JsonlLogger()
    return _default
