"""The native point-cloud reader (port of kss_icp_tpu/native/__init__.py):
ctypes bindings over fastio.cpp, a copy of kss_icp_tpu/native/fastio.cpp
(mmap'd text parsing, PLY, OFF and OBJ, a threaded batch loader and the
count-format writer).

fastio.cpp is compiled by g++ at first use into `kss_icp_torch/_build/`,
beside the CUDA library, under a name that carries a hash of the source and
flags; it is built in a temporary directory and renamed into place, so
processes that start together never load a half-written file.

One deliberate difference from JAX, which falls back to the Python readers
on any failure: a failed build raises NativeBuildError with the compiler's
output, so a broken toolchain shows. A file the parser refuses (a missing
file, a format it does not read: n < 0) still goes to the Python readers of
io/formats.py, as in JAX, and `load_points_native.refused` counts those
files (with `load_points_batch`'s).

The host helpers beside it serve the oracle's native twin (oracle_hot.py) and
the oracle's process pools: `build` with other flags, `cpu_model`, and
`map_spawned`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import numpy as np

SRC = Path(__file__).resolve().parent / "fastio.cpp"
BUILD = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
# The environment variables that cap numpy's BLAS threads in a worker process.
BLAS_THREADS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")

_DOUBLE_P = ctypes.POINTER(ctypes.c_double)


class NativeBuildError(RuntimeError):
    pass


def cpu_model() -> str:
    """The host CPU's model name, vendor, family and model number from
    /proc/cpuinfo ("unknown" and "?" for what it does not say)."""
    info = {}
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        text = ""
    for line in text.splitlines():
        key, _, value = line.partition(":")
        info.setdefault(key.strip(), value.strip())
    return (f"{info.get('model name', 'unknown')} ({info.get('vendor_id', '?')} family {info.get('cpu family', '?')} "
            f"model {info.get('model', '?')})")


def map_spawned(fn: Callable, items: Sequence, workers: Optional[int] = None) -> list:
    """[fn(item) for item in items] in a process pool started by `spawn` (safe
    after CUDA is initialised), `workers` processes (default: the cores this
    process may run on), each with one BLAS thread; the parent's environment
    is restored after."""
    import concurrent.futures
    import multiprocessing

    workers = workers or len(os.sched_getaffinity(0))
    saved = {k: os.environ.get(k) for k in BLAS_THREADS}
    os.environ.update({k: "1" for k in BLAS_THREADS})
    try:
        with concurrent.futures.ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
            return list(pool.map(fn, items))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def build(src: Path = SRC, out: Path = BUILD, flags: Sequence[str] = GXX_FLAGS) -> Path:
    """Compile `src` with g++ and `flags` into a shared library under `out`,
    named after the source's stem and a hash of the source and flags (and of
    the CPU model where the flags include -march=native, so that a checkout
    copied to another host builds its own), unless that library is there
    already; raise NativeBuildError with g++'s output if the build fails."""
    key = " ".join(flags) + (cpu_model() if "-march=native" in flags else "")
    digest = hashlib.sha256(key.encode() + src.read_bytes()).hexdigest()[:16]
    lib = out / f"libkss_{src.stem}_{digest}.so"
    if lib.exists():
        return lib
    out.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out) as tmp:
        so = Path(tmp) / lib.name
        cmd = ["g++", *flags, str(src), "-o", str(so)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise NativeBuildError(f"g++ did not run: {' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            raise NativeBuildError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}{proc.stdout}")
        os.replace(so, lib)
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded reader, built on first call."""
    lib = ctypes.CDLL(str(build()))
    lib.ksstpu_parse_points.restype = ctypes.c_long
    lib.ksstpu_parse_points.argtypes = [ctypes.c_char_p, ctypes.POINTER(_DOUBLE_P), ctypes.POINTER(ctypes.c_long)]
    lib.ksstpu_free.restype = None
    lib.ksstpu_free.argtypes = [_DOUBLE_P]
    lib.ksstpu_write_xyz.restype = ctypes.c_int
    lib.ksstpu_write_xyz.argtypes = [ctypes.c_char_p, _DOUBLE_P, ctypes.c_long]
    lib.ksstpu_parse_batch.restype = ctypes.c_int
    lib.ksstpu_parse_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_long, ctypes.POINTER(_DOUBLE_P),
                                       ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long)]
    return lib


def _take(lib, buf, n: int, cols: int) -> np.ndarray:
    """The first three columns of a parsed (n, cols) buffer, which is freed."""
    try:
        arr = np.ctypeslib.as_array(buf, shape=(n, cols)).copy() if n else np.zeros((0, cols))
    finally:
        lib.ksstpu_free(buf)
    return np.ascontiguousarray(arr[:, :3])


def load_points_native(path) -> Optional[np.ndarray]:
    """(N, 3) float64 points, or None where the parser refuses the file
    (counted in `load_points_native.refused`)."""
    lib = library()
    buf, cols = _DOUBLE_P(), ctypes.c_long(0)
    n = lib.ksstpu_parse_points(str(path).encode(), ctypes.byref(buf), ctypes.byref(cols))
    if n < 0:
        load_points_native.refused += 1
        return None
    return _take(lib, buf, n, cols.value)


load_points_native.refused = 0


def save_xyz_native(path, points: np.ndarray) -> bool:
    """Write a count-format .xyz with the native writer (%.6g, truncating);
    False where it cannot (not (N, 3), or an I/O error)."""
    pts = np.ascontiguousarray(np.asarray(points, np.float64))
    if pts.ndim != 2 or pts.shape[1] != 3:
        return False
    return library().ksstpu_write_xyz(str(path).encode(), pts.ctypes.data_as(_DOUBLE_P), pts.shape[0]) == 0


def load_points_batch(paths: Sequence) -> List[Optional[np.ndarray]]:
    """Load many files on the parser's threads: each (N, 3) float64, or None
    where the parser refuses the file (counted as in load_points_native)."""
    lib = library()
    count = len(paths)
    c_paths = (ctypes.c_char_p * count)(*[str(p).encode() for p in paths])
    bufs = (_DOUBLE_P * count)()
    ns = (ctypes.c_long * count)()
    cols = (ctypes.c_long * count)()
    lib.ksstpu_parse_batch(c_paths, count, bufs, ns, cols)
    out: List[Optional[np.ndarray]] = []
    for i in range(count):
        if ns[i] < 0:
            load_points_native.refused += 1
            out.append(None)
        else:
            out.append(_take(lib, bufs[i], ns[i], cols[i]))
    return out
