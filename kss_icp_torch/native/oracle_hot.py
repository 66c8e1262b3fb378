"""ctypes bindings over oracle_hot.cpp (port of kss_icp_tpu/native/oracle_hot.py):
the native rotation scan and ICP of the CPU oracle (kss_icp_torch/oracle.py),
with JAX's entry points and C symbols.

oracle_hot.cpp is compiled by g++ at first use into `kss_icp_torch/_build/`
with the native reader's helper (native/__init__.py::build) and JAX's g++
flags, so both packages' libraries compute the same bits. Where JAX's
bindings return None from a failed build and leave the caller to check
`available()`, here a failed build raises NativeBuildError from every entry
point; `available()` still answers False for callers that ask first.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import numpy as np

from kss_icp_torch.native import NativeBuildError, build

SRC = Path(__file__).resolve().parent / "oracle_hot.cpp"
# kss_icp_tpu/native/oracle_hot.py:29-30.
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")

_D = ctypes.POINTER(ctypes.c_double)
_F = ctypes.POINTER(ctypes.c_float)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded library, built on first call."""
    lib = ctypes.CDLL(str(build(SRC, flags=GXX_FLAGS)))
    lib.ksstpu_kd_build.restype = ctypes.c_void_p
    lib.ksstpu_kd_build.argtypes = [_F, ctypes.c_int]
    lib.ksstpu_kd_free.restype = None
    lib.ksstpu_kd_free.argtypes = [ctypes.c_void_p]
    lib.ksstpu_mean_nn.restype = ctypes.c_double
    lib.ksstpu_mean_nn.argtypes = [ctypes.c_void_p, _F, ctypes.c_int]
    lib.ksstpu_rotation_scan.restype = ctypes.c_int
    lib.ksstpu_rotation_scan.argtypes = [_F, ctypes.c_int, ctypes.c_void_p, ctypes.c_double, _D]
    lib.ksstpu_icp.restype = ctypes.c_int
    lib.ksstpu_icp.argtypes = [_F, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                               ctypes.c_double, ctypes.c_double, _D, _D, ctypes.POINTER(ctypes.c_int)]
    return lib


def available() -> bool:
    """True where the library builds and loads."""
    try:
        library()
    except (NativeBuildError, OSError):
        return False
    return True


def _as_f32(pts: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(pts), dtype=np.float32)


class NativeKDTree:
    """RAII wrapper over the C++ median-split tree (FLANN's role)."""

    def __init__(self, points: np.ndarray):
        lib = library()
        self._lib = lib
        p = _as_f32(points)
        self.n = len(p)
        self._handle = lib.ksstpu_kd_build(p.ctypes.data_as(_F), ctypes.c_int(self.n))

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.ksstpu_kd_free(self._handle)
            self._handle = None

    def mean_nn(self, pts: np.ndarray) -> float:
        p = _as_f32(pts)
        return float(self._lib.ksstpu_mean_nn(self._handle, p.ctypes.data_as(_F), ctypes.c_int(len(p))))


def rotation_scan(source: np.ndarray, tree: NativeKDTree, step: float) -> np.ndarray:
    """Native initRegistration_Rotation: returns the (n, n, n) error field
    (n = 9 at step 8 — the float-accumulation quirk, oracle.py:_scan)."""
    lib = library()
    src = _as_f32(source)
    # Replicate the angle enumeration to size the output buffer.
    inc, n, a = 6.3 / step, 0, 0.0
    while a < 6.3:
        n += 1
        a += inc
    field = np.empty((n, n, n), np.float64)
    got = lib.ksstpu_rotation_scan(src.ctypes.data_as(_F), ctypes.c_int(len(src)), tree._handle,
                                   ctypes.c_double(step), field.ctypes.data_as(_D))
    if got != n:
        raise RuntimeError(f"rotation_scan visited {got} angles an axis, the buffer holds {n}")
    return field


def icp_native(
    source: np.ndarray,
    tree: NativeKDTree,
    max_iterations: int = 1000,
    max_correspondence_distance: float = 1.0,
    transformation_epsilon: float = 1e-10,
    euclidean_fitness_epsilon: float = 0.001,
) -> Tuple[np.ndarray, float, int, bool]:
    """Native pcl_icp (oracle.py semantics). Returns
    (final 4x4, fitness, iterations, converged)."""
    lib = library()
    src = _as_f32(source)
    final = np.empty((4, 4), np.float64)
    fit = ctypes.c_double()
    conv = ctypes.c_int()
    it = lib.ksstpu_icp(
        src.ctypes.data_as(_F), ctypes.c_int(len(src)), tree._handle,
        ctypes.c_int(max_iterations),
        ctypes.c_double(max_correspondence_distance),
        ctypes.c_double(transformation_epsilon),
        ctypes.c_double(euclidean_fitness_epsilon),
        final.ctypes.data_as(_D), ctypes.byref(fit), ctypes.byref(conv))
    return final, float(fit.value), int(it), bool(conv.value)
