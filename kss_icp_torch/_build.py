"""Build and load the port's CUDA kernels.

Every `kss_icp_torch/csrc/*.cu` is compiled by nvcc, at first use, into one
shared library with a plain C interface under `kss_icp_torch/_build/`, and
loaded with ctypes: one nvcc process per source, all started together, then
one link. The library's file name carries a hash of the sources and flags, so
an edit to any source rebuilds it. nvcc is found through `CUDA_HOME`, then
`PATH`, then PyTorch's own CUDA_HOME lookup. A failed build raises with
nvcc's output. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
    # No FMA contraction: every distance rounds as the plain version's
    # separate multiply and add do, so argmin/argmax picks agree.
    "-fmad=false", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (pointers, ints, then the stream).
SIGNATURES = {
    "kss_nn1": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    "kss_fps": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    "kss_field_ave": (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P),
    "kss_field_dot": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
    "kss_field_trim": (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P),
    "kss_field_sq": (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P),
}


class BuildError(RuntimeError):
    pass


def find_nvcc() -> str:
    root = os.environ.get("CUDA_HOME")
    if root and (Path(root) / "bin" / "nvcc").exists():
        return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise BuildError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources(csrc: Path) -> list[Path]:
    return sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))


def source_hash(csrc: Path = CSRC) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(csrc):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(csrc: Path = CSRC, out: Path = BUILD) -> tuple[Path, str, float]:
    """Compile the `*.cu` files of `csrc` into one library under `out`, if
    their hash is not built yet (the defaults are the package's own kernels).

    Returns (library path, nvcc's output, build seconds; 0 when cached)."""
    lib = out / f"libkss_kernels_{source_hash(csrc)}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        return lib, log.read_text() if log.exists() else "", 0.0
    out.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    # Build in a temporary directory, then rename the log and the library into
    # place, the library last: a process that starts while another builds
    # builds too, in its own directory, and none loads or reads a half-written
    # file (a library already loaded keeps its file when another replaces it).
    with tempfile.TemporaryDirectory(dir=out) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sorted(csrc.glob("*.cu"))]
        output = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(csrc / f"{o.stem}.cu")]
                           for o in objs], tmp)
        so = Path(tmp) / lib.name
        output += _run_all([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                             "-o", str(so), *map(str, objs)]], tmp)
        tmp_log = Path(tmp) / log.name
        tmp_log.write_text(output)
        os.replace(tmp_log, log)
        os.replace(so, lib)
    return lib, output, time.perf_counter() - t0


def _run_all(cmds: list[list[str]], logdir: str) -> str:
    """Run the commands at once, each writing to a file in `logdir`, and wait
    for all of them; raise with the output of the first that failed, else
    return their joined output."""
    logs = [Path(logdir) / f"nvcc_{i}.txt" for i in range(len(cmds))]
    procs = []
    try:
        for cmd, log in zip(cmds, logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT))
        codes = [proc.wait(timeout=600) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    outputs = [log.read_text() for log in logs]
    for cmd, code, output in zip(cmds, codes, outputs):
        if code != 0:
            raise BuildError(f"nvcc failed ({code}):\n{' '.join(cmd)}\n{output}")
    return "".join(outputs)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.kss_error_string.argtypes = [ctypes.c_int]
    lib.kss_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        msg = library().kss_error_string(code)
        raise RuntimeError(f"{name}: CUDA error {code}: {msg.decode() if msg else '?'}")
