"""Content-hashed array cache (port of kss_icp_tpu/utils/cache.py): the
rebuild of the reference's file-level memoization (SURVEY.md §5.4): `.normal`
caches (pointPipeline.hpp:51-61), `.wlop`/`.gird` resample caches
(transferPC.hpp:153-180) and skip-if-exists conversions
(LoadPointCloud.hpp:186-191).

The reference keys caches on the *file name* only, so editing a cloud leaves
a stale cache, and it appends on re-save (ios::app), duplicating data. Here
a cache entry is keyed on sha256(array bytes + parameters), the JAX
package's key for the same arrays and parameters, so it can never go stale,
and entries are written atomically (tmp + rename). The default directory is
the port's own, so that neither package reads the other's entries:
$KSS_ICP_CACHE_DIR where it is set, as in the JAX package, else
~/.cache/kss_icp_torch."""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np

PathLike = Union[str, Path]

_DEFAULT_DIR = Path(
    os.environ.get("KSS_ICP_CACHE_DIR", Path.home() / ".cache" / "kss_icp_torch")
)


def content_key(*arrays: np.ndarray, **params) -> str:
    """Stable key over array contents (shape+dtype+bytes) and parameters."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    h.update(json.dumps(params, sort_keys=True, default=str).encode())
    return h.hexdigest()[:32]


class ArrayCache:
    """npz-backed memoization of named arrays under a content key."""

    def __init__(self, directory: Optional[PathLike] = None):
        self.dir = Path(directory) if directory else _DEFAULT_DIR

    def _path(self, key: str) -> Path:
        return self.dir / f"{key}.npz"

    def get(self, key: str) -> Optional[Dict[str, np.ndarray]]:
        path = self._path(key)
        if not path.exists():
            return None
        try:
            with np.load(path) as z:
                return {name: z[name] for name in z.files}
        except Exception:
            return None  # corrupt entry == miss

    def put(self, key: str, **arrays: np.ndarray) -> None:
        try:
            self.dir.mkdir(parents=True, exist_ok=True)
            # np.savez appends ".npz" unless the name already ends with it.
            fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp.npz")
            os.close(fd)
            np.savez(tmp, **arrays)
            os.replace(tmp, self._path(key))
        except OSError:
            pass  # cache is best-effort; unwritable dirs are not errors

    def memoize(self, fn, *arrays: np.ndarray, _names=("out",), **params):
        """Run fn(*arrays) unless a cached result exists. fn must return a
        tuple matching `_names`."""
        key = content_key(*arrays, fn=getattr(fn, "__name__", str(fn)), **params)
        hit = self.get(key)
        if hit is not None and set(_names) <= set(hit):
            return tuple(hit[n] for n in _names)
        out = fn(*arrays)
        if not isinstance(out, tuple):
            out = (out,)
        self.put(key, **dict(zip(_names, map(np.asarray, out))))
        return out
