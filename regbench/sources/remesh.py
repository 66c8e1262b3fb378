"""Remesh pairs: the 25 committed Remesh/Advancing fixtures (WLOP-8000
targets against grid-simplified sources, transferPC.hpp:144-151), each
source brought back to its model's frame by its transfer.txt record and
posed again by a similarity drawn from the seed: one axis, an angle, a
scale about the centroid and a diagonal shift, from the mix's ranges.

The fixture files are the repo's own (the mix's `"fixture"` names them,
relative to the checkout's root), read only where their SHA-256 is the one
the mix records, so the yardstick's inputs cannot change under it.

Every call holds each fixture batch // 25 times and batch % 25 fixtures
drawn without repeats, and one value of each pose range's strata a pair,
so every seed makes the same kind of work in another order. A pool fixes
every draw.
"""

from __future__ import annotations

import hashlib
import io
import json
from pathlib import Path

import numpy as np

from regbench.generate import Pair, rng_of, stratified
from regbench.sources._shapes import axis_rotation_matrix, unapply_record

ROOT = Path(__file__).resolve().parents[2]


def _read(fixture, suffix: str) -> bytes:
    data = (ROOT / (fixture["path"] + suffix)).read_bytes()
    if hashlib.sha256(data).hexdigest() != fixture["sha256"][suffix]:
        raise ValueError(f"{fixture['path'] + suffix} is not the file the mix was set on (SHA-256 differs)")
    return data


def fixtures(fixture):
    """[(name, source in its model's frame (float64), target (float32))] of
    the mix's `"fixture"`: {"path": ..., "sha256": {".json": ..., ".npz": ...}}."""
    meta = json.loads(_read(fixture, ".json"))
    out = []
    with np.load(io.BytesIO(_read(fixture, ".npz"))) as z:
        for rec in meta:
            src = unapply_record(z[f"{rec['name']}_src"], rec["axis"], rec["angle"], rec["scale"], rec["translation"])
            out.append((rec["name"], src, np.asarray(z[f"{rec['name']}_tgt"], np.float32)))
    return out


def make_calls(config, mix, seed, pool=None):
    fx = fixtures(mix["fixture"])
    k, n, pose = len(fx), mix["batch"], mix["pose"]
    calls = []
    for c in range(mix["calls"]):
        rng = rng_of(seed if pool is None else pool, c)
        idx = np.concatenate([np.tile(np.arange(k), n // k), rng.choice(k, n % k, replace=False)])
        idx = rng.permutation(idx)
        axes = rng.permutation(np.resize(np.array(pose["axes"]), n))
        angle = stratified(rng, n, *pose["angle"])
        scale = stratified(rng, n, *pose["scale"], log=True)
        shift = stratified(rng, n, *pose["shift"])
        pairs = []
        for j in range(n):
            name, src0, tgt = fx[idx[j]]
            rot = axis_rotation_matrix(str(axes[j]), float(angle[j]))
            x = src0 @ rot.T
            # Scale about the rotated cloud's centroid, then a diagonal shift.
            t = (1.0 - scale[j]) * x.mean(axis=0) + shift[j]
            src = (scale[j] * x + t).astype(np.float32)
            pairs.append(Pair(f"{name}/{c}.{j}", src, tgt, {"R": rot, "s": float(scale[j]), "t": t}))
        calls.append(pairs)
    return calls
