"""Room scan pairs, largescan.py's `room_pair`: two independent scans of one
procedural room (a floor, four walls, 8-14 cuboids; area-proportional
samples), the source moved by a rigid pose, both with Gaussian sensor noise.
Each call is one scan pair of its own room; the scan size is the
configuration's.

A pool fixes the rooms; the run's seed always draws the poses: each of the
three angles and of the three shifts from its range in the mix (around
room_pair's pose), one value of each range's strata a call.
"""

from __future__ import annotations

import numpy as np

from regbench.generate import Pair, rng_of, stratified
from regbench.sources._shapes import room_scene, rot_xyz


def make_calls(config, mix, seed, pool=None):
    n, pose = mix["calls"], mix["pose"]
    rng = rng_of(seed, 2 ** 32 + 1)
    angles = np.stack([stratified(rng, n, lo, hi) for lo, hi in pose["angles"]], axis=1)
    shifts = np.stack([stratified(rng, n, lo, hi) for lo, hi in pose["shift"]], axis=1)
    calls = []
    for c in range(n):
        room = int(rng_of(seed if pool is None else pool, c).integers(2 ** 62))
        rng = rng_of(seed, c, 1)
        rot, t = rot_xyz(*angles[c]), shifts[c]
        tgt = room_scene(config["points"], room, sample=0)
        base = room_scene(config["points"], room, sample=1)
        src = base @ rot.T + t + rng.normal(scale=mix["noise"], size=base.shape)
        tgt = tgt + rng.normal(scale=mix["noise"], size=tgt.shape)
        calls.append([Pair(f"room{room}/{c}", src.astype(np.float32), tgt.astype(np.float32),
                           {"R": rot, "s": 1.0, "t": t})])
    return calls
