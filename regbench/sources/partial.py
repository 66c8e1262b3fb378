"""Partial-overlap pairs, the RGB-D analogue of challenge.py's
`partial_corpus`: two independent samplings of one procedural instance
(superellipsoid, surface of revolution, box assembly, helical tube), each
cropped by its own random half-space to a kept share, with Gaussian sensor
noise and uniform outliers on both sides; the source then moved by a hard
similarity (three axis angles, a scale, a diagonal shift).

Every call holds batch / 4 pairs of each family, half of them at each kept
share of the mix, and one value of each pose range's strata a pair. A pool
fixes every draw.
"""

from __future__ import annotations

import numpy as np

from regbench.generate import Pair, rng_of, stratified
from regbench.sources._shapes import FAMILIES, instance, rot_xyz


def _crop(pts: np.ndarray, rng: np.random.Generator, keep: float) -> np.ndarray:
    normal = rng.normal(size=3)
    normal /= np.linalg.norm(normal)
    score = pts @ normal
    return pts[score <= np.quantile(score, keep)]


def _noisy(pts: np.ndarray, rng: np.random.Generator, noise: float, outlier_frac: float) -> np.ndarray:
    pts = pts + rng.normal(scale=noise, size=pts.shape)
    return np.concatenate([pts, rng.uniform(-1, 1, (int(outlier_frac * len(pts)), 3))], axis=0)


def make_calls(config, mix, seed, pool=None):
    n, pose, keeps = mix["batch"], mix["pose"], mix["keep"]
    fams = len(FAMILIES)
    if n % (fams * len(keeps)):
        raise ValueError(f"batch {n} is not a multiple of {fams} families x {len(keeps)} kept shares")
    calls = []
    for c in range(mix["calls"]):
        rng = rng_of(seed if pool is None else pool, c)
        slots = [(f, keeps[i % len(keeps)]) for f in range(fams) for i in range(n // fams)]
        slots = [slots[i] for i in rng.permutation(n)]
        angles = [stratified(rng, n, *pose["angle"]) for _ in range(3)]
        scale = stratified(rng, n, *pose["scale"], log=True)
        shift = stratified(rng, n, *pose["shift"])
        pairs = []
        for j, (f, keep) in enumerate(slots):
            idx = int(rng.integers(2 ** 31))
            tgt = instance(f, idx, mix["points"], sample=0)
            base = instance(f, idx, mix["points"], sample=1)
            tgt = _noisy(_crop(tgt, rng, keep), rng, mix["noise"], mix["outlier_frac"])
            base = _noisy(_crop(base, rng, keep), rng, mix["noise"], mix["outlier_frac"])
            rot = rot_xyz(angles[0][j], angles[1][j], angles[2][j])
            t = np.full(3, shift[j])
            src = ((base @ rot.T) * scale[j] + t).astype(np.float32)
            pairs.append(Pair(f"{FAMILIES[f][0]}{idx}@{keep:g}/{c}.{j}", src, tgt.astype(np.float32),
                              {"R": rot, "s": float(scale[j]), "t": t}))
        calls.append(pairs)
    return calls
