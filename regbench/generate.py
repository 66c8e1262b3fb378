"""The one traffic generator: reads a mix's data file and makes its calls.

A mix (`regbench/traffic/<name>.json`) names a pair source (`"source"`: a
module `regbench/sources/<source>.py`), the entry it drives (`"entry"`: a
module `regbench/entries/<entry>.py`), the pairs a call hands the entry
(`"batch"`), how many distinct calls the set-up makes and the window cycles
through (`"calls"`), and the source's parameters. Every call is made on the
host before the window opens; the same seed gives the same calls, array for
array.

With a `"pool"` key the source makes the window's pairs from the pool's
number (each source says what the pool fixes and what the seed still draws),
and the run's seed deals them: the order of the pairs in each call. The
calls keep the pool's order in the cycle, so every seed's window holds the
same calls in the same sequence, the same work in another order: the
program is host-bound and a call runs as long as its slowest pair's lanes,
so a few calls of a cycle take four to six times as long as the rest, and a
window whose last, partial cycle held other calls for another seed would
change its rate by more than the host's own noise does; pairs drawn afresh
from each seed would change it more still. The check after the window adds
`"fresh_calls"` calls whose pairs the seed draws afresh (fresh_calls), so
the limits of `correct` also hold on inputs that no pool fixes.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, NamedTuple

import numpy as np


class Pair(NamedTuple):
    """One registration request: float32 source and target clouds, and the
    ground truth the source was made with, source = s * R @ x + t for x in
    the target's frame (R (3, 3), s, t (3,) in float64)."""

    name: str
    src: np.ndarray
    tgt: np.ndarray
    truth: Dict


def rng_of(seed: int, *keys: int) -> np.random.Generator:
    """A generator from the run's seed (any whole number) and sub-keys."""
    return np.random.default_rng([seed % 2 ** 64, *keys])


def stratified(rng: np.random.Generator, n: int, lo: float, hi: float, log: bool = False) -> np.ndarray:
    """n draws over [lo, hi), one in each of n equal strata, in random order:
    every call gets the same spread of values, so no seed gets easier work."""
    u = (rng.permutation(n) + rng.uniform(size=n)) / n
    if log:
        return np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))
    return lo + u * (hi - lo)


def make_calls(config: Dict, mix: Dict, seed: int) -> List[List[Pair]]:
    """The mix's calls for this seed: a list of `mix["calls"]` lists of
    `mix["batch"]` pairs each."""
    source = importlib.import_module(f"regbench.sources.{mix['source']}")
    calls = source.make_calls(config, mix, seed, mix.get("pool"))
    if "pool" in mix:
        rng = rng_of(seed, 2 ** 32)
        calls = [[c[i] for i in rng.permutation(len(c))] for c in calls]
    if len(calls) != mix["calls"] or any(len(c) != mix["batch"] for c in calls):
        raise ValueError(f"source {mix['source']} made {[len(c) for c in calls]} pairs a call, "
                         f"the mix asks for {mix['calls']} calls of {mix['batch']}")
    return calls


def fresh_calls(config: Dict, mix: Dict, seed: int) -> List[List[Pair]]:
    """The check's `mix["fresh_calls"]` calls of `mix["batch"]` pairs, every
    pair drawn afresh from the seed and none from the pool."""
    n = mix.get("fresh_calls", 0)
    if not n:
        return []
    source = importlib.import_module(f"regbench.sources.{mix['source']}")
    return source.make_calls(config, dict(mix, calls=n), seed, None)
