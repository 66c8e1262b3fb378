"""Procedural challenge corpora, without jax: the port's copy of the
generators of kss_icp_tpu/challenge.py and of `rot_xyz` (kss_icp_tpu/stress.py:31).

The JAX package's modules are pure numpy but cannot be imported where jax is
absent, because kss_icp_tpu/__init__.py imports jax. This copy keeps the
five boards, their helpers and `transform_rmse`, array for array
(tests/test_torch_challenge.py holds them to the JAX module):

  category_corpus()  CAD-like parametric families (superellipsoids, surfaces
                     of revolution, box assemblies, helical tubes); a pair is
                     two independent samplings of one instance, the source
                     moved by a hard similarity (the ModelNet40 protocol);
  partial_corpus()   both sides cropped by different half-spaces, with sensor
                     noise and outliers (the RGB-D analogue); keep=0.8 is the
                     hard tier, about 60% overlap;
  deform_corpus()    a smooth non-rigid displacement on the target side (the
                     SHREC analogue);
  scale_corpus()     the category protocol at scales 0.3x and 3x.

Every pair carries its ground-truth similarity; success is the pose error
`transform_rmse` against BOARDS' thresholds.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np


def rot_xyz(ax: float, ay: float, az: float) -> np.ndarray:
    """Rz(az) @ Ry(ay) @ Rx(ax) in float64 (kss_icp_tpu/stress.py:31-38)."""
    cx, sx = np.cos(ax), np.sin(ax)
    cy, sy = np.cos(ay), np.sin(ay)
    cz, sz = np.cos(az), np.sin(az)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx


Pair = Tuple[str, np.ndarray, np.ndarray, Dict]

# Hard ground-truth perturbations (rx, ry, rz, scale, shift) — the stress
# corpus regime: compound 3-axis rotations + anisotropic-free scale.
_PERTURB = [
    (2.8, 1.9, 0.9, 1.7, 0.4),
    (3.1, 0.7, 2.4, 0.6, -0.8),
    (1.4, 2.9, 1.8, 2.3, 1.2),
    (0.6, 1.3, 2.7, 1.1, -0.3),
    (2.1, 2.5, 0.4, 0.8, 0.9),
]


def _unit_normalize(pts: np.ndarray) -> np.ndarray:
    """Center + scale into [-1, 1]^3 (PointCloud_Uniform semantics,
    LoadPointCloud.hpp:347-427)."""
    pts = pts - pts.mean(axis=0)
    m = np.abs(pts).max()
    return (pts / max(m, 1e-12)).astype(np.float32)


# --- Parametric families ----------------------------------------------------

def _superellipsoid(rng: np.random.Generator, n: int) -> np.ndarray:
    """Radial-projection sampling of a superellipsoid; exponents span the
    box-to-pinched spectrum (the ModelNet40 'cup/bottle/box' regime)."""
    e1 = float(rng.uniform(0.3, 1.6))
    e2 = float(rng.uniform(0.3, 1.6))
    abc = rng.uniform(0.4, 1.0, (3,))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    x, y, z = d[:, 0] / abc[0], d[:, 1] / abc[1], d[:, 2] / abc[2]
    f = (np.abs(x) ** (2 / e2) + np.abs(y) ** (2 / e2)) ** (e2 / e1) \
        + np.abs(z) ** (2 / e1)
    lam = f ** (-e1 / 2.0)
    return _unit_normalize(d * lam[:, None])


def _revolution(rng: np.random.Generator, n: int) -> np.ndarray:
    """Surface of revolution from a random smooth positive profile (the
    'vase/lamp' family). z sampled with density ∝ r(z) so wide sections
    are not undersampled."""
    k = np.arange(1, 5)
    coef = rng.normal(scale=0.25 / k)
    phase = rng.uniform(0, 2 * np.pi, 4)
    zs = np.linspace(-1, 1, 512)

    def r_of(z):
        return 0.55 + np.sum(coef * np.sin(np.outer(z, k) + phase), axis=-1).clip(-0.4, 0.6)

    w = r_of(zs)
    w = np.maximum(w, 0.05)
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    z = np.interp(rng.uniform(0, 1, n), cdf, zs)
    r = np.maximum(r_of(z), 0.05)
    th = rng.uniform(0, 2 * np.pi, n)
    return _unit_normalize(
        np.stack([r * np.cos(th), r * np.sin(th), z], axis=-1))


def _box_assembly(rng: np.random.Generator, n: int) -> np.ndarray:
    """Union of axis-aligned cuboid shells — a flat top + 4 legs (the
    'table/chair' family). Faces sampled with probability ∝ area."""
    lwx = float(rng.uniform(0.55, 1.0))  # top half-extents (rectangular —
    lwy = float(rng.uniform(0.55, 1.0))  # a square top + equal legs is
    lh = float(rng.uniform(0.04, 0.12))  # 4-fold symmetric and the pose
    hh = float(rng.uniform(0.5, 0.9))    # becomes non-identifiable)
    boxes = [(np.array([0, 0, hh]), np.array([lwx, lwy, lh]))]
    for sx in (-1, 1):
        for sy in (-1, 1):
            leg = float(rng.uniform(0.05, 0.12))   # per-leg half-width
            ell = hh * float(rng.uniform(0.55, 1.0))  # per-leg length
            ox = sx * (lwx - leg - float(rng.uniform(0.0, 0.15)))
            oy = sy * (lwy - leg - float(rng.uniform(0.0, 0.15)))
            boxes.append((np.array([ox, oy, hh - lh - ell / 2]),
                          np.array([leg, leg, ell / 2])))
    areas = np.array([8 * (s[0] * s[1] + s[1] * s[2] + s[0] * s[2])
                      for _, s in boxes])
    counts = rng.multinomial(n, areas / areas.sum())
    # Point draws are sized by multinomial counts (data-dependent), so they
    # MUST come from the per-sample stream explicitly — the size heuristic
    # would route a sparse box's draw to the shared stream.
    point_rng = rng.sample if isinstance(rng, _SplitRNG) else rng
    parts = []
    for (c, s), m in zip(boxes, counts):
        # Pick a face ∝ its area, then uniform on it.
        fa = np.array([s[1] * s[2], s[1] * s[2], s[0] * s[2],
                       s[0] * s[2], s[0] * s[1], s[0] * s[1]])
        face = point_rng.choice(6, size=m, p=fa / fa.sum())
        u = point_rng.uniform(-1, 1, (m, 3)) * s
        axis = face // 2
        u[np.arange(m), axis] = np.where(face % 2 == 0, s[axis], -s[axis])
        parts.append(c + u)
    return _unit_normalize(np.concatenate(parts, axis=0))


def _tube(rng: np.random.Generator, n: int) -> np.ndarray:
    """Tube around a helical space curve (the 'pipe/spring' family)."""
    turns = float(rng.uniform(1.2, 2.8))
    rad = float(rng.uniform(0.5, 0.9))
    pitch = float(rng.uniform(0.3, 0.8))
    tube_r0 = float(rng.uniform(0.08, 0.18))
    taper = float(rng.uniform(0.4, 0.8))
    t = rng.uniform(0, 1, n) * turns * 2 * np.pi
    th = rng.uniform(0, 2 * np.pi, n)
    # Taper the tube radius along the curve: a constant-radius helix is
    # invariant under screw motion (rotate + slide along its axis), which
    # makes the pose non-identifiable.
    tube_r = tube_r0 * (1 + taper * t / (turns * 2 * np.pi))
    c = np.stack([rad * np.cos(t), rad * np.sin(t), pitch * t / np.pi], -1)
    # Frame: tangent + a normal pair (Frenet-lite; exact orthonormality
    # matters less than smoothness here).
    tan = np.stack([-np.sin(t), np.cos(t),
                    np.full_like(t, pitch / (np.pi * rad))], -1)
    tan /= np.linalg.norm(tan, axis=1, keepdims=True)
    n1 = np.stack([np.cos(t), np.sin(t), np.zeros_like(t)], -1)
    n2 = np.cross(tan, n1)
    pts = c + tube_r[:, None] * (
        np.cos(th)[:, None] * n1 + np.sin(th)[:, None] * n2)
    return _unit_normalize(pts)


FAMILIES = [("se", _superellipsoid), ("rev", _revolution),
            ("box", _box_assembly), ("tube", _tube)]


def _asymmetrize(pts: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Break the families' rotational/reflective symmetries with smooth
    Gaussian bumps — a deterministic function of position (parameters from
    the SHARED per-instance stream), so independent samplings of one
    instance deform identically. Without this the pose is non-identifiable
    (a revolution surface registers perfectly at any azimuth) and the
    pose-error success criterion is meaningless."""
    out = pts.astype(np.float64)
    for _ in range(4):
        c = rng.uniform(-0.8, 0.8, 3)
        sig = rng.uniform(0.2, 0.35)
        amp = rng.uniform(0.25, 0.4)
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        w = np.exp(-np.sum((out - c) ** 2, axis=1) / (2 * sig * sig))
        out = out + amp * w[:, None] * d
    return _unit_normalize(out)


def _instance(family: int, idx: int, n: int, sample: int) -> np.ndarray:
    """Deterministic sampling `sample` of instance `idx` of a family: the
    shape parameters derive from (family, idx) alone, the surface sample
    from (family, idx, sample) — two samples share the shape, not points."""
    name, gen = FAMILIES[family]
    shape_rng = np.random.default_rng(1000 * family + idx)
    params_seed = int(shape_rng.integers(2 ** 31))
    rng = np.random.default_rng((params_seed, sample))
    # Re-seed the generator stream: shape params must come from a stream
    # shared across samples, point draws from the per-sample stream.
    shared = np.random.default_rng(params_seed)
    gen_rng = _SplitRNG(shared, rng)
    surface = gen(gen_rng, n)
    # Symmetry-breaking warp: parameters from a dedicated per-instance
    # stream (NOT `shared` — the generators consume different numbers of
    # shared draws, and the warp must not depend on that).
    return _asymmetrize(surface, np.random.default_rng((params_seed, 99)))


class _SplitRNG:
    """RNG facade: parameter draws (uniform/normal scalars & small vectors)
    come from the SHARED per-instance stream; bulk point draws (size >= 64)
    from the per-sample stream — so two samplings of one instance agree on
    shape parameters but not on surface points.

    Generators must route POINT draws whose size is data-dependent (e.g.
    sized by a multinomial count) through `.sample` explicitly: the size
    heuristic would send a sparsely-populated batch to the shared stream,
    making shared-stream consumption sample-dependent and letting two
    'independent' samplings emit identical points."""

    def __init__(self, shared: np.random.Generator, per_sample: np.random.Generator):
        self._shared = shared
        self._per_sample = per_sample

    @property
    def sample(self) -> np.random.Generator:
        """The per-sample stream — use for ALL surface-point draws."""
        return self._per_sample

    def _pick(self, size) -> np.random.Generator:
        n = int(np.prod(size)) if size is not None else 1
        return self._per_sample if n >= 64 else self._shared

    def uniform(self, lo=0.0, hi=1.0, size=None):
        return self._pick(size).uniform(lo, hi, size)

    def normal(self, loc=0.0, scale=1.0, size=None):
        return self._pick(size).normal(loc, scale, size)

    def multinomial(self, n, p):
        return self._per_sample.multinomial(n, p)

    def choice(self, a, size=None, p=None):
        return self._pick(size).choice(a, size=size, p=p)


def _gt(k: int) -> Dict:
    rx, ry, rz, s, t = _PERTURB[k % len(_PERTURB)]
    return {"R": rot_xyz(rx, ry, rz), "s": s, "t": np.full(3, t)}


def _apply_gt(pts: np.ndarray, gt: Dict) -> np.ndarray:
    return ((pts @ gt["R"].T) * gt["s"] + gt["t"]).astype(np.float32)


def truth_aligned(src: np.ndarray, gt: Dict) -> np.ndarray:
    """Map perturbed source points back into the target (instance) frame —
    the inverse of _apply_gt."""
    return ((src - gt["t"]) / gt["s"]) @ gt["R"]


def transform_rmse(recovered_aligned: np.ndarray, src: np.ndarray,
                   gt: Dict) -> float:
    """RMSE between recovered- and truth-aligned source — the pose-error
    success criterion (1-NN RMSE is blind to sliding on symmetric shapes
    and inflated by partial overlap / deformation by construction)."""
    d = recovered_aligned - truth_aligned(src, gt)
    return float(np.sqrt(np.mean(np.sum(d * d, axis=-1))))


def category_corpus(instances: int = 8, n_points: int = 6000) -> List[Pair]:
    """ModelNet40-analogue: [(name, source, target, gt)] — source and
    target are two independent samplings of one procedural instance, the
    source perturbed by a hard similarity. Instance i < 5 of family f takes
    perturbation k = f*5 + i; later instances take indices beyond 20."""
    out = []
    for f, (fname, _) in enumerate(FAMILIES):
        for i in range(instances):
            tgt = _instance(f, i, n_points, sample=0)
            base = _instance(f, i, n_points, sample=1)
            k = f * 5 + i if i < 5 else 20 + f * (instances - 5) + (i - 5)
            gt = _gt(k)
            out.append((f"{fname}/{i}", _apply_gt(base, gt), tgt, gt))
    return out


def partial_corpus(n_points: int = 6000, keep: float = 0.92,
                   noise: float = 0.004, outlier_frac: float = 0.01) -> List[Pair]:
    """RGB-D-analogue: both sides cropped by DIFFERENT half-spaces (each
    keeps `keep` of its points, so the overlap is about 2*keep-1 of the
    surface), with Gaussian sensor noise and uniform outliers on both sides.
    The Kendall pre-shape estimates centroid and scale from all points
    (initRegistrationKSS.hpp:144-220), so asymmetric crops bias it: the
    overlap tier of register_pair exists for these pairs."""
    out = []
    k = 0
    for f, (fname, _) in enumerate(FAMILIES):
        for i in range(2):
            rng = np.random.default_rng((7, f, i))
            tgt = _instance(f, i, n_points, sample=0)
            base = _instance(f, i, n_points, sample=1)

            def crop(pts, normal):
                score = pts @ normal
                return pts[score <= np.quantile(score, keep)]

            n1 = rng.normal(size=3)
            n1 /= np.linalg.norm(n1)
            n2 = rng.normal(size=3)
            n2 /= np.linalg.norm(n2)
            tgt_c = crop(tgt, n1)
            base_c = crop(base, n2)
            tgt_c = tgt_c + rng.normal(scale=noise, size=tgt_c.shape)
            base_c = base_c + rng.normal(scale=noise, size=base_c.shape)
            n_out = int(outlier_frac * len(tgt_c))
            tgt_c = np.concatenate([tgt_c, rng.uniform(-1, 1, (n_out, 3))], axis=0)
            # The source's outliers are drawn after the target's.
            n_out_s = int(outlier_frac * len(base_c))
            base_c = np.concatenate([base_c, rng.uniform(-1, 1, (n_out_s, 3))], axis=0)
            gt = _gt(k)
            out.append((f"part/{fname}{i}", _apply_gt(base_c.astype(np.float32), gt),
                        tgt_c.astype(np.float32), gt))
            k += 1
    return out


def deform_corpus(n_points: int = 6000, amplitude: float = 0.04) -> List[Pair]:
    """SHREC-analogue: the target carries a smooth low-frequency non-rigid
    displacement (sum of 3 sinusoidal modes, amplitude ~4% of extent);
    success = recovering the rigid part within the deformation budget."""
    out = []
    k = 0
    for f, (fname, _) in enumerate(FAMILIES):
        for i in range(2):
            rng = np.random.default_rng((11, f, i))
            tgt = _instance(f, i, n_points, sample=0)
            base = _instance(f, i, n_points, sample=1)
            disp = np.zeros_like(tgt)
            for _m in range(3):
                freq = rng.uniform(0.8, 2.0, 3)
                phase = rng.uniform(0, 2 * np.pi, 3)
                direction = rng.normal(size=3)
                direction /= np.linalg.norm(direction)
                disp += (amplitude / 3) * np.sin(
                    tgt @ freq + phase[0])[:, None] * direction
            gt = _gt(k + 2)
            out.append((f"def/{fname}{i}", _apply_gt(base, gt),
                        (tgt + disp).astype(np.float32), gt))
            k += 1
    return out


def scale_corpus(n_points: int = 6000) -> List[Pair]:
    """Scale-extreme tier: the category
    protocol at ground-truth scales 0.3x and 3x — an order of magnitude
    apart, bracketing the golden registration_scale corpus (0.6-2.3x).
    Exercises the Kendall pre-shape scale normalization
    (initRegistrationKSS.hpp:144-220 — scale = mean distance-to-centroid
    ratio) at the extremes; pose error is measured in the TARGET frame
    (truth_aligned divides by s), so the 0.20 basin bar applies unchanged."""
    out = []
    for f, (fname, _) in enumerate(FAMILIES):
        for j, s in enumerate((0.3, 3.0)):
            tgt = _instance(f, j, n_points, sample=0)
            base = _instance(f, j, n_points, sample=1)
            rx, ry, rz, _, t = _PERTURB[(f + j) % len(_PERTURB)]
            gt = {"R": rot_xyz(rx, ry, rz), "s": s, "t": np.full(3, t)}
            out.append((f"scl/{fname}{j}", _apply_gt(base, gt), tgt, gt))
    return out


# (board, corpus, pose-error threshold) as in kss_icp_tpu/challenge.py:407-417,
# the hard partial tier last.
BOARDS = (("category", category_corpus, 0.20), ("partial", partial_corpus, 0.20),
          ("deform", deform_corpus, 0.12), ("scale", scale_corpus, 0.20),
          ("partial_hard", functools.partial(partial_corpus, keep=0.8), 0.20))


def challenge_corpus(include_hard: bool = False) -> List[Tuple[str, List[Pair], float]]:
    """[(board, pairs, threshold)] as kss_icp_tpu.challenge.challenge_corpus
    gives them: the hard partial tier only with include_hard."""
    return [(board, corpus(), thr) for board, corpus, thr in BOARDS if include_hard or board != "partial_hard"]
