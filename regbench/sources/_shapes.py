"""Frozen copies of the port's shape generators, kept with the benchmark so
that later changes to the program cannot change its traffic.

Copied from kss_icp_torch/challenge.py (rot_xyz, the four procedural
families, the symmetry-breaking warp, `_instance` and its split generator),
kss_icp_torch/largescan.py (`_room_boxes`, `room_scene`) and
kss_icp_torch/transfer.py (`axis_rotation_matrix`, `unapply_record`), array
for array. Host numpy only.
"""

from __future__ import annotations

import numpy as np


def rot_xyz(ax: float, ay: float, az: float) -> np.ndarray:
    """Rz(az) @ Ry(ay) @ Rx(ax) in float64."""
    cx, sx = np.cos(ax), np.sin(ax)
    cy, sy = np.cos(ay), np.sin(ay)
    cz, sz = np.cos(az), np.sin(az)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx


def axis_rotation_matrix(axis: str, angle: float) -> np.ndarray:
    """Rotation about one coordinate axis (transferPC.hpp:66-98)."""
    c, s = np.cos(angle), np.sin(angle)
    i = "xyz".index(axis)
    if i == 0:
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float64)
    if i == 1:
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float64)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float64)


def unapply_record(points: np.ndarray, axis: str, angle: float, scale: float, translation: float) -> np.ndarray:
    """Undo a transfer.txt record (rotate about an axis, scale about the
    centroid, add a diagonal shift): the cloud in its model's frame."""
    pts = np.asarray(points, np.float64) - translation
    if scale != 1.0:
        c = pts.mean(axis=0)
        pts = (pts - c) / scale + c
    return pts @ axis_rotation_matrix(axis, angle)


# --- procedural families (challenge.py) --------------------------------------

def _unit_normalize(pts: np.ndarray) -> np.ndarray:
    pts = pts - pts.mean(axis=0)
    m = np.abs(pts).max()
    return (pts / max(m, 1e-12)).astype(np.float32)


def _superellipsoid(rng, n: int) -> np.ndarray:
    e1 = float(rng.uniform(0.3, 1.6))
    e2 = float(rng.uniform(0.3, 1.6))
    abc = rng.uniform(0.4, 1.0, (3,))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    x, y, z = d[:, 0] / abc[0], d[:, 1] / abc[1], d[:, 2] / abc[2]
    f = (np.abs(x) ** (2 / e2) + np.abs(y) ** (2 / e2)) ** (e2 / e1) + np.abs(z) ** (2 / e1)
    lam = f ** (-e1 / 2.0)
    return _unit_normalize(d * lam[:, None])


def _revolution(rng, n: int) -> np.ndarray:
    k = np.arange(1, 5)
    coef = rng.normal(scale=0.25 / k)
    phase = rng.uniform(0, 2 * np.pi, 4)
    zs = np.linspace(-1, 1, 512)

    def r_of(z):
        return 0.55 + np.sum(coef * np.sin(np.outer(z, k) + phase), axis=-1).clip(-0.4, 0.6)

    w = np.maximum(r_of(zs), 0.05)
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    z = np.interp(rng.uniform(0, 1, n), cdf, zs)
    r = np.maximum(r_of(z), 0.05)
    th = rng.uniform(0, 2 * np.pi, n)
    return _unit_normalize(np.stack([r * np.cos(th), r * np.sin(th), z], axis=-1))


def _box_assembly(rng, n: int) -> np.ndarray:
    lwx = float(rng.uniform(0.55, 1.0))
    lwy = float(rng.uniform(0.55, 1.0))
    lh = float(rng.uniform(0.04, 0.12))
    hh = float(rng.uniform(0.5, 0.9))
    boxes = [(np.array([0, 0, hh]), np.array([lwx, lwy, lh]))]
    for sx in (-1, 1):
        for sy in (-1, 1):
            leg = float(rng.uniform(0.05, 0.12))
            ell = hh * float(rng.uniform(0.55, 1.0))
            ox = sx * (lwx - leg - float(rng.uniform(0.0, 0.15)))
            oy = sy * (lwy - leg - float(rng.uniform(0.0, 0.15)))
            boxes.append((np.array([ox, oy, hh - lh - ell / 2]), np.array([leg, leg, ell / 2])))
    return _unit_normalize(_sample_boxes(rng.sample if isinstance(rng, _SplitRNG) else rng, boxes, n))


def _sample_boxes(rng, boxes, n: int) -> np.ndarray:
    """Area-proportional samples of the cuboid shells `boxes`."""
    areas = np.array([8 * (s[0] * s[1] + s[1] * s[2] + s[0] * s[2]) for _, s in boxes])
    counts = rng.multinomial(n, areas / areas.sum())
    parts = []
    for (c, s), m in zip(boxes, counts):
        fa = np.array([s[1] * s[2], s[1] * s[2], s[0] * s[2], s[0] * s[2], s[0] * s[1], s[0] * s[1]])
        face = rng.choice(6, size=m, p=fa / fa.sum())
        u = rng.uniform(-1, 1, (m, 3)) * s
        axis = face // 2
        u[np.arange(m), axis] = np.where(face % 2 == 0, s[axis], -s[axis])
        parts.append(c + u)
    return np.concatenate(parts, axis=0)


def _tube(rng, n: int) -> np.ndarray:
    turns = float(rng.uniform(1.2, 2.8))
    rad = float(rng.uniform(0.5, 0.9))
    pitch = float(rng.uniform(0.3, 0.8))
    tube_r0 = float(rng.uniform(0.08, 0.18))
    taper = float(rng.uniform(0.4, 0.8))
    t = rng.uniform(0, 1, n) * turns * 2 * np.pi
    th = rng.uniform(0, 2 * np.pi, n)
    tube_r = tube_r0 * (1 + taper * t / (turns * 2 * np.pi))
    c = np.stack([rad * np.cos(t), rad * np.sin(t), pitch * t / np.pi], -1)
    tan = np.stack([-np.sin(t), np.cos(t), np.full_like(t, pitch / (np.pi * rad))], -1)
    tan /= np.linalg.norm(tan, axis=1, keepdims=True)
    n1 = np.stack([np.cos(t), np.sin(t), np.zeros_like(t)], -1)
    n2 = np.cross(tan, n1)
    pts = c + tube_r[:, None] * (np.cos(th)[:, None] * n1 + np.sin(th)[:, None] * n2)
    return _unit_normalize(pts)


FAMILIES = [("se", _superellipsoid), ("rev", _revolution), ("box", _box_assembly), ("tube", _tube)]


def _asymmetrize(pts: np.ndarray, rng: np.random.Generator) -> np.ndarray:
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


class _SplitRNG:
    """Parameter draws (fewer than 64 values) from the instance's shared
    stream, point draws from the per-sample stream."""

    def __init__(self, shared: np.random.Generator, per_sample: np.random.Generator):
        self._shared = shared
        self._per_sample = per_sample

    @property
    def sample(self) -> np.random.Generator:
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


def instance(family: int, idx: int, n: int, sample: int) -> np.ndarray:
    """Sampling `sample` of instance `idx` of a family: the shape from
    (family, idx), the surface points from (family, idx, sample)."""
    _, gen = FAMILIES[family]
    shape_rng = np.random.default_rng(1000 * family + idx)
    params_seed = int(shape_rng.integers(2 ** 31))
    rng = np.random.default_rng((params_seed, sample))
    surface = gen(_SplitRNG(np.random.default_rng(params_seed), rng), n)
    return _asymmetrize(surface, np.random.default_rng((params_seed, 99)))


# --- room scenes (largescan.py) -----------------------------------------------

def _room_boxes(rng: np.random.Generator):
    w = float(rng.uniform(3.0, 5.0))
    d = float(rng.uniform(2.5, 4.5))
    h = float(rng.uniform(1.2, 1.6))
    t = 0.02
    boxes = [
        (np.array([0, 0, -h]), np.array([w, d, t])),
        (np.array([-w, 0, 0]), np.array([t, d, h])),
        (np.array([w, 0, 0]), np.array([t, d, h])),
        (np.array([0, -d, 0]), np.array([w, t, h])),
        (np.array([0, d, 0]), np.array([w, t, h])),
    ]
    for _ in range(int(rng.integers(8, 15))):
        fx = float(rng.uniform(0.2, 0.9))
        fy = float(rng.uniform(0.2, 0.9))
        fz = float(rng.uniform(0.2, 1.0))
        cx = float(rng.uniform(-w + fx + 0.2, w - fx - 0.2))
        cy = float(rng.uniform(-d + fy + 0.2, d - fy - 0.2))
        boxes.append((np.array([cx, cy, -h + fz]), np.array([fx, fy, fz])))
    return boxes


def room_scene(n_points: int, seed: int, sample: int) -> np.ndarray:
    """Area-proportional samples of a procedural room (a floor, four walls,
    8-14 cuboids): `seed` fixes the room, (seed, sample) the scan."""
    boxes = _room_boxes(np.random.default_rng(seed))
    rng = np.random.default_rng((seed, sample, 17))
    return _sample_boxes(rng, boxes, n_points).astype(np.float32)
