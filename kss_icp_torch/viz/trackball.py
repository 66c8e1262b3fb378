"""Virtual trackball (port of kss_icp_tpu/viz/trackball.py) — the SGI quaternion trackball the reference viewer
uses for mouse rotation (trackball.{h,cpp}, Gavin Bell's implementation;
driven from View.h's GLUT callbacks).

Same interaction model, re-derived in numpy: screen drags map to rotations
by projecting both endpoints onto a sphere-hyperbola hybrid surface, taking
the axis from their cross product, and accumulating unit quaternions. This
is pure host-side UI math (never a hot path), kept dependency-free so the
headless renderer (viz/render.py) can consume its rotation matrices."""

from __future__ import annotations

import numpy as np

TRACKBALL_SIZE = 0.8  # the reference's TRACKBALLSIZE


def _project_to_surface(r: float, x: float, y: float) -> float:
    """z of the trackball surface at (x, y): sphere inside r/√2, hyperbolic
    sheet outside (the classic SGI blend — drags past the ball edge keep
    rotating smoothly)."""
    d = np.hypot(x, y)
    if d < r / np.sqrt(2.0):
        return float(np.sqrt(r * r - d * d))
    t = r / np.sqrt(2.0)
    return float(t * t / max(d, 1e-12))


def drag_quaternion(p1x, p1y, p2x, p2y, size: float = TRACKBALL_SIZE) -> np.ndarray:
    """Unit quaternion (x, y, z, w) for a drag from (p1x, p1y) to (p2x, p2y),
    screen coords in [-1, 1]. Zero drag -> identity."""
    if p1x == p2x and p1y == p2y:
        return np.array([0.0, 0.0, 0.0, 1.0])
    p1 = np.array([p1x, p1y, _project_to_surface(size, p1x, p1y)])
    p2 = np.array([p2x, p2y, _project_to_surface(size, p2x, p2y)])
    axis = np.cross(p2, p1)
    norm = np.linalg.norm(axis)
    if norm < 1e-12:
        return np.array([0.0, 0.0, 0.0, 1.0])
    axis /= norm
    # Rotation angle from the chord length, clamped like the reference.
    t = np.linalg.norm(p1 - p2) / (2.0 * size)
    t = np.clip(t, -1.0, 1.0)
    phi = 2.0 * np.arcsin(t)
    return axis_angle_quaternion(axis, phi)


def axis_angle_quaternion(axis: np.ndarray, angle: float) -> np.ndarray:
    axis = np.asarray(axis, float)
    axis = axis / max(np.linalg.norm(axis), 1e-12)
    s = np.sin(angle / 2.0)
    return np.array([axis[0] * s, axis[1] * s, axis[2] * s, np.cos(angle / 2.0)])


def add_quaternions(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    """Accumulate rotations: result applies q2 first, then q1 (the
    reference's add_quats argument order), renormalized to fight drift."""
    x1, y1, z1, w1 = q1
    x2, y2, z2, w2 = q2
    out = np.array(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
            w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ]
    )
    return out / max(np.linalg.norm(out), 1e-12)


def quaternion_matrix(q: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix of a unit quaternion (build_rotmatrix role)."""
    x, y, z, w = np.asarray(q, float)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (z * x + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (z * x - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


class Trackball:
    """Stateful drag accumulator: feed normalized mouse positions, read a
    rotation matrix for the renderer."""

    def __init__(self):
        self.quat = np.array([0.0, 0.0, 0.0, 1.0])

    def drag(self, p1x, p1y, p2x, p2y) -> None:
        self.quat = add_quaternions(drag_quaternion(p1x, p1y, p2x, p2y), self.quat)

    @property
    def rotation(self) -> np.ndarray:
        return quaternion_matrix(self.quat)
