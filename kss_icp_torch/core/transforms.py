"""Similarity transforms (scale · rotation + translation).

Port of kss_icp_tpu/core/transforms.py. Convention: x' = scale * (R @ x) + t.
Every 3x3 product is written out as elementwise multiplies and adds, in a
fixed order, so that no matrix-multiply library (and no TF32) sits on the
path and the CPU and CUDA results round the same way.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Similarity(NamedTuple):
    """x -> scale * R @ x + t. Fields broadcast over leading batch dims."""

    scale: torch.Tensor        # (...,)
    rotation: torch.Tensor     # (..., 3, 3)
    translation: torch.Tensor  # (..., 3)

    @classmethod
    def from_rigid(cls, rotation: torch.Tensor, translation: torch.Tensor) -> "Similarity":
        return cls(
            scale=torch.ones(rotation.shape[:-2], dtype=rotation.dtype, device=rotation.device),
            rotation=rotation,
            translation=translation,
        )


def rotate_points(rotation: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """R @ p for (..., 3, 3) rotations and (..., N, 3) points -> (..., N, 3)."""
    prod = rotation.unsqueeze(-3) * points.unsqueeze(-2)  # (..., N, 3, 3)
    return prod[..., 0] + prod[..., 1] + prod[..., 2]


def matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for (..., 3, 3) matrices."""
    prod = a.unsqueeze(-1) * b.unsqueeze(-3)  # (..., i, j, k) = a_ij * b_jk
    return prod[..., 0, :] + prod[..., 1, :] + prod[..., 2, :]


def matvec3(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """a @ v for (..., 3, 3) matrices and (..., 3) vectors."""
    prod = a * v.unsqueeze(-2)
    return prod[..., 0] + prod[..., 1] + prod[..., 2]


def apply_similarity(sim: Similarity, points: torch.Tensor) -> torch.Tensor:
    """Apply x' = s·R·x + t to (..., N, 3) points."""
    rotated = rotate_points(sim.rotation, points)
    return sim.scale[..., None, None] * rotated + sim.translation[..., None, :]


def compose(outer: Similarity, inner: Similarity) -> Similarity:
    """Transform equal to applying `inner` first, then `outer`."""
    rot = matmul3(outer.rotation, inner.rotation)
    trans = outer.scale[..., None] * matvec3(outer.rotation, inner.translation) + outer.translation
    return Similarity(scale=outer.scale * inner.scale, rotation=rot, translation=trans)


def _stack_rows(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rot_x(angle: torch.Tensor) -> torch.Tensor:
    """Rotation about +x (initRegistrationKSS.hpp:367-377)."""
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _stack_rows([(o, z, z), (z, c, -s), (z, s, c)])


def rot_y(angle: torch.Tensor) -> torch.Tensor:
    """Rotation about +y (initRegistrationKSS.hpp:378-388)."""
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _stack_rows([(c, z, s), (z, o, z), (-s, z, c)])


def rot_z(angle: torch.Tensor) -> torch.Tensor:
    """Rotation about +z (initRegistrationKSS.hpp:389-400)."""
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _stack_rows([(c, -s, z), (s, c, z), (z, z, o)])


def euler_xyz_matrix(angles: torch.Tensor) -> torch.Tensor:
    """R = Rz(c) · Ry(b) · Rx(a) for angles (..., 3) = (a, b, c): X is applied
    first, then Y, then Z (initRegistrationKSS.hpp:86-88)."""
    rx = rot_x(angles[..., 0])
    ry = rot_y(angles[..., 1])
    rz = rot_z(angles[..., 2])
    return matmul3(matmul3(rz, ry), rx)
