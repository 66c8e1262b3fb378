"""Shared pieces of the PyTorch-port tests (tests/test_torch_*.py)."""

import numpy as np
import pytest
import torch

from helpers import random_cloud


@pytest.fixture()
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on the card)")
    return torch.device("cuda", 0)


def _rotations(rng, n):
    """(2 + n, 3, 3) float32: the identity, a quarter turn about z (exact in
    float32) and n random rotations."""
    mats = [np.eye(3), np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])]
    for _ in range(n):
        qm, r = np.linalg.qr(rng.normal(size=(3, 3)))
        mats.append(qm * np.sign(np.diag(r)) * np.linalg.det(qm * np.sign(np.diag(r))))
    return np.stack(mats).astype(np.float32)


def cull_probe_cases():
    """{name: (source, source mask, target, target mask, rotations)} numpy
    inputs of the field_trim kernel's culling probes: points on tile faces
    and corners, duplicate target rows, a lattice of near-equal distances,
    one valid target row, a single tile, P not a multiple of 32. The
    identity and the quarter turn keep source points exactly on target rows
    and box faces."""
    rng = np.random.default_rng(15)
    g = np.arange(6, dtype=np.float32) * np.float32(0.2)
    lattice = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3).astype(np.float32)
    corners = np.concatenate([lattice, lattice[::7] + np.float32(0.1)]).astype(np.float32)
    cases = {}
    cases["faces and corners"] = (corners, np.ones(len(corners), bool), lattice, np.ones(len(lattice), bool))
    dup = np.repeat(random_cloud(rng, 70).astype(np.float32), 3, axis=0)[rng.permutation(210)]
    cases["duplicate rows"] = (random_cloud(rng, 96).astype(np.float32), np.ones(96, bool), dup, np.ones(210, bool))
    near = (lattice * np.float32(0.5) + rng.uniform(-1e-7, 1e-7, lattice.shape)).astype(np.float32)
    centres = (lattice[:125] * np.float32(0.5) + np.float32(0.05)).astype(np.float32)
    cases["near-equal lattice"] = (centres, np.ones(125, bool), near, np.ones(len(near), bool))
    one = np.zeros(50, bool)
    one[33] = True
    cases["one valid row"] = (random_cloud(rng, 64).astype(np.float32), np.ones(64, bool),
                              random_cloud(rng, 50).astype(np.float32), one)
    cases["single tile"] = (random_cloud(rng, 40).astype(np.float32), np.ones(40, bool),
                            random_cloud(rng, 10).astype(np.float32), np.ones(10, bool))
    smask = rng.uniform(size=45) < 0.8
    tmask = rng.uniform(size=300) < 0.7
    cases["P not a multiple of 32"] = (random_cloud(rng, 45).astype(np.float32), smask,
                                       random_cloud(rng, 300).astype(np.float32), tmask)
    return {k: v + (_rotations(rng, 6),) for k, v in cases.items()}
