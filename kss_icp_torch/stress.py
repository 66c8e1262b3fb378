"""Corpus loaders (port of kss_icp_tpu/stress.py): the golden pairs, the
remesh pairs and the adversarial stress corpus, with JAX's names and arrays.

The bundled golden pairs (data/registration/transfer.txt) only use
single-axis rotations <= 1.56 rad. The stress corpus applies compound 3-axis
rotations + scale + translation to the bundled models — the regime where
the rotation grid's local-minima list earns its keep
(initRegistrationKSS.hpp:276-289) and where auto-escalation
(KSSICPConfig.auto_escalate) is required for 30/30 success (BASELINE.md).

Host-side numpy, through the port's io/formats.py and transfer.py. The
golden, stress and halves corpora read the reference checkout's data at
JAX's paths (REFERENCE); where it is absent, golden_corpus returns no pairs
and stress_corpus raises. `remesh_corpus()` at its default protocol reads the
committed fixtures/remesh_transfer.{npz,json} of this checkout.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Tuple

import numpy as np

from kss_icp_torch.challenge import rot_xyz
from kss_icp_torch.io.formats import load_off, load_points, uniform_normalize
from kss_icp_torch.transfer import TransferRecord, apply_record

# The reference checkout's location, as kss_icp_tpu/stress.py names it.
REFERENCE = Path("/root/reference/PS_AIS_Simplification")
DATA = REFERENCE / "data" / "registration"
MODELS = ["Bunny", "Cat", "Dog", "Girl", "Horse", "ant", "hand", "woodMan",
          "Angel", "Armadillo"]

# (rx, ry, rz, scale, shift) ground-truth similarity perturbations.
HARD = [
    (2.8, 1.9, 0.9, 1.7, 0.4),
    (3.1, 0.7, 2.4, 0.6, -0.8),
    (1.4, 2.9, 1.8, 2.3, 1.2),
]

REMESH = REFERENCE / "Remesh" / "Advancing"
GOLDEN_ROOT = REFERENCE / "data"
GOLDEN_SETS = [("registration", ""), ("registration_scale", "s/")]


def golden_corpus(root: Path = GOLDEN_ROOT):
    """The bundled golden pairs that `root` holds: [(name, source(.gird),
    target(.wlop))], each set's names in sorted order; a set whose directory
    is absent contributes none."""
    pairs = []
    for subdir, prefix in GOLDEN_SETS:
        d = root / subdir
        if not d.exists():
            continue
        names = sorted({p.stem for p in d.glob("*.gird")}
                       & {p.stem for p in d.glob("*.wlop")})
        for name in names:
            pairs.append((prefix + name,
                          np.asarray(load_points(d / f"{name}.gird")),
                          np.asarray(load_points(d / f"{name}.wlop"))))
    return pairs


# Deterministic per-model perturbation cycles (transferPC.hpp:66-130
# semantics: axis rotation, centroid-anchored scale, uniform translation).
_AXES = ["x", "y", "z"]
_ANGLES = [1.56, 1.1, 2.2, 0.8, 2.9]
_SCALES = [1.0, 0.7, 1.4, 2.0, 0.55]
_SHIFTS = [0.0, 0.5, -0.8, 1.2]

# Committed fixtures built by scripts/gen_remesh_fixtures.py via the real
# TransferPC resampling protocol (transferPC.hpp:144-151).
FIXTURE_NPZ = Path(__file__).resolve().parent.parent / "fixtures" / "remesh_transfer.npz"
FIXTURE_JSON = FIXTURE_NPZ.with_suffix(".json")


def remesh_records(names: List[str]):
    """The deterministic transfer.txt-style perturbation per model name."""
    return [
        TransferRecord(
            name=name,
            axis=_AXES[i % len(_AXES)],
            angle=_ANGLES[i % len(_ANGLES)],
            scale=_SCALES[i % len(_SCALES)],
            translation=_SHIFTS[i % len(_SHIFTS)],
        )
        for i, name in enumerate(names)
    ]


def remesh_corpus(
    data: Path = REMESH, seed: int = 0, protocol: str = "transfer",
) -> List[Tuple[str, np.ndarray, np.ndarray, dict]]:
    """Perturbed pairs from the 25 Remesh/Advancing OFF models — the wider
    accuracy corpus (SURVEY.md §4.1). Returns
    [(name, source, target, record_dict), ...].

    protocol="transfer" (default): loads the committed fixtures generated by
    scripts/gen_remesh_fixtures.py through the REAL TransferPC resampling
    protocol — target = WLOP(8000) resample, source = grid-simplify
    (radius/1.5) perturbed by the record (transferPC.hpp:144-151) — so
    source and target come from DIFFERENT samplers, like the reference's own
    .gird/.wlop benchmark pairs.

    protocol="halves": vertices are normalized to [-1,1]^3 (PointCloud_Uniform
    semantics, LoadPointCloud.hpp:347-427) and split into two disjoint
    random halves — identically-distributed samplings, an easier pairing."""
    if protocol == "transfer":
        if data != REMESH:
            raise ValueError(
                "protocol='transfer' loads the committed fixtures built from "
                "Remesh/Advancing; for custom models use protocol='halves' "
                "or regenerate fixtures via scripts/gen_remesh_fixtures.py"
            )
        if not FIXTURE_NPZ.exists():
            raise FileNotFoundError(
                f"{FIXTURE_NPZ} missing — run scripts/gen_remesh_fixtures.py"
            )
        meta = json.loads(FIXTURE_JSON.read_text())
        out = []
        with np.load(FIXTURE_NPZ) as z:
            for rec in meta:
                name = rec["name"]
                out.append((name,
                            np.asarray(z[f"{name}_src"], np.float32),
                            np.asarray(z[f"{name}_tgt"], np.float32),
                            {k: rec[k] for k in
                             ("axis", "angle", "scale", "translation")}))
        return out

    files = sorted(data.glob("*.off"))
    rng = np.random.default_rng(seed)
    out = []
    for f, rec in zip(files, remesh_records([f.stem for f in files])):
        pts, _ = uniform_normalize(load_off(f))
        perm = rng.permutation(len(pts))
        half = len(pts) // 2
        src_half = pts[perm[:half]]
        tgt_half = pts[perm[half:]]
        src = apply_record(src_half, rec).astype(np.float32)
        out.append((f.stem, src, tgt_half.astype(np.float32), {
            "axis": rec.axis, "angle": rec.angle,
            "scale": rec.scale, "translation": rec.translation,
        }))
    return out


def stress_corpus(
    models: List[str] = MODELS, data: Path = DATA,
) -> List[Tuple[str, np.ndarray, np.ndarray]]:
    """[(name, source, target), ...] — 3 hard perturbations per model.

    Synthetic pairs: source = (target @ R^T) * s + t, so perfect recovery
    means RMSE at the resampling-density floor (~0.01-0.03)."""
    out = []
    for name in models:
        tgt = np.asarray(load_points(data / f"{name}.wlop"), np.float32)
        for k, (ax, ay, az, s, t) in enumerate(HARD):
            r = rot_xyz(ax, ay, az)
            out.append((f"{name}/h{k}", (tgt @ r.T) * s + t, tgt))
    return out
