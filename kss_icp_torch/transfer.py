"""Synthetic benchmark-pair tools (port of kss_icp_tpu/transfer.py): the
reference's `TransferPC` (transferPC.hpp:40-182), which produced the bundled
`.wlop`/`.gird` fixture pairs and the `data/registration/transfer.txt`
ground-truth log ("ant x:1.56", "Cat y:1.56", ...).

Ported: the transfer.txt records and their log format, the perturbations
(axis rotation, TransferPC_Transfer :66-98; centroid-anchored uniform scale,
TransferPC_Scale :100-121; uniform translation, TransferPC_Translate
:123-130) and their inverses (`unapply_record` is the JAX CLI's bench-dir
`truth_aligned`, kss_icp_tpu/cli.py:280-288), the 12-NN support radius, and writing a pair in
count format (truncating, where the reference appends with `ios::app`,
SURVEY.md §5.4), and generating pairs: `make_pair` resamples a cloud to its
WLOP target and its grid source on the device (the card unless the caller
passes device="cpu"), `generate_fixture_set` writes a set of them with its
transfer.txt.

The transforms are host-side numpy in float64, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np

PathLike = Union[str, Path]

_AXIS_INDEX = {"x": 0, "y": 1, "z": 2}


@dataclasses.dataclass(frozen=True)
class TransferRecord:
    """One ground-truth perturbation, as logged in transfer.txt.

    The reference log only records axis rotations ("ant x:1.56"); scale and
    translation extend the same record for the registration_scale protocol.
    """

    name: str
    axis: str = "x"          # 'x' | 'y' | 'z'
    angle: float = 0.0       # radians
    scale: float = 1.0       # centroid-anchored uniform scale
    translation: float = 0.0  # scalar added to all three coordinates

    def line(self) -> str:
        s = f"{self.name} {self.axis}:{self.angle:g}"
        if self.scale != 1.0:
            s += f" s:{self.scale:g}"
        if self.translation != 0.0:
            s += f" t:{self.translation:g}"
        return s


def parse_transfer_log(text: str) -> List[TransferRecord]:
    """Parse transfer.txt lines ("ant x:1.56", "Girl x: 1.1" — note the
    reference log is inconsistent about the space after ':')."""
    records = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        parts = line.split(None, 1)
        name, rest = parts[0], parts[1] if len(parts) > 1 else ""
        rec = {"name": name}
        for key, val in re.findall(r"([a-zA-Z]+)\s*:\s*([-+0-9.eE]+)", rest):
            key = key.lower()
            if key in _AXIS_INDEX:
                rec["axis"], rec["angle"] = key, float(val)
            elif key == "s":
                rec["scale"] = float(val)
            elif key == "t":
                rec["translation"] = float(val)
        records.append(TransferRecord(**rec))
    return records


def load_transfer_log(path: PathLike) -> List[TransferRecord]:
    return parse_transfer_log(Path(path).read_text())


def save_transfer_log(path: PathLike, records: List[TransferRecord]) -> None:
    Path(path).write_text("".join(r.line() + "\n" for r in records))


def axis_rotation_matrix(axis: str, angle: float) -> np.ndarray:
    """3x3 rotation about a coordinate axis, with the exact element layout of
    TransferPC_Transfer (transferPC.hpp:66-98) — identical to
    initRegistration_Transfer's per-axis formulas (initRegistrationKSS.hpp:
    365-404), so core.transforms.rot_{x,y,z} agree with this."""
    c, s = np.cos(angle), np.sin(angle)
    i = _AXIS_INDEX[axis]
    if i == 0:
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float64)
    if i == 1:
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float64)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float64)


def rotate_axis(points: np.ndarray, axis: str, angle: float) -> np.ndarray:
    """TransferPC_Transfer: rotate all points about a coordinate axis."""
    r = axis_rotation_matrix(axis, angle)
    return np.asarray(points) @ r.T


def scale_about_centroid(points: np.ndarray, rate: float) -> np.ndarray:
    """TransferPC_Scale (transferPC.hpp:100-121): uniform scale anchored at
    the cloud centroid, so the centroid is a fixed point."""
    pts = np.asarray(points, dtype=np.float64)
    c = pts.mean(axis=0)
    return (pts - c) * rate + c


def translate_uniform(points: np.ndarray, dis: float) -> np.ndarray:
    """TransferPC_Translate (transferPC.hpp:123-130): add the same scalar to
    x, y and z of every point (a diagonal shift, reproduced verbatim)."""
    return np.asarray(points, dtype=np.float64) + dis


def apply_record(points: np.ndarray, record: TransferRecord) -> np.ndarray:
    """Apply a full record in the reference tool's order: rotate, scale,
    translate (the drivers called Transfer then Scale/Translate as needed)."""
    out = rotate_axis(points, record.axis, record.angle)
    if record.scale != 1.0:
        out = scale_about_centroid(out, record.scale)
    if record.translation != 0.0:
        out = translate_uniform(out, record.translation)
    return out


def unapply_record(points: np.ndarray, record: TransferRecord) -> np.ndarray:
    """Undo `apply_record`: the ground-truth position of a perturbed cloud,
    against which bench-dir scores a recovered pose. The centroid is a
    fixed point of the scale, so it is found again on the translated cloud."""
    pts = np.asarray(points, np.float64) - record.translation
    if record.scale != 1.0:
        c = pts.mean(axis=0)
        pts = (pts - c) / record.scale + c
    return pts @ axis_rotation_matrix(record.axis, record.angle)


def inverse_rotation(record: TransferRecord) -> np.ndarray:
    """The rotation a correct registration of the perturbed cloud onto the
    original must recover (ground-truth oracle for tests)."""
    return axis_rotation_matrix(record.axis, record.angle).T


# ---------------------------------------------------------------------------
# Pair generation (TransferPC_init + TransferPC_Resample + SavePC)
# ---------------------------------------------------------------------------

def estimate_radius(points: np.ndarray, k: int = 12, device="cuda") -> float:
    """BallRegion's support radius: max k-NN distance over the cloud
    (ballRegionCompute.hpp:477-530, pointNumEsti=12), as
    `ops.spatial.estimate_radius` on the whole cloud. The JAX package pads
    the cloud to a multiple of 256 rows for XLA's shape cache; the padded
    rows are masked, so the port passes the cloud as it is."""
    import torch

    from kss_icp_torch.ops.spatial import estimate_radius as radius

    pts = torch.as_tensor(np.asarray(points, dtype=np.float32), device=device)
    return float(radius(pts, torch.ones(pts.shape[0], dtype=torch.bool, device=device), k))


@dataclasses.dataclass
class TransferPair:
    """A generated benchmark pair: `target` (WLOP resample of the original)
    and `source` (grid resample, perturbed by `record`)."""

    name: str
    target: np.ndarray   # (.wlop role)
    source: np.ndarray   # (.gird role, transformed)
    record: TransferRecord
    radius: float


def make_pair(
    points: np.ndarray,
    record: TransferRecord,
    wlop_points: int = 8000,
    grid_cell: Optional[float] = None,
    wlop_iterations: int = 20,
    device="cuda",
) -> TransferPair:
    """Produce a (source, target) benchmark pair from one cloud, mirroring
    TransferPC_Resample (transferPC.hpp:144-151; kss_icp_tpu/transfer.py:181-216):
    target = WLOP(wlop_points), source = grid_simplify(cell = radius/1.5) then
    perturbed by `record`. The cloud is padded to a multiple of 256 rows, as
    in JAX, so that WLOP's FPS start and support radius are JAX's."""
    import torch

    from kss_icp_torch.ops.simplify import grid_simplify
    from kss_icp_torch.ops.wlop import wlop_resample

    pts = np.asarray(points, dtype=np.float32)
    n = pts.shape[0]
    pad = ((n + 255) // 256) * 256
    padded = np.zeros((pad, 3), np.float32)
    padded[:n] = pts
    mask = np.zeros((pad,), bool)
    mask[:n] = True
    pt, mt = torch.as_tensor(padded, device=device), torch.as_tensor(mask, device=device)

    radius = estimate_radius(pts, device=device) if grid_cell is None else grid_cell * 1.5
    m = min(wlop_points, n)
    wl, _ = wlop_resample(pt, mt, m, iterations=wlop_iterations)
    target = wl.cpu().numpy().astype(np.float64)

    gr_pts, gr_mask = grid_simplify(pt, mt, radius / 1.5)
    source = apply_record(gr_pts[gr_mask].cpu().numpy().astype(np.float64), record)
    return TransferPair(
        name=record.name, target=target, source=source, record=record,
        radius=radius,
    )


def save_pair(pair: TransferPair, out_dir: PathLike) -> Tuple[Path, Path]:
    """Write <name>.wlop / <name>.gird in count format (truncating; see
    module docstring for the deliberate ios::app fix)."""
    from kss_icp_torch.io.formats import save_xyz

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    wlop_path = out / f"{pair.name}.wlop"
    gird_path = out / f"{pair.name}.gird"
    save_xyz(wlop_path, pair.target)
    save_xyz(gird_path, pair.source)
    return wlop_path, gird_path


def generate_fixture_set(
    clouds: List[Tuple[str, np.ndarray]],
    records: List[TransferRecord],
    out_dir: PathLike,
    device="cuda",
    **kwargs,
) -> List[TransferPair]:
    """Batch fixture generation + transfer.txt log — the full TransferPC
    driver loop shape (kss_icp_tpu/transfer.py:233-249); `device` and
    `kwargs` go to `make_pair`."""
    by_name = {r.name: r for r in records}
    pairs = []
    for name, pts in clouds:
        rec = by_name.get(name, TransferRecord(name=name))
        pair = make_pair(pts, rec, device=device, **kwargs)
        save_pair(pair, out_dir)
        pairs.append(pair)
    save_transfer_log(Path(out_dir) / "transfer.txt", records)
    return pairs
