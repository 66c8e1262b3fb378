"""The plain reference of a registration cell, and its lower-precision control.

Plain PyTorch and numpy; it imports nothing of the program. For each pair it
works out again, from the inputs the benchmark handed the program and from
the ground truth those inputs were made with:

  * the metric of the program's answer: the program's similarity applied to
    the full-resolution source in float64, and the RMSE and MAE of its 1-NN
    distances to the full-resolution target in float64 (registrationMeasure.hpp:
    47-98), in the frame the program measured in (the unit cube of the
    target's centre and largest extent where the configuration's ingest is
    "unit_cube", as LoadPointCloud.hpp:347-427 normalizes);
  * the pose error of the program's answer: the RMS distance between the
    source as the program's similarity places it and as the ground truth
    places it, in the target's units (challenge.py::transform_rmse).

`control_answer` is this reference put in the program's place and computed in
TF32, the precision below the configuration's float32 with TF32 off: the
ground truth's similarity, applied and measured with every product's inputs
rounded to TF32's 10-bit mantissa and float32 sums, as a tensor-core
distance (|q|² + |r|² - 2 q.r) would compute them.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

# Elements of one block of the distance matrix (2 GiB of float64).
BLOCK_ELEMS = 1 << 28


def truth_aligned(src: np.ndarray, truth: Dict) -> np.ndarray:
    """Where the ground truth puts the source in the target's frame: the
    inverse of source = s * R @ x + t."""
    return ((np.asarray(src, np.float64) - truth["t"]) / truth["s"]) @ truth["R"]


def ingest_frame(tgt: np.ndarray, ingest: str) -> Tuple[np.ndarray, float]:
    """(centre, scale) of the frame the program measures in: the target's
    centroid and largest absolute extent for "unit_cube", else the identity."""
    if ingest == "unit_cube":
        t = np.asarray(tgt, np.float64)
        center = t.mean(axis=0)
        return center, float(np.abs(t - center).max())
    if ingest != "none":
        raise ValueError(f"unknown ingest {ingest!r}")
    return np.zeros(3), 1.0


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits, nearest, ties to even)."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def nearest_sq(query: torch.Tensor, ref: torch.Tensor, control: bool = False) -> torch.Tensor:
    """Each query row's squared distance to its nearest reference row, as
    |q|² + |r|² - 2 q.r in blocks of query rows: float64 for the reference;
    for the control, float32 with TF32-rounded product inputs."""
    if control:
        q, r = query.float(), ref.float()
        qd, rd = tf32(q), tf32(r)
    else:
        q, r = query.double(), ref.double()
        qd, rd = q, r
    rn = (r * r).sum(dim=1)
    rows = max(1, BLOCK_ELEMS // max(len(r), 1))
    out = []
    for i in range(0, len(q), rows):
        qb = q[i:i + rows]
        # min over r of |r|² - 2 q.r, then |q|², which is the same for the row.
        part = torch.addmm(rn[None, :], qd[i:i + rows], rd.T, alpha=-2.0).min(dim=1).values
        out.append(((qb * qb).sum(dim=1) + part).clamp_min(0))
    return torch.cat(out)


def measure(aligned: torch.Tensor, target: torch.Tensor, control: bool = False) -> Tuple[float, float]:
    """(RMSE, MAE) of the aligned cloud's 1-NN distances to the target."""
    d2 = nearest_sq(aligned, target, control).double()
    return float(d2.mean().sqrt()), float(d2.sqrt().mean())


def _apply(scale, rotation, translation, points: torch.Tensor, control: bool) -> torch.Tensor:
    if control:
        r = torch.as_tensor(np.asarray(rotation, np.float32), device=points.device)
        return (scale * (tf32(points.float()) @ tf32(r).T) + torch.as_tensor(
            np.asarray(translation, np.float32), device=points.device)).float()
    r = torch.as_tensor(np.asarray(rotation, np.float64), device=points.device)
    t = torch.as_tensor(np.asarray(translation, np.float64), device=points.device)
    return float(scale) * (points.double() @ r.T) + t


def prepare(pair, ingest: str, device) -> Dict:
    """What the reference needs of one pair, on `device`, made once for all
    the answers to it: the frame, the source and the target in it (float64),
    and where the ground truth puts the source."""
    center, nscale = ingest_frame(pair.tgt, ingest)

    def put(x):
        return torch.as_tensor((np.asarray(x, np.float64) - center) / nscale, device=device)

    return {"nscale": nscale, "src": put(pair.src), "tgt": put(pair.tgt),
            "truth": put(truth_aligned(pair.src, pair.truth))}


def judge_pair(prepared: Dict, answer, metric: bool = True) -> Dict[str, float]:
    """The reference's readings of the program's answer for one pair (its
    `prepare`d data): "pose_error", in the target's units, and with `metric`
    "metric_gap", the larger relative gap of the answer's RMSE and MAE to the
    reference's."""
    aligned = _apply(answer.scale, answer.rotation, answer.translation, prepared["src"], control=False)
    out = {"pose_error": prepared["nscale"] * float(((aligned - prepared["truth"]) ** 2).sum(dim=1).mean().sqrt())}
    if metric:
        rmse, mae = measure(aligned, prepared["tgt"])
        out["metric_gap"] = max(abs(answer.rmse - rmse) / max(rmse, 1e-30), abs(answer.mae - mae) / max(mae, 1e-30))
    return out


def truth_transform(pair, ingest: str) -> Tuple[float, np.ndarray, np.ndarray]:
    """The ground truth's similarity from the source to the target, in the
    frame the program works in: (scale, rotation, translation)."""
    center, nscale = ingest_frame(pair.tgt, ingest)
    r, s, t = pair.truth["R"], pair.truth["s"], np.asarray(pair.truth["t"], np.float64)
    # x = R^T (y - t) / s in raw units; y = nscale * y' + center, x' = (x - center) / nscale.
    rot = r.T
    trans = (rot @ (center - t)) / (s * nscale) - center / nscale
    return 1.0 / s, rot, trans


def control_answer(pair, ingest: str, device):
    """The control in the program's place for one pair: the ground truth's
    similarity, applied and measured in TF32. Returns the fields of an
    Answer as a tuple: (scale, rotation, translation, rmse, mae)."""
    center, nscale = ingest_frame(pair.tgt, ingest)
    scale, rot, trans = truth_transform(pair, ingest)
    src = torch.as_tensor(((pair.src - center) / nscale).astype(np.float32), device=device)
    tgt = torch.as_tensor(((pair.tgt - center) / nscale).astype(np.float32), device=device)
    aligned = _apply(np.float32(scale), rot, trans, src, control=True)
    rmse, mae = measure(aligned, tgt, control=True)
    return (float(np.float32(scale)), rot.astype(np.float32), trans.astype(np.float32), rmse, mae)

