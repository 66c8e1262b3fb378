"""Room-class large-scan registration (port of kss_icp_tpu/largescan.py).

The reference ships a CUDA binary for big RGB-D scans (Room and block runs).
This module generates the same procedural Room scenes as the JAX package,
array for array (floor, four walls, furniture cuboids, sampled in proportion
to area), and runs the large-scan protocol through the port:

  ingest normalization -> octree voxel downsample of both scans to about
  `pre_downsample` points (ops/simplify.py::octree_simplify) -> compaction
  of the survivors -> one 2-cloud `fps` launch to `resample_pad` ->
  register_resampled, with largescan's own escalation rule -> the
  similarity applied to the full-resolution source -> the full-resolution
  1-NN metric (one `nn1` launch, 1 x pad x pad) -> pose error against the
  ground truth.
"""

from __future__ import annotations

import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from kss_icp_torch.challenge import rot_xyz, transform_rmse
from kss_icp_torch.config import DEFAULT_CONFIG, KSSICPConfig
from kss_icp_torch.core.transforms import apply_similarity
from kss_icp_torch.metrics import registration_measure_padded
from kss_icp_torch.models import kss_icp as kss
from kss_icp_torch.ops.simplify import octree_simplify


def _room_boxes(rng: np.random.Generator):
    """[(center, half_extents)] for a room shell + furniture."""
    # Room shell: floor + 4 walls (open ceiling, like a scan from inside).
    w = float(rng.uniform(3.0, 5.0))    # half-width  (x)
    d = float(rng.uniform(2.5, 4.5))    # half-depth  (y)
    h = float(rng.uniform(1.2, 1.6))    # half-height (z)
    t = 0.02                            # surface half-thickness
    boxes = [
        (np.array([0, 0, -h]), np.array([w, d, t])),          # floor
        (np.array([-w, 0, 0]), np.array([t, d, h])),          # walls
        (np.array([w, 0, 0]), np.array([t, d, h])),
        (np.array([0, -d, 0]), np.array([w, t, h])),
        (np.array([0, d, 0]), np.array([w, t, h])),
    ]
    # Furniture: 8-14 cuboids on the floor (tables, cabinets, boxes).
    for _ in range(int(rng.integers(8, 15))):
        fx = float(rng.uniform(0.2, 0.9))
        fy = float(rng.uniform(0.2, 0.9))
        fz = float(rng.uniform(0.2, 1.0))
        cx = float(rng.uniform(-w + fx + 0.2, w - fx - 0.2))
        cy = float(rng.uniform(-d + fy + 0.2, d - fy - 0.2))
        boxes.append((np.array([cx, cy, -h + fz]), np.array([fx, fy, fz])))
    return boxes


def room_scene(n_points: int, seed: int = 0, sample: int = 0) -> np.ndarray:
    """Area-proportional surface sampling of a procedural room scene.

    (seed) fixes the geometry; (seed, sample) fixes the surface sampling,
    so two `sample` values are independent scans of one room."""
    geom_rng = np.random.default_rng(seed)
    boxes = _room_boxes(geom_rng)
    rng = np.random.default_rng((seed, sample, 17))
    areas = np.array([8 * (s[0] * s[1] + s[1] * s[2] + s[0] * s[2])
                      for _, s in boxes])
    counts = rng.multinomial(n_points, areas / areas.sum())
    parts = []
    for (c, s), m in zip(boxes, counts):
        fa = np.array([s[1] * s[2], s[1] * s[2], s[0] * s[2],
                       s[0] * s[2], s[0] * s[1], s[0] * s[1]])
        face = rng.choice(6, size=m, p=fa / fa.sum())
        u = rng.uniform(-1, 1, (m, 3)) * s
        axis = face // 2
        u[np.arange(m), axis] = np.where(face % 2 == 0, s[axis], -s[axis])
        parts.append(c + u)
    return np.concatenate(parts, axis=0).astype(np.float32)


def room_pair(n_points: int = 200_000, seed: int = 0,
              noise: float = 0.01) -> Tuple[np.ndarray, np.ndarray, Dict]:
    """(source, target, gt): two independent scans of one room, the source
    moved by a known rigid transform, both with ~1 cm of sensor noise."""
    tgt = room_scene(n_points, seed, sample=0)
    base = room_scene(n_points, seed, sample=1)
    rng = np.random.default_rng((seed, 99))
    gt = {"R": rot_xyz(0.9, 2.2, 1.3), "s": 1.0,
          "t": np.array([1.5, -0.8, 0.6])}
    src = (base @ gt["R"].T) * gt["s"] + gt["t"]
    src = src + rng.normal(scale=noise, size=src.shape)
    tgt = tgt + rng.normal(scale=noise, size=tgt.shape)
    return src.astype(np.float32), tgt.astype(np.float32), gt


def _pad(pts: np.ndarray, pad: int) -> Tuple[np.ndarray, np.ndarray]:
    out = np.zeros((pad, 3), np.float32)
    n = min(len(pts), pad)
    out[:n] = pts[:n]
    m = np.zeros((pad,), bool)
    m[:n] = True
    return out, m


class ScanPair(NamedTuple):
    """A Room pair as run_largescan feeds it: the raw scans and ground truth,
    the ingest normalization, and both normalized scans padded to `pad` rows
    on the device, (points (pad, 3), mask (pad,)) each."""
    src: np.ndarray
    tgt: np.ndarray
    gt: Dict
    center: np.ndarray
    nscale: float
    source: Tuple[torch.Tensor, torch.Tensor]
    target: Tuple[torch.Tensor, torch.Tensor]


def normalized_pair(n_points: int, seed: int, device) -> ScanPair:
    """room_pair(n_points, seed), normalized into the unit cube by one factor
    from the target (LoadPointCloud.hpp:347-427: the escalation gate is a
    unit-scale quantity) on the host in float32, as JAX does it, and padded to
    a multiple of 4096 rows on `device`."""
    src, tgt, gt = room_pair(n_points, seed)
    center = tgt.mean(axis=0)
    nscale = float(np.abs(tgt - center).max())
    pad = ((max(len(src), len(tgt)) + 4095) // 4096) * 4096
    clouds = [tuple(torch.as_tensor(x).to(device) for x in _pad(((c - center) / nscale).astype(np.float32), pad))
              for c in (src, tgt)]
    return ScanPair(src, tgt, gt, center, nscale, *clouds)


def compact(points: torch.Tensor, keep: torch.Tensor, out_pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The survivors gathered to the front of an `out_pad`-row cloud, in
    their sorted order (a stable sort of ~keep): FPS scans its whole padded
    width every step, so it runs on the survivors' width, not the scan's."""
    order = torch.argsort((~keep).to(torch.uint8), stable=True)[:out_pad]
    return points[order], keep[order]


def compacted_pad(n_s: int, n_t: int) -> int:
    """The compacted clouds' rows: the larger survivor count, to 4096."""
    return ((max(n_s, n_t) + 4095) // 4096) * 4096


def run_largescan(n_points: int = 200_000, pre_downsample: int = 80_000,
                  cfg: Optional[KSSICPConfig] = None, seed: int = 0, repeats: int = 1,
                  device="cuda") -> Dict:
    """The Room-class large-scan run of kss_icp_tpu/largescan.py::run_largescan
    on `device` (default the card): timings, accuracy and the metric's rate.

    Stages, each timed to a `torch.cuda.synchronize()` on the card:
      octree_s    voxel downsample of both scans to about `pre_downsample`
                  points each;
      register_s  compaction, one `fps` launch over both clouds, and
                  register_resampled; a pair whose fitness is above
                  `escalate_threshold` (with `auto_escalate`) is solved once
                  more at `escalation_config()` and the lower fitness kept
                  (largescan's own rule, not the escalation ladder);
      metric_s    the aligned full-resolution source against the target,
                  one `nn1` launch.
    The first run includes the kernels' build and first launches
    (`compile_first_total_s`); the stage times are the fastest of `repeats`
    runs, the answers the last run's.

    Returns JAX's keys with JAX's meaning ("pnumber" is resample_count of
    `pre_downsample` twice; "rmse" and "pose_rmse" in scene units) and these:
    "device"; "nscale" (the ingest normalization's scale); "n_s", "n_t" (the
    octree survivors) and "resample_count" (the pnumber the run used);
    "base_fitness", "escalated", "escalation_won"; "unit_rmse" (the metric in
    the unit cube, unrounded). "metric_tflops" is JAX's FLOP count, 6 x
    |source| x pad, over this device's metric seconds, so that the two dicts
    line up: the exact-difference kernel does not run that work."""
    cfg = cfg or DEFAULT_CONFIG
    device = kss._device(device)
    scan = normalized_pair(n_points, seed, device)
    (sp, sm), (tp, tm) = scan.source, scan.target
    pad = sp.shape[0]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def run_once():
        times, info = {}, {}
        sync()
        t0 = time.perf_counter()
        s_ds, skeep = octree_simplify(sp, sm, pre_downsample)
        t_ds, tkeep = octree_simplify(tp, tm, pre_downsample)
        sync()
        times["octree_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        n_s, n_t = int(skeep.sum()), int(tkeep.sum())
        pnumber = cfg.resample_count(n_s, n_t)
        ds_pad = compacted_pad(n_s, n_t)
        s_c, sk_c = compact(s_ds, skeep, ds_pad)
        t_c, tk_c = compact(t_ds, tkeep, ds_pad)
        (rs, rsm), (rt, rtm) = kss.resample_pairs(s_c[None], sk_c[None], t_c[None], tk_c[None],
                                                  torch.tensor([pnumber], device=device), cfg, steps=pnumber)
        res = kss.register_resampled(rs[0], rsm[0], rt[0], rtm[0], cfg)
        fit = base = float(res.fitness)
        escalated = won = False
        if cfg.auto_escalate and fit > cfg.escalate_threshold:
            escalated = True
            res2 = kss.register_resampled(rs[0], rsm[0], rt[0], rtm[0], cfg.escalation_config())
            if float(res2.fitness) < fit:
                res, fit, won = res2, float(res2.fitness), True
        sync()
        times["register_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        aligned = apply_similarity(res.transform, sp)
        unit_rmse = float(registration_measure_padded(aligned, sm, tp, tm)["rmse"])
        sync()
        times["metric_s"] = time.perf_counter() - t0
        times["total_s"] = sum(times.values())
        info.update(n_s=n_s, n_t=n_t, resample_count=pnumber, base_fitness=base, escalated=escalated,
                    escalation_won=won, unit_rmse=unit_rmse)
        return times, res, fit, unit_rmse * scan.nscale, info

    times, res, fit, rmse, info = run_once()
    compile_total = times["total_s"]
    best = times
    for _ in range(max(repeats - 1, 0)):
        t2, res, fit, rmse, info = run_once()
        if t2["total_s"] < best["total_s"]:
            best = t2

    src_n = sp[: len(scan.src)]
    aligned_np = apply_similarity(res.transform, src_n).cpu().numpy() * scan.nscale + scan.center
    pose = transform_rmse(aligned_np, scan.src, scan.gt)
    metric_flops = 6.0 * len(scan.src) * pad
    return {
        "n_points": int(len(scan.src)),
        "pre_downsample": int(pre_downsample),
        "pnumber": int(cfg.resample_count(pre_downsample, pre_downsample)),
        **{k: round(v, 4) for k, v in best.items()},
        "compile_first_total_s": round(compile_total, 2),
        "fitness": round(fit, 8),
        "rmse": round(rmse, 6),
        "pose_rmse": round(pose, 6),
        "metric_tflops": round(metric_flops / best["metric_s"] / 1e12, 3),
        "device": str(device),
        "nscale": scan.nscale,
        **info,
    }
