"""Record the JAX package's answers, the reference the PyTorch port is held to.

Three records, each a JSON file under fixtures/:

* default: `kss_icp_tpu.register_pair` on the CPU with auto_escalate=False
  on the 25 remesh fixture pairs, at DEFAULT_CONFIG and at
  bench.bench_config(), written to fixtures/torch_port_expected.json;
* `--escalation`: escalation on with overlap_escalate=False (the overlap
  tier is not ported yet) on the remesh 25 at DEFAULT_CONFIG and at
  bench_config(), and on the category, deform and scale boards of
  kss_icp_tpu/challenge.py (48 pairs) at DEFAULT_CONFIG, written to
  fixtures/torch_port_expected_escalation.json;
* `--overlap`: the unmodified DEFAULT_CONFIG (escalation and its overlap
  tier on) on the remesh 25 and on all five boards of
  `challenge_corpus(include_hard=True)` (64 pairs: category 32, partial 8,
  deform 8, scale 8, partial_hard 8), written to
  fixtures/torch_port_expected_overlap.json. On the CPU the partial
  boards' pairs take about 460 s each; `--shard I/N` runs every Nth pair,
  so N processes can share the work, and `--merge` joins their records;
* `--batch`: the batched path, `kss_icp_tpu.register_many` at the
  unmodified DEFAULT_CONFIG with full_pad 8192, on the remesh 25 as one
  batch and on the 64 pairs of the five boards as another, written to
  fixtures/torch_port_expected_batch.json. Per-pair answers depend on
  the batch's other pairs by float rounding only (tests/test_torch_batch.py),
  so a `--shard I/N` run registers its pairs as a sub-batch of each, and
  `--merge` joins the records as for `--overlap`; the record lists each
  shard's sub-batches under `batches`. JAX on the CPU holds about 2 GiB a
  pair in flight (each batch's peak RSS is printed), so the remesh 25 as
  one batch needs about 50 GiB;
* `--largescan`: the large-scan path of kss_icp_tpu/largescan.py at
  DEFAULT_CONFIG, 200k-point Room pairs and an 80k pre-downsample, for seeds
  0, 1 and 2, written to fixtures/torch_port_expected_largescan.json. The
  script calls JAX's own pieces in run_largescan's order (octree_simplify,
  the compaction, resample_pairs, register_resampled and largescan's own
  escalation rule, registration_measure_padded) and records, per seed,
  `nscale`, the survivor counts `n_s` and `n_t`, a SHA-256 of each side's
  survivors (the kept points in sorted order, float32 bytes), `pnumber`,
  the base fitness, whether the pair escalated and the re-solve won, the
  final fitness, the transform, the unit-scale and scene RMSE and
  `pose_rmse`; then it runs run_largescan itself and checks that its dict
  agrees. About 400 s a seed on an 8-core CPU, most of it the two
  full-resolution metrics;
* `--precise`: precision mode, `KSSICPConfig(neighborhood_fracs=(0.25,
  0.5))`, the config the CLI's `--precise` flag builds (DEFAULT_CONFIG with
  the winner-neighborhood restarts), through register_pair on the remesh 25
  and the 32-pair category board, written to
  fixtures/torch_port_expected_precise.json. Each pair also records the
  DEFAULT_CONFIG record's fitness (fixtures/torch_port_expected_overlap.json)
  and whether a restart won against it (`restart_won`: a lower fitness).
  `--shard`/`--merge` as for `--overlap`;
* `--variants`: every register_pair knob beside the defaults, at the
  unmodified DEFAULT_CONFIG with one knob changed each:
  icp_variant="point_to_plane", coarse_error_metric "max" and "diff" and
  resampler="aivs", through register_pair on the remesh 25 (`variants`);
  register_many on the remesh 25 at "aivs" and "point_to_plane" (`many`, in
  sub-batches of MANY_CHUNK pairs, listed under `batches`: JAX holds about 2
  GiB a pair in flight); the category board at "point_to_plane" (`boards`);
  the AIVS picks register_pair makes on each remesh cloud at "aivs"
  (`aivs_picks`: the source indices of the packed valid rows, in order);
  and `aivs_resample` as the CLI's `simplify -m aivs -n 2000` runs it on
  the largest remesh source written with save_xyz and read back
  (`cli_aivs`: the selected indices, in input order), written to
  fixtures/torch_port_expected_variants.json. `--shard`/`--merge` as for
  `--overlap`;
* `--tools`: the resampling and fixture tools at the CLI's defaults, written
  to fixtures/torch_port_expected_tools.json with the arrays in
  fixtures/torch_port_expected_tools.npz. Four originals of 40960 points,
  `challenge._instance(f, 0, 40960, sample=0)` for the four families, each
  written with save_xyz and read back as the CLI reads it; per original the
  SHA-256 of its float32 points, of farthest_point_sampling's 8000 indices
  (WLOP's start) and of the `.gird` source, `make_pair`'s WLOP target (npz
  `<name>_wlop`) with its spacing CV, on-surface distance and gap to the
  float64 solution (`<name>_wlop_f64`: JAX's steps in float64 from the same
  FPS start, jax_enable_x64), JAX's and the
  float64 support radius, hierarchy_simplify's kept indices at cluster size
  10 (`<name>_hierarchy`), simplification_measure(original, its WLOP) with
  JAX's PCA normals of the WLOP (`<name>_wlop_normals`) and the same
  projection in float64 with those normals, the pipeline's
  radius (JAX's and float64) and border on the [-1, 1]³ cloud, and
  register_pair's RMSE at DEFAULT_CONFIG on JAX's own pair, read back from
  the files `save_pair` wrote, as the CLI's `batch` does; then `simplify -m
  wlop -n 2000` (`cli_wlop`, and in float64 `cli_wlop_f64`) and `-m
  hierarchy` (`cli_hierarchy`) on the remesh source that `--variants` gave
  `simplify -m aivs`. About 9 min on an 8-core CPU;
* `--two-stage`: the two-stage converge, DEFAULT_CONFIG with
  refine_max_iterations=8 and refine_polish_iterations=1000, on the remesh
  25 through register_pair (`pairs`) and through register_many in
  sub-batches of MANY_CHUNK pairs (`many`), each pair with `continued`
  (its capped converge was continued: a polish_resampled call at the base
  config in register_pair, a polish_rerun before the first escalate_rerun in
  register_many), written to fixtures/torch_port_expected_two_stage.json.
  `--shard`/`--merge` as for `--overlap`;
* `--analysis`: the analysis ops and the viewer, written to
  fixtures/torch_port_expected_analysis.json with the arrays in
  fixtures/torch_port_expected_analysis.npz: `vcm_edges` on a 4096-point
  tools original (`challenge._instance(0, 0, 4096, sample=0)`) at
  samples_per_point 32 with JAX's samples (`_ball_samples` jitted from the
  key, npz `vcm_samples`) and its matrices, ratios and flags (`vcm_mats`,
  `vcm_ratio`, `vcm_edges`), with the gap of JAX's matrices to the float64
  evaluation and JAX's sample owners that are not float64's; `lloyd_relax`
  of 1024 seeded sites at resolution 512 for 10 steps (`lloyd_sites`, and
  the float64 iteration with exact labels, `lloyd_sites_f64`), with JAX's
  first-step labels that are not float64's; and the sha256 of the PNGs
  that JAX's `view` writes with `--spin 0.3` on remesh pair 0 (target and
  source) and on Room seed 0's 200k target, each written with save_xyz.

Per pair: the chosen candidate, ICP fitness, ICP iteration count, the
hit-cap flag, the similarity transform and the full-resolution RMSE; with
`--escalation` also whether the pair was flagged for the 16^3 re-solve
(`escalated`), whether the re-solve won keep-better (`escalation_won`),
whether the uncapped finisher ran (`finisher`), and on the boards the pose
error against the ground truth (`pose_rmse`) and its pass/fail at the
board's threshold. With `--overlap`, each pair also lists the overlap
tier's rungs (`overlap8`, `overlap16`, `overlap_screen`) that register_pair
reached, each with the incumbent's trimmed fitness `tf_old`, whether the
crop-signature gate skipped it, and, for a rung that ran, its trimmed
fitness `tf_new` and whether it was adopted. With `--batch` the same keys
come from wrapping register_many's escalate_rerun, polish_rerun and
overlap_rerun (kss_icp_torch.ladder_log.LadderLog); a rung is listed where the pair's
fitness was above overlap_threshold when the rung began. chip_smoke.py and tests/test_torch_expected.py hold the
port to these records.

    JAX_PLATFORMS=cpu python scripts/torch_port_expected.py [--escalation | --overlap | --batch | --largescan
        | --precise | --variants | --tools | --two-stage | --analysis] [--limit N] [--shard I/N] [--out PATH]
    python scripts/torch_port_expected.py [--overlap | --batch | --precise | --variants | --two-stage]
        --merge SHARD.json ... [--out PATH]

About 16 s per remesh pair at DEFAULT_CONFIG and 8 s at the bench config on
an 8-core x86 CPU with escalation off.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import resource
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "fixtures"
BOARDS = ("category", "deform", "scale")
FULL_PAD = 8192  # register_many's default pad, which the remesh targets (up to 8000 points) fit
PRECISE_FRACS = (0.25, 0.5)  # the CLI's --precise (kss_icp_tpu/cli.py:47-53)
# run_largescan's arguments as the CLI's largescan subcommand and bench.py pass them.
LARGESCAN = dict(n_points=200_000, pre_downsample=80_000, seeds=(0, 1, 2))
# --variants: each knob set alone on DEFAULT_CONFIG; register_many runs the first two.
VARIANTS = {"aivs": dict(resampler="aivs"), "point_to_plane": dict(icp_variant="point_to_plane"),
            "max": dict(coarse_error_metric="max"), "diff": dict(coarse_error_metric="diff")}
MANY_CHUNK = 2  # register_many sub-batch: pairs a call
CLI_AIVS_COUNT = 2000  # simplify -m aivs -n 2000
# --tools: the originals' size (about the Stanford Bunny's 35947 vertices), the
# CLI's make-pairs, simplify and hierarchy defaults, and each original's
# perturbation (axis, angle, scale, translation).
TOOLS = dict(n_points=40960, wlop_points=8000, wlop_iterations=20, cluster_size=10, simplify_count=2000)
TOOLS_RECORDS = {"se": ("x", 0.7, 1.0, 0.0), "rev": ("y", 1.2, 0.9, 0.0), "box": ("z", -0.9, 1.0, 0.15),
                 "tube": ("x", 1.56, 1.1, -0.1)}
# --two-stage: the knobs set on DEFAULT_CONFIG.
TWO_STAGE = dict(refine_max_iterations=8, refine_polish_iterations=1000)
# --analysis: VCM on one tools family at 4096 points, Lloyd from seeded sites in
# the unit square, the viewer's drag.
ANALYSIS = dict(vcm_family=0, vcm_points=4096, samples_per_point=32, offset_radius=0.1, convolve_radius=0.1,
                threshold=0.16, vcm_key=0, lloyd_sites=1024, lloyd_resolution=512, lloyd_iterations=10,
                lloyd_seed=0, bbox=[0.0, 0.0, 1.0, 1.0], view_spin=0.3)

ESCALATION_NOTE = (
    "JAX on the CPU scores the rotation field on its XLA path whatever coarse_method says "
    "(kss_icp_tpu/models/coarse.py:65-68,106), so these records serve the port's "
    "coarse_method='vpu' and 'dot' runs alike.")


class _Counts:
    """Wraps the JAX escalation hooks of register_pair to see which branch ran."""

    def __init__(self, kss, escalate):
        self.kss, self.escalate = kss, escalate
        self.orig_rerun, self.orig_polish = escalate.escalate_rerun, kss.polish_resampled
        self.reset()

    def reset(self):
        self.flagged = self.won = self.finished = self.continued = 0

    def __enter__(self):
        def rerun(*a, **kw):
            out = self.orig_rerun(*a, **kw)
            self.flagged += out[3]
            self.won += len(out[2])
            return out

        def polish(*a, **kw):
            # The two-stage continuation polishes at the base config, the
            # finisher at escalation_config(), whose refine_polish_iterations is 0.
            if a[-1].refine_polish_iterations:
                self.continued += 1
            else:
                self.finished += 1
            return self.orig_polish(*a, **kw)

        self.escalate.escalate_rerun = rerun
        self.kss.polish_resampled = polish
        return self

    def __exit__(self, *exc):
        self.escalate.escalate_rerun = self.orig_rerun
        self.kss.polish_resampled = self.orig_polish


BATCH_CONFIG = (
    "DEFAULT_CONFIG (escalation and the overlap tier on) through register_many, full_pad 8192, in the "
    "sub-batches listed under `batches`: each shard made one register_many call over its remesh pairs and one "
    "over its board pairs. A pair's answer moves with the batch's other pairs by float rounding only "
    "(tests/test_torch_batch.py).")


def batch_items(remesh, boards, shard: int, shards: int, limit: int = 0):
    """The pairs of `--batch` shard I/N: the remesh pairs whose index is I
    mod N, and every Nth of the boards' 64 pairs from the Ith on (so the 16
    partial pairs spread over the shards), each item (index in its corpus,
    pair, (board, threshold) or None); `limit` keeps the first pairs of each
    corpus."""
    remesh_items = [(i, p, None) for i, p in enumerate(remesh[:limit or None]) if i % shards == shard]
    flat = [(i, p, (b, thr)) for b, corpus, thr in boards for i, p in enumerate(corpus)]
    board_items = [item for k, item in enumerate(flat) if k % shards == shard and (not limit or item[0] < limit)]
    return remesh_items, board_items


def survivor_digest(points: np.ndarray, keep: np.ndarray) -> str:
    """SHA-256 of the survivors of a voxel downsample: the kept rows of its
    sorted output, in order, as float32 bytes (tests/test_torch_largescan.py
    computes the same of the port's)."""
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(np.asarray(points, np.float32)[np.asarray(keep)]).tobytes()).hexdigest()


def record_largescan(seed: int, n_points: int, pre_downsample: int) -> dict:
    """kss_icp_tpu/largescan.py::run_largescan's stages for one seed at
    DEFAULT_CONFIG, piece by piece, then run_largescan itself, whose dict must
    agree with the pieces."""
    import jax
    import jax.numpy as jnp

    from kss_icp_tpu.challenge import transform_rmse
    from kss_icp_tpu.config import DEFAULT_CONFIG as cfg
    from kss_icp_tpu.core.transforms import apply_similarity
    from kss_icp_tpu.largescan import _pad, room_pair, run_largescan
    from kss_icp_tpu.metrics import registration_measure_padded
    from kss_icp_tpu.models.kss_icp import register_resampled, resample_pairs
    from kss_icp_tpu.ops.simplify import octree_simplify

    t0 = time.perf_counter()
    src, tgt, gt = room_pair(n_points, seed)
    center = tgt.mean(axis=0)
    nscale = float(np.abs(tgt - center).max())
    src_n = ((src - center) / nscale).astype(np.float32)
    tgt_n = ((tgt - center) / nscale).astype(np.float32)
    pad = ((max(len(src), len(tgt)) + 4095) // 4096) * 4096
    sp, sm = (jnp.asarray(x) for x in _pad(src_n, pad))
    tp, tm = (jnp.asarray(x) for x in _pad(tgt_n, pad))
    octree = jax.jit(octree_simplify, static_argnames=("target_points",))  # as run_largescan jits it
    s_ds, skeep = octree(sp, sm, target_points=pre_downsample)
    t_ds, tkeep = octree(tp, tm, target_points=pre_downsample)
    n_s, n_t = int(jnp.sum(skeep)), int(jnp.sum(tkeep))
    pnumber = cfg.resample_count(n_s, n_t)
    ds_pad = ((max(n_s, n_t) + 4095) // 4096) * 4096

    @jax.jit
    def compact(pts, keep):
        order = jnp.argsort(jnp.logical_not(keep), stable=True)
        return pts[order][:ds_pad], keep[order][:ds_pad]

    s_c, sk_c = compact(s_ds, skeep)
    t_c, tk_c = compact(t_ds, tkeep)
    (rs, rsm), (rt, rtm) = resample_pairs(s_c[None], sk_c[None], t_c[None], tk_c[None],
                                          jnp.asarray([pnumber], jnp.int32), cfg)
    res = register_resampled(rs[0], rsm[0], rt[0], rtm[0], cfg)
    base_fit = fit = float(res.fitness)
    escalated = bool(cfg.auto_escalate and fit > cfg.escalate_threshold)
    won = False
    if escalated:
        res2 = register_resampled(rs[0], rsm[0], rt[0], rtm[0], cfg.escalation_config())
        won = float(res2.fitness) < fit
        if won:
            res, fit = res2, float(res2.fitness)
    aligned = apply_similarity(res.transform, sp)
    m = registration_measure_padded(aligned, sm, tp, tm, chunk=4096, use_pallas=False)
    unit_rmse = float(m["rmse"])
    aligned_np = np.asarray(apply_similarity(res.transform, jnp.asarray(src_n))) * nscale + center
    pose = transform_rmse(aligned_np, src, gt)
    tr = res.transform
    rec = {
        "seed": seed, "n_points": int(len(src)), "pad": pad, "nscale": nscale,
        "n_s": n_s, "n_t": n_t, "ds_pad": ds_pad, "pnumber": pnumber,
        "survivors_sha256": {"source": survivor_digest(s_ds, skeep), "target": survivor_digest(t_ds, tkeep)},
        "base_fitness": base_fit, "escalated": escalated, "escalation_won": won, "fitness": fit,
        "chosen_candidate": int(res.chosen_candidate), "icp_iterations": int(res.icp_iterations),
        "scale": float(tr.scale), "rotation": np.asarray(tr.rotation, np.float64).tolist(),
        "translation": np.asarray(tr.translation, np.float64).tolist(),
        "unit_rmse": unit_rmse, "rmse": unit_rmse * nscale, "pose_rmse": float(pose),
    }
    pieces_s = time.perf_counter() - t0
    out = run_largescan(n_points, pre_downsample, cfg, seed, repeats=1)
    agree = {"fitness": round(fit, 8), "rmse": round(unit_rmse * nscale, 6), "pose_rmse": round(pose, 6),
             "pnumber": cfg.resample_count(pre_downsample, pre_downsample), "n_points": int(len(src))}
    differ = {k: (v, out[k]) for k, v in agree.items() if out[k] != v}
    if differ:
        raise SystemExit(f"seed {seed}: run_largescan's dict disagrees with its pieces: {differ}")
    rec["run_largescan"] = out
    rec["seconds"] = {"pieces": pieces_s, "run_largescan": time.perf_counter() - t0 - pieces_s}
    print(f"seed {seed}: n_s={n_s} n_t={n_t} pnumber={pnumber} ds_pad={ds_pad} base_fit={base_fit:.6g} "
          f"escalated={escalated} won={won} fit={fit:.6g} unit_rmse={unit_rmse:.6f} rmse={rec['rmse']:.6f} "
          f"pose_rmse={pose:.6f} ({pieces_s:.0f} s + {rec['seconds']['run_largescan']:.0f} s)",
          file=sys.stderr, flush=True)
    return rec


def record_variants(args, shard: int, shards: int, run, run_batch, remesh, platform: str) -> dict:
    """The `--variants` record of shard I/N: its remesh pairs (index I mod N)
    and category pairs through register_pair, its remesh pairs through
    register_many in sub-batches of MANY_CHUNK, the AIVS picks of its remesh
    pairs' clouds, and (shard 0) the CLI's aivs_resample."""
    import tempfile

    import jax.numpy as jnp

    from kss_icp_tpu.challenge import challenge_corpus
    from kss_icp_tpu.config import DEFAULT_CONFIG
    from kss_icp_tpu.core.cloud import PointCloud
    from kss_icp_tpu.io.formats import load_points, save_xyz
    from kss_icp_tpu.models import kss_icp as kss
    from kss_icp_tpu.ops.aivs import aivs_resample

    def cfg_of(label):
        return dataclasses.replace(DEFAULT_CONFIG, **VARIANTS[label])

    mine = [(i, p) for i, p in enumerate(remesh[: args.limit or None]) if i % shards == shard]
    # The cheap records first: register_pair's AIVS resample of each cloud, as
    # kss.register_pair runs it, and the CLI's.
    cfg = cfg_of("aivs")
    picks = []
    for i, (name, src, tgt, _) in mine:
        clouds = [PointCloud.from_points(x) for x in (src, tgt)]
        n_s, n_t = (int(c.count) for c in clouds)
        pn = cfg.resample_count(n_s, n_t)
        rcfg = kss._resolve_aivs_boxes(cfg, max(n_s, n_t))
        row = {"name": name, "index": i, "pnumber": pn, "boxes": rcfg.aivs_boxes_per_axis}
        for side, c, pts in (("source", clouds[0], src), ("target", clouds[1], tgt)):
            rp, rm = kss.resample_batch(c.points[None], c.mask[None], jnp.asarray([pn]), rcfg)
            row[side] = _match_rows(np.asarray(rp[0])[np.asarray(rm[0])], pts)
        picks.append(row)
        print(f"{name}: AIVS picks {pn} of {n_s} and {n_t} points, {rcfg.aivs_boxes_per_axis}^3 boxes",
              file=sys.stderr, flush=True)

    cli_aivs = None
    if shard == 0:
        name, src, _, _ = max(remesh, key=lambda p: len(p[1]))
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / f"{name}.gird"
            save_xyz(path, src)
            pts = load_points(path)
        cloud = PointCloud.from_points(pts)
        _, sel = aivs_resample(cloud.points, cloud.mask, CLI_AIVS_COUNT)
        selected = np.nonzero(np.asarray(sel))[0]
        cli_aivs = {"name": name, "file": f"{name}.gird", "count": CLI_AIVS_COUNT, "n": int(len(pts)),
                    "selected": selected.tolist(), "n_selected": int(len(selected))}
        print(f"simplify -m aivs on {name}.gird: {len(pts)} -> {len(selected)} points", file=sys.stderr, flush=True)
    out = {
        "platform": platform,
        "note": ESCALATION_NOTE,
        "rmse_band": 0.006,
        "config": "DEFAULT_CONFIG (escalation and the overlap tier on) with one knob changed",
        "aivs_picks": picks,
        "cli_aivs": cli_aivs,
        "variants": {label: {"knobs": knobs, "pairs": run(cfg_of(label), remesh)} for label, knobs in VARIANTS.items()},
    }
    category = next((corpus, thr) for b, corpus, thr in challenge_corpus(include_hard=True) if b == "category")
    out["boards"] = {"category": {"threshold": category[1], "knobs": VARIANTS["point_to_plane"],
                                  "pairs": run(cfg_of("point_to_plane"), category[0], category[1])}}
    out["many"] = {}
    for label in ("aivs", "point_to_plane"):
        rows, batches = [], []
        for k in range(0, len(mine), MANY_CHUNK):
            items = [(i, p, None) for i, p in mine[k:k + MANY_CHUNK]]
            rows += run_batch(cfg_of(label), items)
            batches.append([p[0] for _, p, _ in items])
        out["many"][label] = {"knobs": VARIANTS[label], "full_pad": FULL_PAD, "batches": batches, "pairs": rows}

    return out


def sha256(a: np.ndarray) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def min_pair_dists(x: np.ndarray) -> np.ndarray:
    """Each point's distance to its nearest other point (tests/test_wlop.py)."""
    from scipy.spatial import cKDTree

    return cKDTree(np.asarray(x, np.float64)).query(np.asarray(x, np.float64), k=2)[0][:, 1]


def radius_f64(points: np.ndarray, k: int = 12) -> float:
    """The support radius (the largest k-NN distance) in float64 from the
    float32 points: the value both packages' float32 radii approximate."""
    from scipy.spatial import cKDTree

    p = np.asarray(points, np.float32).astype(np.float64)
    return float(cKDTree(p).query(p, k=k + 1)[0][:, -1].max())


def wlop_float64(points: np.ndarray, mask: np.ndarray, m: int, iterations: int = 20, mu: float = 0.45):
    """JAX's WLOP steps (kss_icp_tpu/ops/wlop.py:68-88) in float64 from the
    float32 run's FPS start: the solution both packages' float32 runs
    approximate, each with its own rounding. (wlop_resample itself in
    float64 runs its FPS in float64, which can pick another start where two
    points are near-tied.)"""
    import jax
    import jax.numpy as jnp

    from kss_icp_tpu.ops.resample import farthest_point_sampling
    from kss_icp_tpu.ops.wlop import default_radius

    pf = np.asarray(points, np.float32)
    idx, smask = farthest_point_sampling(jnp.asarray(pf), jnp.asarray(mask), m)
    idx, smask = np.asarray(idx), np.asarray(smask)
    jax.config.update("jax_enable_x64", True)
    try:
        p = jnp.asarray(pf.astype(np.float64))
        eps = jnp.finfo(jnp.float64).tiny
        h = default_radius(p, jnp.asarray(mask), m)
        inv_h2 = 16.0 / jnp.maximum(h * h, eps)
        w_in, w_s = jnp.asarray(mask, jnp.float64), jnp.asarray(smask, jnp.float64)
        hi = jax.lax.Precision.HIGHEST

        @jax.jit
        def block(rows, x):
            """The step of the samples `rows` (a block, to bound the memory)."""
            xb = x[rows]
            d2 = jnp.sum((xb[:, None, :] - p[None, :, :]) ** 2, axis=-1)
            alpha = jnp.exp(-d2 * inv_h2) / jnp.sqrt(jnp.maximum(d2, eps)) * w_in[None, :]
            attract = jnp.dot(alpha, p, precision=hi) / jnp.maximum(jnp.sum(alpha, axis=1, keepdims=True), eps)
            diff = xb[:, None, :] - x[None, :, :]
            d2 = jnp.sum(diff ** 2, axis=-1)
            beta = jnp.exp(-d2 * inv_h2) / jnp.sqrt(jnp.maximum(d2, eps)) * w_s[None, :]
            beta = jnp.where(rows[:, None] == jnp.arange(x.shape[0])[None, :], 0.0, beta)
            repulse = jnp.einsum("mk,mki->mi", beta, diff, precision=hi) / jnp.maximum(
                jnp.sum(beta, axis=1, keepdims=True), eps)
            return jnp.where(w_s[rows][:, None] > 0, attract + mu * repulse, xb)

        x = p[idx]
        blocks = np.array_split(np.arange(m), -(-m // 1000))
        for _ in range(iterations):
            x = jnp.concatenate([block(jnp.asarray(r), x) for r in blocks])
        return np.asarray(x * w_s[:, None])
    finally:
        jax.config.update("jax_enable_x64", False)


def measure_float64(original: np.ndarray, simplified: np.ndarray, normals: np.ndarray, iterations: int = 10) -> dict:
    """JAX's MLS projection (kss_icp_tpu/measure_resample.py:57-76) in float64
    on the float32 clouds with the given normals and the float64 12-NN
    radius: the measure both packages' float32 runs approximate."""
    import jax
    import jax.numpy as jnp
    from scipy.spatial import cKDTree

    o64 = np.asarray(original, np.float32).astype(np.float64)
    s64 = np.asarray(simplified, np.float32).astype(np.float64)
    radius = cKDTree(s64).query(s64, k=min(13, len(s64)))[0][:, -1].max()
    jax.config.update("jax_enable_x64", True)
    try:
        eps = jnp.finfo(jnp.float64).tiny
        inv_h2 = 1.0 / max(radius * radius, eps)
        s, nrm = jnp.asarray(s64), jnp.asarray(np.asarray(normals, np.float64))
        hi = jax.lax.Precision.HIGHEST

        @jax.jit
        def project(x):
            for _ in range(iterations):
                w = jnp.exp(-jnp.sum((x[:, None, :] - s[None, :, :]) ** 2, axis=-1) * inv_h2)
                a = jnp.dot(w, s, precision=hi) / jnp.maximum(jnp.sum(w, axis=1, keepdims=True), eps)
                n = jnp.dot(w, nrm, precision=hi)
                n = n / jnp.maximum(jnp.linalg.norm(n, axis=1, keepdims=True), eps)
                x = x + jnp.sum(n * (a - x), axis=1, keepdims=True) * n
            return x

        projected = np.concatenate([np.asarray(project(jnp.asarray(b))) for b in np.array_split(o64, -(-len(o64) // 4096))])
    finally:
        jax.config.update("jax_enable_x64", False)
    disp = np.linalg.norm(projected - o64, axis=1)
    return {"avg_displacement": float(disp.mean()), "max_displacement": float(disp.max()),
            "sampling_rate": len(s64) / len(o64)}


def record_tools(remesh, variants: dict):
    """The `--tools` record and its arrays (module docstring)."""
    import tempfile

    import jax.numpy as jnp
    from scipy.spatial import cKDTree

    from kss_icp_tpu import transfer as jt
    from kss_icp_tpu.challenge import FAMILIES, _instance
    from kss_icp_tpu.config import DEFAULT_CONFIG
    from kss_icp_tpu.core.cloud import PointCloud
    from kss_icp_tpu.core.transforms import apply_similarity
    from kss_icp_tpu.io.formats import load_points, save_xyz, uniform_normalize
    from kss_icp_tpu.measure_resample import simplification_measure
    from kss_icp_tpu.metrics import registration_measure
    from kss_icp_tpu.models.kss_icp import register_pair
    from kss_icp_tpu.ops.normals import estimate_normals
    from kss_icp_tpu.ops.resample import farthest_point_sampling
    from kss_icp_tpu.ops.simplify import hierarchy_simplify
    from kss_icp_tpu.ops.wlop import wlop_resample
    from kss_icp_tpu.pipeline import pipeline_from_points_without_uniform

    n, m = TOOLS["n_points"], TOOLS["wlop_points"]
    arrays, originals = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for f, (name, _) in enumerate(FAMILIES):
            t0 = time.perf_counter()
            save_xyz(tmp / f"{name}.xyz", _instance(f, 0, n, sample=0))
            pts = load_points(tmp / f"{name}.xyz")
            pf = pts.astype(np.float32)
            pj, mj = jnp.asarray(pf), jnp.ones(n, bool)  # 40960 rows: already a multiple of 256
            idx, _ = farthest_point_sampling(pj, mj, m)
            rec = jt.TransferRecord(name, *TOOLS_RECORDS[name])
            pair = jt.make_pair(pts, rec, wlop_points=m, wlop_iterations=TOOLS["wlop_iterations"])
            jt.save_pair(pair, tmp)
            wl = pair.target.astype(np.float32)
            w64 = wlop_float64(pf, np.ones(n, bool), m, TOOLS["wlop_iterations"])
            jax_f64_gap = np.linalg.norm(wl - w64, axis=1)
            diag = float(np.linalg.norm(pf.max(axis=0) - pf.min(axis=0)))
            spacing = min_pair_dists(wl)
            on_surface = float(cKDTree(pf.astype(np.float64)).query(wl.astype(np.float64))[0].max())
            _, keep = hierarchy_simplify(pj, mj, max_cluster_size=TOOLS["cluster_size"])
            wj, wmj = jnp.asarray(wl), jnp.ones(m, bool)
            normals = np.asarray(estimate_normals(wj, wmj, k=12))
            meas = {k: float(v) for k, v in simplification_measure(pj, mj, wj, wmj).items()}
            meas64 = measure_float64(pf, wl, normals)
            unit, _ = uniform_normalize(pts)
            state = pipeline_from_points_without_uniform(unit)
            arrays[f"{name}_wlop"] = wl
            arrays[f"{name}_wlop_f64"] = w64
            arrays[f"{name}_wlop_normals"] = normals
            arrays[f"{name}_hierarchy"] = np.nonzero(np.asarray(keep))[0].astype(np.int32)
            originals.append({
                "name": name, "family": f, "n": n, "points_sha256": sha256(pf),
                "record": dataclasses.asdict(rec), "line": rec.line(),
                "fps_start_sha256": sha256(np.asarray(idx, np.int32)),
                "wlop": {"count": int(len(wl)), "bbox_diag": diag, "spacing_cv": float(spacing.std() / spacing.mean()),
                         "on_surface_max": on_surface,
                         "float64_gap": {"median": float(np.median(jax_f64_gap)) / diag,
                                         "max": float(jax_f64_gap.max()) / diag}},
                "radius": pair.radius, "radius_f64": radius_f64(pf),
                "gird": {"count": int(len(pair.source)), "sha256": sha256(pair.source)},
                "hierarchy": {"count": int(np.asarray(keep).sum())},
                "measure": meas, "measure_f64": meas64,
                "pipeline": {"radius": state.radius, "radius_f64": radius_f64(unit), "border": state.border.tolist(),
                             "count": state.count, "boxes_per_axis": state.boxes_per_axis},
            })
            print(f"{name}: wlop {len(wl)} gird {len(pair.source)} hierarchy {originals[-1]['hierarchy']['count']} "
                  f"radius {pair.radius:.9g} (float64 {originals[-1]['radius_f64']:.9g}) measure {meas} "
                  f"{time.perf_counter() - t0:.0f} s", file=sys.stderr, flush=True)
        for o in originals:  # register_pair on JAX's own pair, as the CLI's batch reads it
            t0 = time.perf_counter()
            src, tgt = load_points(tmp / f"{o['name']}.gird"), load_points(tmp / f"{o['name']}.wlop")
            res = register_pair(src, tgt, DEFAULT_CONFIG)
            aligned = np.asarray(apply_similarity(res.transform, jnp.asarray(src, jnp.float32)))
            o["register"] = {"rmse": float(registration_measure(aligned, tgt.astype(np.float32))["rmse"]),
                             "fitness": float(res.fitness), "n_source": int(len(src)), "n_target": int(len(tgt))}
            print(f"{o['name']}: register_pair RMSE {o['register']['rmse']:.6f} "
                  f"{time.perf_counter() - t0:.0f} s", file=sys.stderr, flush=True)

        cli = variants["cli_aivs"]
        src = next(p[1] for p in remesh if p[0] == cli["name"])
        save_xyz(tmp / cli["file"], src)
        cloud = PointCloud.from_points(load_points(tmp / cli["file"]))
        count = min(TOOLS["simplify_count"], int(cloud.count))
        wl, wm = wlop_resample(cloud.points, cloud.mask, count)
        w64 = wlop_float64(np.asarray(cloud.points), np.asarray(cloud.mask), count)
        _, keep = hierarchy_simplify(cloud.points, cloud.mask, max_cluster_size=TOOLS["cluster_size"])
    arrays["cli_wlop"] = np.asarray(wl)[np.asarray(wm)]
    arrays["cli_wlop_f64"] = w64[np.asarray(wm)]
    diag = float(np.linalg.norm(np.ptp(np.asarray(cloud.points)[np.asarray(cloud.mask)], axis=0)))
    cli_gap = np.linalg.norm(arrays["cli_wlop"] - arrays["cli_wlop_f64"], axis=1) / diag
    arrays["cli_hierarchy"] = np.nonzero(np.asarray(keep))[0].astype(np.int32)
    out = {
        "config": dict(TOOLS, register="DEFAULT_CONFIG through register_pair, as the CLI's batch runs it"),
        "arrays": "fixtures/torch_port_expected_tools.npz",
        "originals": originals,
        "cli_wlop": {"name": cli["name"], "file": cli["file"], "n": int(cloud.count), "count": count,
                     "printed": f"wlop: {int(cloud.count)} -> {len(arrays['cli_wlop'])} points",
                     "float64_gap": {"median": float(np.median(cli_gap)), "max": float(cli_gap.max())}},
        "cli_hierarchy": {"name": cli["name"], "file": cli["file"], "cluster_size": TOOLS["cluster_size"],
                          "printed": f"hierarchy: {int(cloud.count)} -> {len(arrays['cli_hierarchy'])} points"},
    }
    return out, arrays


def vcm_float64(points: np.ndarray, samples: np.ndarray, offset_radius: float, convolve_radius: float,
                samples_per_point: int):
    """VCM in float64 from float32 points and samples: exact owners, matrices
    and ratios (kss_icp_tpu/ops/vcm.py's steps). Returns (owners, mats (P, 9),
    ratio)."""
    p64, s64 = points.astype(np.float64), samples.astype(np.float64)
    owners = np.empty(len(s64), np.int64)
    d2min = np.empty(len(s64))
    for r0 in range(0, len(s64), 4096):
        d2 = ((s64[r0:r0 + 4096, None, :] - p64[None]) ** 2).sum(-1)
        owners[r0:r0 + 4096] = d2.argmin(1)
        d2min[r0:r0 + 4096] = d2.min(1)
    diff = (s64 - p64[owners]) * (d2min <= offset_radius ** 2)[:, None]
    outer = (diff[:, :, None] * diff[:, None, :]).reshape(-1, 9)
    mats = np.zeros((len(p64), 9))
    np.add.at(mats, owners, outer)
    mats *= (4.0 / 3.0) * np.pi * offset_radius ** 3 / samples_per_point
    near = ((p64[:, None, :] - p64[None]) ** 2).sum(-1) <= convolve_radius ** 2
    conv = near.astype(np.float64) @ mats
    evals = np.linalg.eigvalsh(conv.reshape(-1, 3, 3))
    return owners, conv, evals[:, 1] / np.maximum(evals.sum(-1), np.finfo(np.float64).tiny)


def lloyd_float64(sites: np.ndarray, bbox, resolution: int, iterations: int):
    """Lloyd iteration in float64 on the float32 pixel centres, exact labels.
    Returns (final sites, first-step labels)."""
    x0, y0, x1, y1 = bbox
    i = np.arange(resolution, dtype=np.float32) + np.float32(0.5)
    xs = np.float32(x0) + i * np.float32(x1 - x0) / np.float32(resolution)
    ys = np.float32(y0) + i * np.float32(y1 - y0) / np.float32(resolution)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    pix = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float64)
    pts, first = sites.astype(np.float64), None
    for _ in range(iterations):
        labels = np.empty(len(pix), np.int64)
        for r0 in range(0, len(pix), 8192):
            labels[r0:r0 + 8192] = ((pix[r0:r0 + 8192, None, :] - pts[None]) ** 2).sum(-1).argmin(1)
        first = labels if first is None else first
        counts = np.bincount(labels, minlength=len(pts)).astype(np.float64)
        sums = np.stack([np.bincount(labels, pix[:, k], minlength=len(pts)) for k in range(2)], -1)
        pts = np.where(counts[:, None] > 0, sums / np.maximum(counts, 1.0)[:, None], pts)
    return pts, first


def record_analysis(remesh):
    """The `--analysis` record and its arrays (module docstring)."""
    import hashlib
    import tempfile

    import jax
    import jax.numpy as jnp

    from kss_icp_tpu import cli as jcli
    from kss_icp_tpu.challenge import _instance
    from kss_icp_tpu.io.formats import save_xyz
    from kss_icp_tpu.largescan import room_pair
    from kss_icp_tpu.ops.nn import pairwise_sqdist
    from kss_icp_tpu.ops.vcm import _ball_samples, vcm, vcm_edges
    from kss_icp_tpu.ops.voronoi2d import lloyd_relax, voronoi_cells

    a = ANALYSIS
    out, arrays = {"analysis": a}, {}
    t0 = time.perf_counter()
    pts = np.asarray(_instance(a["vcm_family"], 0, a["vcm_points"], sample=0), np.float32)
    mask = jnp.ones(len(pts), bool)
    key = jax.random.PRNGKey(a["vcm_key"])
    r_off, r_conv, spp = a["offset_radius"], a["convolve_radius"], a["samples_per_point"]
    # The samples as vcm draws them: its radius is a traced float32 argument.
    samples = np.asarray(jax.jit(lambda k, p, r: _ball_samples(k, p, jnp.asarray(r, jnp.float32), spp))(
        key, jnp.asarray(pts), r_off))
    edges, ratio = vcm_edges(jnp.asarray(pts), mask, r_off, r_conv, key, a["threshold"], spp)
    mats = np.asarray(vcm(jnp.asarray(pts), mask, r_off, r_conv, key, spp)).reshape(-1, 9)
    jax_owner = np.asarray(jax.jit(lambda s, p: jnp.argmin(pairwise_sqdist(s, p), axis=-1))(
        jnp.asarray(samples), jnp.asarray(pts)))
    owners64, mats64, ratio64 = vcm_float64(pts, samples, r_off, r_conv, spp)
    arrays.update(vcm_points=pts, vcm_samples=samples, vcm_mats=mats, vcm_ratio=np.asarray(ratio),
                  vcm_edges=np.asarray(edges))
    scale = float(np.abs(mats64).max())
    out["vcm"] = {"points_sha256": sha256(pts), "n_samples": int(len(samples)),
                  "jax_owners_not_float64": int((jax_owner != owners64).sum()),
                  "jax_mats_max_gap": float(np.abs(mats - mats64).max() / scale),
                  "jax_ratio_max_gap": float(np.abs(np.asarray(ratio) - ratio64).max()),
                  "edges": int(np.asarray(edges).sum()), "edges_float64": int((ratio64 >= a["threshold"]).sum()),
                  "seconds": time.perf_counter() - t0}
    print(f"vcm: {out['vcm']}", file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    bbox = tuple(a["bbox"])
    sites = np.random.default_rng(a["lloyd_seed"]).uniform(0.0, 1.0, (a["lloyd_sites"], 2)).astype(np.float32)
    smask = jnp.ones(len(sites), bool)
    res, iters = a["lloyd_resolution"], a["lloyd_iterations"]
    relaxed = np.asarray(lloyd_relax(jnp.asarray(sites), smask, bbox, res, iters))
    labels = np.asarray(voronoi_cells(jnp.asarray(sites), smask, bbox, res).labels).reshape(-1)
    relaxed64, labels64 = lloyd_float64(sites, bbox, res, iters)
    arrays.update(lloyd_start=sites, lloyd_sites=relaxed, lloyd_sites_f64=relaxed64)
    out["lloyd"] = {"jax_labels_not_float64": int((labels != labels64).sum()),
                    "jax_max_gap": float(np.abs(relaxed - relaxed64).max()),
                    "seconds": time.perf_counter() - t0}
    print(f"lloyd: {out['lloyd']}", file=sys.stderr, flush=True)

    views = []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        name, src, tgt, _ = remesh[0]
        save_xyz(tmp / f"{name}.gird", src)
        save_xyz(tmp / f"{name}.wlop", tgt)
        save_xyz(tmp / "room0_target.xyz", room_pair(200_000, 0)[1])
        for label, files in ((f"remesh {name}", [f"{name}.wlop", "-s", f"{name}.gird"]),
                             ("room seed 0 target", ["room0_target.xyz"])):
            argv = ["view"] + files + ["-o", "view.png", "--spin", str(a["view_spin"])]
            t0 = time.perf_counter()
            if jcli.main([str(tmp / x) if (tmp / x).suffix in (".gird", ".wlop", ".xyz", ".png") else x
                          for x in argv]) != 0:
                raise SystemExit(f"JAX's view failed on {label}")
            digest = hashlib.sha256((tmp / "view.png").read_bytes()).hexdigest()
            views.append({"label": label, "argv": argv, "png_sha256": digest, "seconds": time.perf_counter() - t0})
            print(f"view {label}: {digest}", file=sys.stderr, flush=True)
    out["views"] = views
    return out, arrays


def dump_record(out: dict) -> str:
    """The record as indented JSON, each list of integers (the AIVS picks) on
    one line."""
    text = json.dumps(out, indent=1)
    ints = r"\[\s+(-?\d+(?:,\s+-?\d+)*)\s+\]"
    return re.sub(ints, lambda m: "[" + " ".join(m.group(1).split()) + "]", text) + "\n"


def _match_rows(rows: np.ndarray, points: np.ndarray) -> list:
    """The index in `points` of each row (exact float32 bytes; the first of
    duplicates)."""
    first = {}
    for i, p in enumerate(np.asarray(points, np.float32)):
        first.setdefault(p.tobytes(), i)
    return [first[np.asarray(r, np.float32).tobytes()] for r in rows]


def merge(paths, out_path) -> int:
    """One record from the shards' records: every list of pairs joined and
    put back in corpus order, the shards' batches listed, the seconds
    summed."""
    parts = [json.loads(p.read_text()) for p in paths]
    out = parts[0]

    def join(get):
        return sorted((r for part in parts for r in get(part)), key=lambda r: r["index"])

    for key in ("pairs", "aivs_picks"):
        if key in out:
            out[key] = join(lambda part: part[key])
    for group in ("variants", "many"):
        for label in out.get(group, {}):
            out[group][label]["pairs"] = join(lambda part: part[group][label]["pairs"])
            if "batches" in out[group][label]:
                out[group][label]["batches"] = [b for part in parts for b in part[group][label]["batches"]]
    if "cli_aivs" in out:
        out["cli_aivs"] = next(part["cli_aivs"] for part in parts if part["cli_aivs"])
    if "bench_config" in out:
        out["bench_config"]["pairs"] = join(lambda part: part["bench_config"]["pairs"])
    for b in out.get("boards", {}):
        out["boards"][b]["pairs"] = join(lambda part: part["boards"][b]["pairs"])
    if "batches" in out and "many" not in out:
        out["batches"] = sorted((b for part in parts for b in part["batches"]),
                                key=lambda b: int(b["shard"].split("/")[0]))
        out["shards"] = len(out["batches"])
    out["seconds"] = sum(part["seconds"] for part in parts)
    out_path.write_text(dump_record(out))
    print(f"wrote {out_path} from {len(parts)} shards", file=sys.stderr)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--escalation", action="store_true",
                      help="record escalation on (overlap_escalate=False), boards included")
    mode.add_argument("--overlap", action="store_true",
                      help="record the unmodified DEFAULT_CONFIG (the overlap tier on), all five boards")
    mode.add_argument("--batch", action="store_true",
                      help="record register_many at the unmodified DEFAULT_CONFIG: remesh 25, all five boards")
    mode.add_argument("--largescan", action="store_true",
                      help="record run_largescan's stages at DEFAULT_CONFIG on 200k-point Room pairs, seeds 0-2")
    mode.add_argument("--precise", action="store_true",
                      help="record precision mode (--precise) through register_pair: remesh 25, category board")
    mode.add_argument("--variants", action="store_true",
                      help="record the register_pair knobs (point_to_plane, max, diff, aivs) at DEFAULT_CONFIG")
    mode.add_argument("--tools", action="store_true",
                      help="record WLOP, hierarchy_simplify, make_pair, simplification_measure and the pipeline at "
                           "40960 points, and simplify -m wlop|hierarchy")
    mode.add_argument("--two-stage", action="store_true",
                      help="record the two-stage converge through register_pair and register_many: remesh 25")
    mode.add_argument("--analysis", action="store_true",
                      help="record vcm_edges at 4096 points, lloyd_relax at 1024 sites, and view's PNG digests")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--limit", type=int, default=0,
                    help="only the first N pairs of each corpus (0 = all)")
    ap.add_argument("--shard", default="0/1",
                    help="I/N: only the pairs whose index in their corpus is I mod N (run N at once, then --merge)")
    ap.add_argument("--merge", type=Path, nargs="+", default=None,
                    help="join the records that --shard runs wrote, in corpus order, into --out (or the "
                         "mode's fixture)")
    args = ap.parse_args()
    out_path = args.out or FIXTURES / ("torch_port_expected_escalation.json" if args.escalation else
                                       "torch_port_expected_overlap.json" if args.overlap else
                                       "torch_port_expected_batch.json" if args.batch else
                                       "torch_port_expected_largescan.json" if args.largescan else
                                       "torch_port_expected_precise.json" if args.precise else
                                       "torch_port_expected_variants.json" if args.variants else
                                       "torch_port_expected_tools.json" if args.tools else
                                       "torch_port_expected_two_stage.json" if args.two_stage else
                                       "torch_port_expected_analysis.json" if args.analysis else
                                       "torch_port_expected.json")
    if args.merge:
        return merge(args.merge, out_path)

    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(REPO))
    from kss_icp_tpu import escalate
    from kss_icp_tpu.challenge import (category_corpus, challenge_corpus, deform_corpus, scale_corpus,
                                       transform_rmse)
    from kss_icp_tpu.config import DEFAULT_CONFIG
    from kss_icp_tpu.core.transforms import apply_similarity
    from kss_icp_tpu.metrics import registration_measure
    from kss_icp_tpu.models import kss_icp as kss
    from kss_icp_tpu.stress import remesh_corpus

    from bench import bench_config

    shard, shards = map(int, args.shard.split("/"))
    t_start = time.perf_counter()
    if args.largescan:
        seeds = LARGESCAN["seeds"][: args.limit or None]
        out = {
            "platform": "jax " + jax.__version__ + " on cpu",
            "rmse_band": 0.006,
            "pose_bar": 0.1,
            "config": "DEFAULT_CONFIG; largescan's own escalation rule (one register_resampled at "
                      "escalation_config() when the fitness is above escalate_threshold, kept if lower)",
            "n_points": LARGESCAN["n_points"],
            "pre_downsample": LARGESCAN["pre_downsample"],
            "seeds": [record_largescan(seed, LARGESCAN["n_points"], LARGESCAN["pre_downsample"]) for seed in seeds],
        }
        out["seconds"] = time.perf_counter() - t_start
        out_path.write_text(dump_record(out))
        print(f"wrote {out_path} in {out['seconds']:.0f} s", file=sys.stderr)
        return 0

    def limit(corpus):
        corpus = corpus[: args.limit] if args.limit else corpus
        return [pair for i, pair in enumerate(corpus) if i % shards == shard]

    counts = _Counts(kss, escalate)
    from kss_icp_torch.ladder_log import RungLog  # jax-free; the port is recorded the same way

    rungs = RungLog(kss, DEFAULT_CONFIG.overlap_adopt_margin)

    def run(cfg, corpus, threshold=None):
        pairs = []
        for index, (name, src, tgt, gt) in limit(list(enumerate(corpus))):
            t0 = time.perf_counter()
            counts.reset()
            rungs.rungs = []
            with counts, rungs:
                res = kss.register_pair(src, tgt, cfg)
            aligned = np.asarray(apply_similarity(res.transform, src))
            rmse = registration_measure(aligned, tgt)["rmse"]
            tr = res.transform
            rec = {
                "name": name,
                "index": index,
                "n_source": int(src.shape[0]),
                "n_target": int(tgt.shape[0]),
                "chosen_candidate": int(res.chosen_candidate),
                "fitness": float(res.fitness),
                "icp_iterations": int(res.icp_iterations),
                "refine_hit_cap": bool(res.refine_hit_cap),
                "scale": float(tr.scale),
                "rotation": np.asarray(tr.rotation, np.float64).tolist(),
                "translation": np.asarray(tr.translation, np.float64).tolist(),
                "rmse": float(rmse),
            }
            if args.escalation or args.overlap or args.precise or args.variants or args.two_stage:
                rec.update(escalated=counts.flagged > 0, escalation_won=counts.won > 0,
                           finisher=counts.finished > 0)
            if args.two_stage:
                rec["continued"] = counts.continued > 0
            if args.overlap or args.precise or args.variants or args.two_stage:
                rec["rungs"] = rungs.rungs
            if threshold is not None:
                pose = transform_rmse(aligned, src, gt)
                rec.update(pose_rmse=float(pose), passed=bool(pose <= threshold))
            pairs.append(rec)
            extra = "".join(f" {k}={rec[k]}" for k in ("continued", "escalated", "escalation_won", "finisher",
                                                         "pose_rmse") if k in rec)
            extra += "".join(f" {r['rung']}={'adopted' if r['adopted'] else 'ran' if r['ran'] else 'skipped'}"
                             for r in rec.get("rungs", ()))
            print(f"{name}: cand={rec['chosen_candidate']} fit={rec['fitness']:.6g} "
                  f"iters={rec['icp_iterations']} rmse={rmse:.6f}{extra} "
                  f"({time.perf_counter() - t0:.1f} s)", file=sys.stderr, flush=True)
        return pairs

    def run_batch(cfg, items):
        """One register_many call over items [(index, (name, src, tgt, gt), board or None)]."""
        from kss_icp_torch.ladder_log import LadderLog
        from kss_icp_tpu.parallel.batch import register_many

        if not items:
            return []
        t0 = time.perf_counter()
        pairs = [(src, tgt) for _, (_, src, tgt, _), _ in items]
        with LadderLog(escalate, len(pairs)) as ladder:
            res, metrics = register_many(pairs, cfg, full_pad=FULL_PAD)
        tr = res.transform
        rows = []
        for b, (index, (name, src, tgt, gt), board) in enumerate(items):
            src_pad = np.asarray(src, np.float32)[:FULL_PAD]
            aligned = np.asarray(apply_similarity(type(tr)(*(x[b] for x in tr)), src_pad))
            rec = {
                "name": name,
                "index": index,
                "n_source": int(src.shape[0]),
                "n_target": int(tgt.shape[0]),
                "chosen_candidate": int(res.chosen_candidate[b]),
                "fitness": float(res.fitness[b]),
                "icp_iterations": int(res.icp_iterations[b]),
                "refine_hit_cap": bool(res.refine_hit_cap[b]),
                "scale": float(tr.scale[b]),
                "rotation": np.asarray(tr.rotation[b], np.float64).tolist(),
                "translation": np.asarray(tr.translation[b], np.float64).tolist(),
                "rmse": float(metrics["rmse"][b]),
                "escalated": bool(ladder.escalated[b]),
                "escalation_won": bool(ladder.won[b]),
                "finisher": bool(ladder.finisher[b]),
                "rungs": ladder.rungs[b],
            }
            if args.two_stage:
                rec["continued"] = bool(ladder.continued[b])
            if board is not None:
                pose = transform_rmse(aligned, src_pad, gt)
                rec.update(board=board[0], pose_rmse=float(pose), passed=bool(pose <= board[1]))
            rows.append(rec)
            extra = "".join(f" {r['rung']}={'adopted' if r['adopted'] else 'ran' if r['ran'] else 'skipped'}"
                            for r in rec["rungs"])
            print(f"{'' if board is None else board[0] + ':'}{name}: cand={rec['chosen_candidate']} "
                  f"fit={rec['fitness']:.6g} rmse={rec['rmse']:.6f} escalated={rec['escalated']} "
                  f"won={rec['escalation_won']} finisher={rec['finisher']}"
                  f"{'' if board is None else ' pose_rmse=%.4f' % rec['pose_rmse']}{extra}",
                  file=sys.stderr, flush=True)
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20  # KiB on Linux
        print(f"register_many over {len(items)} pairs: {time.perf_counter() - t0:.1f} s, the process's peak RSS so far "
              f"{rss:.1f} GiB", file=sys.stderr, flush=True)
        return rows

    remesh = remesh_corpus()
    platform = "jax " + jax.__version__ + " on cpu"
    if args.batch:
        boards = challenge_corpus(include_hard=True)
        remesh_items, board_items = batch_items(remesh, boards, shard, shards, args.limit)
        out = {
            "platform": platform,
            "note": ESCALATION_NOTE,
            "rmse_band": 0.006,
            "config": BATCH_CONFIG,
            "full_pad": FULL_PAD,
            "shards": shards,
            "batches": [{"shard": f"{shard}/{shards}", "remesh": [p[0] for _, p, _ in remesh_items],
                         "boards": [f"{b[0]}:{p[0]}" for _, p, b in board_items]}],
        }
        out["pairs"] = run_batch(DEFAULT_CONFIG, remesh_items)
        rows = run_batch(DEFAULT_CONFIG, board_items)
        out["boards"] = {b: {"threshold": thr, "pairs": []} for b, _, thr in boards}
        for r in rows:
            out["boards"][r.pop("board")]["pairs"].append(r)
        out["seconds"] = time.perf_counter() - t_start
        out_path.write_text(dump_record(out))
        print(f"wrote {out_path} in {out['seconds']:.0f} s", file=sys.stderr)
        return 0
    if args.analysis:
        out, arrays = record_analysis(remesh)
        out["platform"] = platform
        out["seconds"] = time.perf_counter() - t_start
        np.savez_compressed(out_path.with_suffix(".npz"), **arrays)
        out_path.write_text(dump_record(out))
        print(f"wrote {out_path} and its .npz in {out['seconds']:.0f} s", file=sys.stderr)
        return 0
    if args.two_stage:
        cfg = dataclasses.replace(DEFAULT_CONFIG, **TWO_STAGE)
        remesh_items, _ = batch_items(remesh, [], shard, shards, args.limit)
        chunks = [remesh_items[i:i + MANY_CHUNK] for i in range(0, len(remesh_items), MANY_CHUNK)]
        out = {
            "platform": platform,
            "note": ESCALATION_NOTE,
            "rmse_band": 0.006,
            "config": "DEFAULT_CONFIG (escalation and the overlap tier on) with the knobs below: the converge "
                      "capped at 8 iterations, the capped pairs continued by a polish of up to 1000",
            "knobs": TWO_STAGE,
            "pairs": run(cfg, remesh),
            "many": {"two_stage": {
                "pairs": [r for chunk in chunks for r in run_batch(cfg, chunk)],
                "batches": [{"shard": f"{shard}/{shards}", "remesh": [p[0] for _, p, _ in chunk]}
                            for chunk in chunks]}},
        }
        out["seconds"] = time.perf_counter() - t_start
        out_path.write_text(dump_record(out))
        print(f"wrote {out_path} in {out['seconds']:.0f} s", file=sys.stderr)
        return 0
    if args.tools:
        variants = json.loads((FIXTURES / "torch_port_expected_variants.json").read_text())
        out, arrays = record_tools(remesh, variants)
        out["platform"] = platform
        out["seconds"] = time.perf_counter() - t_start
        np.savez_compressed(out_path.with_suffix(".npz"), **arrays)
        out_path.write_text(dump_record(out))
        print(f"wrote {out_path} and its .npz in {out['seconds']:.0f} s", file=sys.stderr)
        return 0
    if args.variants:
        out = record_variants(args, shard, shards, run, run_batch, remesh, platform)
        out["seconds"] = time.perf_counter() - t_start
        out_path.write_text(dump_record(out))
        print(f"wrote {out_path} in {out['seconds']:.0f} s", file=sys.stderr)
        return 0
    bench = bench_config()
    knobs = {f.name: getattr(bench, f.name) for f in dataclasses.fields(bench)
             if getattr(bench, f.name) != getattr(DEFAULT_CONFIG, f.name)}
    if args.precise:
        from kss_icp_tpu.config import KSSICPConfig

        default = json.loads((FIXTURES / "torch_port_expected_overlap.json").read_text())

        def against_default(pairs, default_pairs):
            by_name = {r["name"]: r for r in default_pairs}
            for r in pairs:
                r["default_fitness"] = by_name[r["name"]]["fitness"]
                r["restart_won"] = bool(r["fitness"] < r["default_fitness"])
            return pairs

        cfg = KSSICPConfig(neighborhood_fracs=PRECISE_FRACS)
        category = next((corpus, thr) for b, corpus, thr in challenge_corpus(include_hard=True) if b == "category")
        out = {
            "platform": platform,
            "note": ESCALATION_NOTE,
            "rmse_band": 0.006,
            "config": f"KSSICPConfig(neighborhood_fracs={PRECISE_FRACS}), the CLI's --precise: DEFAULT_CONFIG "
                      "(escalation and the overlap tier on) with the winner-neighborhood restarts",
            "pairs": against_default(run(cfg, remesh), default["pairs"]),
            "boards": {"category": {"threshold": category[1],
                                    "pairs": against_default(run(cfg, category[0], category[1]),
                                                             default["boards"]["category"]["pairs"])}},
        }
    elif not (args.escalation or args.overlap):
        no_esc = dict(auto_escalate=False)
        out = {
            "platform": platform,
            "rmse_band": 0.006,
            "config": "DEFAULT_CONFIG with auto_escalate=False",
            "pairs": run(dataclasses.replace(DEFAULT_CONFIG, **no_esc), remesh),
            "bench_config": {"knobs": dict(knobs, **no_esc),
                             "pairs": run(dataclasses.replace(bench, **no_esc), remesh)},
        }
    elif args.overlap:
        out = {
            "platform": platform,
            "note": ESCALATION_NOTE,
            "rmse_band": 0.006,
            "config": "DEFAULT_CONFIG (escalation and the overlap tier on)",
            "pairs": run(DEFAULT_CONFIG, remesh),
            "boards": {b: {"threshold": thr, "pairs": run(DEFAULT_CONFIG, corpus, thr)}
                       for b, corpus, thr in challenge_corpus(include_hard=True)},
        }
    else:
        esc = dict(overlap_escalate=False)
        base = dataclasses.replace(DEFAULT_CONFIG, **esc)
        boards = {"category": (category_corpus(), 0.20), "deform": (deform_corpus(), 0.12),
                  "scale": (scale_corpus(), 0.20)}
        out = {
            "platform": platform,
            "note": ESCALATION_NOTE,
            "rmse_band": 0.006,
            "config": "DEFAULT_CONFIG with overlap_escalate=False (escalation on)",
            "pairs": run(base, remesh),
            "bench_config": {"knobs": dict(knobs, **esc),
                             "pairs": run(dataclasses.replace(bench, **esc), remesh)},
            "boards": {b: {"threshold": thr, "pairs": run(base, corpus, thr)}
                       for b, (corpus, thr) in boards.items()},
        }
    out["seconds"] = time.perf_counter() - t_start
    out_path.write_text(dump_record(out))
    print(f"wrote {out_path} in {out['seconds']:.0f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
