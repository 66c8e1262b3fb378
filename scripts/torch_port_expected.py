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
  `--overlap`.

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
        | --precise | --variants] [--limit N] [--shard I/N] [--out PATH]
    python scripts/torch_port_expected.py [--overlap | --batch | --precise | --variants] --merge SHARD.json ...
        [--out PATH]

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
        self.flagged = self.won = self.finished = 0

    def __enter__(self):
        def rerun(*a, **kw):
            out = self.orig_rerun(*a, **kw)
            self.flagged += out[3]
            self.won += len(out[2])
            return out

        def polish(*a, **kw):
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
            if args.escalation or args.overlap or args.precise or args.variants:
                rec.update(escalated=counts.flagged > 0, escalation_won=counts.won > 0,
                           finisher=counts.finished > 0)
            if args.overlap or args.precise or args.variants:
                rec["rungs"] = rungs.rungs
            if threshold is not None:
                pose = transform_rmse(aligned, src, gt)
                rec.update(pose_rmse=float(pose), passed=bool(pose <= threshold))
            pairs.append(rec)
            extra = "".join(f" {k}={rec[k]}" for k in ("escalated", "escalation_won", "finisher",
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
