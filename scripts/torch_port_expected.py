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
  one batch needs about 50 GiB.

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

    JAX_PLATFORMS=cpu python scripts/torch_port_expected.py [--escalation | --overlap | --batch] [--limit N]
        [--shard I/N] [--out PATH]
    python scripts/torch_port_expected.py [--overlap | --batch] --merge SHARD.json ... [--out PATH]

About 16 s per remesh pair at DEFAULT_CONFIG and 8 s at the bench config on
an 8-core x86 CPU with escalation off.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import resource
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "fixtures"
BOARDS = ("category", "deform", "scale")
FULL_PAD = 8192  # register_many's default pad, which the remesh targets (up to 8000 points) fit

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


def merge(paths, out_path) -> int:
    """One record from the shards' records: every list of pairs joined and
    put back in corpus order, the shards' batches listed, the seconds
    summed."""
    parts = [json.loads(p.read_text()) for p in paths]
    out = parts[0]

    def join(get):
        return sorted((r for part in parts for r in get(part)), key=lambda r: r["index"])

    for key in ("pairs",):
        out[key] = join(lambda part: part[key])
    if "bench_config" in out:
        out["bench_config"]["pairs"] = join(lambda part: part["bench_config"]["pairs"])
    for b in out.get("boards", {}):
        out["boards"][b]["pairs"] = join(lambda part: part["boards"][b]["pairs"])
    if "batches" in out:
        out["batches"] = sorted((b for part in parts for b in part["batches"]),
                                key=lambda b: int(b["shard"].split("/")[0]))
        out["shards"] = len(out["batches"])
    out["seconds"] = sum(part["seconds"] for part in parts)
    out_path.write_text(json.dumps(out, indent=1) + "\n")
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

    def limit(corpus):
        corpus = corpus[: args.limit] if args.limit else corpus
        return [pair for i, pair in enumerate(corpus) if i % shards == shard]

    t_start = time.perf_counter()
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
            if args.escalation or args.overlap:
                rec.update(escalated=counts.flagged > 0, escalation_won=counts.won > 0,
                           finisher=counts.finished > 0)
            if args.overlap:
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
        out_path.write_text(json.dumps(out, indent=1) + "\n")
        print(f"wrote {out_path} in {out['seconds']:.0f} s", file=sys.stderr)
        return 0
    bench = bench_config()
    knobs = {f.name: getattr(bench, f.name) for f in dataclasses.fields(bench)
             if getattr(bench, f.name) != getattr(DEFAULT_CONFIG, f.name)}
    if not (args.escalation or args.overlap):
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
    out_path.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {out_path} in {out['seconds']:.0f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
