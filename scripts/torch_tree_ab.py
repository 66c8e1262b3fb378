#!/usr/bin/env python3
"""Two checkouts of the port against each other, end to end, in turns, on
one CUDA card.

    python3 scripts/torch_tree_ab.py --old DIR [--new DIR] [--rounds N] [--passes N] [--largescan] [--boards]
                                     [--out DIR]

DIR is the root of another checkout of this repository (for example a
commit unpacked with `git archive` into a gitignored directory such as
_scratch/); --new defaults to this checkout. Each turn is a process of its
own that imports `kss_icp_torch` from one checkout, builds that checkout's
kernels there (at first use) and, after a warm-up pair:
  - times its `nn1`, `fps`, `field_ave` and `field_dot` wrappers called
    back to back (CUDA events, the host's cost of each call included),
    called as the main path calls them, `nn1(query, ref, mask)` at the
    screen, refine, metric and K4 shapes, `fps(points, mask, S)` at B=2,
    8192 -> 2048, and the fields on the 8³ grid at register_pair's padded
    clouds (512 x 2048 x 2048, both suffix-masked to the median remesh
    pair's 1070 rows; `field_dot` at "highest" and "default");
  - drives the esc-default pass (DEFAULT_CONFIG with overlap_escalate=False)
    and the esc-dot pass (the same at coarse_method="dot") over the 25
    remesh pairs through register_pair -> apply_similarity ->
    registration_measure, each --passes times without stage syncs (pairs/s)
    and --passes times with a sync at each stage border (stage seconds, the
    coarse stage among them), and holds every pair's RMSE to the JAX CPU
    value + 0.006 (fixtures/torch_port_expected_escalation.json);
  - with --largescan, runs `run_largescan(200000, 80000, DEFAULT_CONFIG,
    seed, repeats=3)` for the Room seeds 0-2 (the stage seconds of the
    fastest repeat; register_s holds the one `fps` launch of 2 x 135168-
    151552 points) and holds each seed's unit-scale RMSE to JAX's + 0.006
    and its pose under 0.1 m (fixtures/torch_port_expected_largescan.json);
  - with --boards, runs the shipped DEFAULT_CONFIG through `register_many`
    on the five boards' 64 pairs as one batch (full_pad 8192, the overlap
    tier's rungs included: "many boards"), --passes times without stage
    syncs (pairs/s) and --passes times with them (stage seconds), every
    pair's RMSE finite.
The turns run old, new, new, old, --rounds times. The card's name and power
limit come first, then one line per turn and, for each checkout, the means
of the wrapper times and the medians of the passes' seconds and stage
seconds with their interquartile range;
one JSON object with every number is the last line, and is also written to
torch_tree_ab.json in --out (default _scratch/tree_ab/, gitignored). Exits
1 if a pair of either checkout, in either pass, is outside its band.

Imports nothing of JAX and nothing of kss_icp_tpu.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
RMSE_BAND = 0.006
NN1_SHAPES = [(32, 512, 2048), (4, 2048, 2048), (1, 3072, 8192), (1, 65536, 65536)]
FPS_SHAPE = (2, 8192, 2048)
FIELD_SHAPE = (8, 2048, 1070)  # grid steps, padded P = T, valid rows of both clouds
LARGESCAN_SEEDS = (0, 1, 2)


def cloud(rng: np.random.Generator, n: int) -> np.ndarray:
    u = rng.uniform(-1, 1, size=(n,))
    v = rng.uniform(-1, 1, size=(n,))
    return np.stack([u, v, 0.3 * np.sin(3 * u) * np.cos(2 * v)], axis=-1).astype(np.float32)


def largescan_runs(tree: Path, device) -> dict:
    """run_largescan at 200k points for the Room seeds, by seed: the stage
    seconds and whether the answer is within JAX's band."""
    from kss_icp_torch.config import DEFAULT_CONFIG
    from kss_icp_torch.largescan import run_largescan

    expected = {r["seed"]: r for r in json.loads(
        (tree / "fixtures" / "torch_port_expected_largescan.json").read_text())["seeds"]}
    runs = {}
    for seed in LARGESCAN_SEEDS:
        out = run_largescan(200_000, 80_000, DEFAULT_CONFIG, seed, repeats=3, device=device)
        ok = out["unit_rmse"] <= expected[seed]["unit_rmse"] + RMSE_BAND and out["pose_rmse"] < 0.1
        runs[str(seed)] = {k: out[k] for k in ("octree_s", "register_s", "metric_s", "total_s", "unit_rmse",
                                               "pose_rmse", "fitness")} | {"ok": bool(ok)}
    return runs


def boards_runs(dev, passes: int) -> dict:
    """register_many over the five boards' 64 pairs at DEFAULT_CONFIG, one
    batch, --passes times unsynced then --passes times synced at each stage
    border."""
    import torch

    import kss_icp_torch as kt
    from kss_icp_torch.challenge import BOARDS
    from kss_icp_torch.config import DEFAULT_CONFIG

    pairs = [(src, tgt) for _, corpus, _ in BOARDS for _, src, tgt, _ in corpus()]
    kt.register_many(pairs[:2], DEFAULT_CONFIG, full_pad=8192, device=dev)
    torch.cuda.synchronize()
    runs = {"unsynced": [], "synced": []}
    for sync in [False] * passes + [True] * passes:
        stages = defaultdict(float)

        @contextlib.contextmanager
        def timer(name):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            stages[name] += time.perf_counter() - t0

        t0 = time.perf_counter()
        _, metrics = kt.register_many(pairs, DEFAULT_CONFIG, full_pad=8192, device=dev,
                                      timer=timer if sync else None)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        runs["synced" if sync else "unsynced"].append(
            {"seconds": seconds, "pairs_per_s": len(pairs) / seconds, "stage_seconds": dict(stages),
             "finite": bool(np.isfinite(np.asarray(metrics["rmse"])).all())})
    return runs


def worker(tree: Path, passes: int, largescan: bool, boards: bool) -> dict:
    """One turn: the wrappers' times and the esc-default passes of the
    `kss_icp_torch` in `tree`."""
    sys.path.insert(0, str(tree))
    import torch

    import kss_icp_torch as kt
    from kss_icp_torch import _build
    from kss_icp_torch.config import DEFAULT_CONFIG
    from kss_icp_torch.core.transforms import euler_xyz_matrix
    from kss_icp_torch.models.coarse import rotation_grid
    from kss_icp_torch.ops.coarse_cuda import field_ave, field_dot
    from kss_icp_torch.ops.nn_cuda import nn1
    from kss_icp_torch.ops.resample_cuda import fps

    if Path(kt.__file__).resolve().parents[1] != tree:
        raise RuntimeError(f"kss_icp_torch came from {kt.__file__}, not from {tree}")
    # This checkout's timing helpers, by path: the other checkout may lack them.
    spec = importlib.util.spec_from_file_location("_kss_timing", REPO / "kss_icp_torch" / "timing.py")
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)
    dev = torch.device("cuda", 0)
    _, _, build_s = _build.build()

    rng = np.random.default_rng(0)
    nn1_ms = {}
    for lanes, q_n, r_n in NN1_SHAPES:
        query = torch.as_tensor(np.stack([cloud(rng, q_n) for _ in range(lanes)]), device=dev)
        ref = torch.as_tensor(cloud(rng, r_n)[None], device=dev)
        mask = torch.ones((1, r_n), dtype=torch.bool, device=dev)
        mask[0, r_n - r_n // 40:] = False
        reps = 3 if q_n * r_n > 1e9 else 200
        nn1_ms[f"{lanes}x{q_n}x{r_n}"] = timing.time_ms(lambda: nn1(query, ref, mask), reps)
    b_n, p_n, s = FPS_SHAPE
    pts = torch.as_tensor(np.stack([cloud(rng, p_n) for _ in range(b_n)]), device=dev)
    pmask = torch.ones((b_n, p_n), dtype=torch.bool, device=dev)
    pmask[0, 8000:] = False
    pmask[1, 6201:] = False
    fps_ms = {f"{b_n}x{p_n}->{s}": timing.time_ms(lambda: fps(pts, pmask, s), 20)}
    steps, n, valid = FIELD_SHAPE
    fargs = (torch.as_tensor(cloud(rng, n), device=dev), torch.arange(n, device=dev) < valid,
             torch.as_tensor(cloud(rng, n), device=dev), torch.arange(n, device=dev) < valid,
             euler_xyz_matrix(rotation_grid(steps, 6.3, dev)))
    shape = f"{steps ** 3}x{n}x{n}, {valid} valid"
    field_ms = {f"field_ave {shape}": timing.time_ms(lambda: field_ave(*fargs), 20)}
    for prec in ("highest", "default"):
        field_ms[f"field_dot {prec} {shape}"] = timing.time_ms(lambda: field_dot(*fargs, prec), 20)

    meta = json.loads((tree / "fixtures" / "remesh_transfer.json").read_text())
    with np.load(tree / "fixtures" / "remesh_transfer.npz") as z:
        pairs = [(r["name"], np.asarray(z[r["name"] + "_src"], np.float32),
                  np.asarray(z[r["name"] + "_tgt"], np.float32)) for r in meta]
    expected = {p["name"]: p["rmse"] for p in
                json.loads((tree / "fixtures" / "torch_port_expected_escalation.json").read_text())["pairs"]}
    cfg = dataclasses.replace(DEFAULT_CONFIG, overlap_escalate=False)
    kt.register_pair(pairs[0][1], pairs[0][2], dataclasses.replace(cfg, escalate_threshold=0.0), device=dev)
    torch.cuda.synchronize()

    def one_pass(sync: bool, cfg=cfg) -> dict:
        stages = defaultdict(float)

        @contextlib.contextmanager
        def timer(name):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            yield
            if sync:
                torch.cuda.synchronize()
                stages[name] += time.perf_counter() - t0

        nn1.launches = fps.launches = 0
        outside, total = [], 0.0
        for name, src, tgt in pairs:
            t0 = time.perf_counter()
            res = kt.register_pair(src, tgt, cfg, device=dev, timer=timer)
            with timer("metric"):
                aligned = kt.apply_similarity(res.transform, torch.as_tensor(src, device=dev))
                rmse = kt.registration_measure(aligned, tgt, device=dev)["rmse"]
            torch.cuda.synchronize()
            total += time.perf_counter() - t0
            if not (np.isfinite(rmse) and rmse <= expected[name] + RMSE_BAND):
                outside.append(name)
        return {"seconds": total, "pairs_per_s": len(pairs) / total, "outside": outside,
                "launches": {"nn1": nn1.launches, "fps": fps.launches}, "stage_seconds": dict(stages)}

    dot = dataclasses.replace(cfg, coarse_method="dot")
    return {"build_s": build_s, "nn1_ms": nn1_ms, "fps_ms": fps_ms, "field_ms": field_ms,
            "unsynced": [one_pass(False) for _ in range(passes)],
            "synced": [one_pass(True) for _ in range(passes)],
            "dot": {"unsynced": [one_pass(False, dot) for _ in range(passes)],
                    "synced": [one_pass(True, dot) for _ in range(passes)]},
            "largescan": largescan_runs(tree, dev) if largescan else {},
            "boards": boards_runs(dev, passes) if boards else {}}


def run_turn(tree: Path, passes: int, largescan: bool, boards: bool) -> dict:
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker", str(tree),
                           "--passes", str(passes)] + (["--largescan"] if largescan else [])
                          + (["--boards"] if boards else []), capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"turn in {tree} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def mean(values) -> float:
    values = list(values)
    return sum(values) / len(values)


def quartiles(values) -> list:
    """[first quartile, median, third quartile]."""
    return [float(q) for q in np.percentile(list(values), [25, 50, 75])]


def summary(turns: list) -> dict:
    """Means over a checkout's turns (and over the passes of each turn), and
    the quartiles of the passes' seconds."""
    unsynced = [p for t in turns for p in t["unsynced"]]
    synced = [p for t in turns for p in t["synced"]]
    stages = sorted({k for p in synced for k in p["stage_seconds"]})
    return {
        "nn1_ms": {k: mean(t["nn1_ms"][k] for t in turns) for k in turns[0]["nn1_ms"]},
        "fps_ms": {k: mean(t["fps_ms"][k] for t in turns) for k in turns[0]["fps_ms"]},
        "field_ms": {k: mean(t["field_ms"][k] for t in turns) for k in turns[0]["field_ms"]},
        "unsynced_seconds": mean(p["seconds"] for p in unsynced),
        "pairs_per_s": mean(p["pairs_per_s"] for p in unsynced),
        "synced_seconds": mean(p["seconds"] for p in synced),
        "stage_seconds": {k: mean(p["stage_seconds"].get(k, 0.0) for p in synced) for k in stages},
        "unsynced_seconds_quartiles": quartiles(p["seconds"] for p in unsynced),
        "synced_seconds_quartiles": quartiles(p["seconds"] for p in synced),
        "stage_seconds_quartiles": {k: quartiles(p["stage_seconds"].get(k, 0.0) for p in synced) for k in stages},
        "launches": synced[0]["launches"],
        "outside": sorted({n for p in unsynced + synced for n in p["outside"]}),
        "largescan": {seed: {k: mean(t["largescan"][seed][k] for t in turns) for k in ("register_s", "total_s")}
                      for seed in turns[0]["largescan"]},
        "largescan_outside": sorted({seed for t in turns for seed, r in t["largescan"].items() if not r["ok"]}),
        "boards": boards_summary(turns),
        "dot": dot_summary(turns),
    }


def dot_summary(turns: list) -> dict:
    """The esc-dot passes' pairs/s quartiles (unsynced), stage seconds
    quartiles (synced) and pairs outside the band, over a checkout's turns."""
    unsynced = [p for t in turns for p in t["dot"]["unsynced"]]
    synced = [p for t in turns for p in t["dot"]["synced"]]
    stages = sorted({k for p in synced for k in p["stage_seconds"]})
    return {"pairs_per_s_quartiles": quartiles(p["pairs_per_s"] for p in unsynced),
            "synced_seconds_quartiles": quartiles(p["seconds"] for p in synced),
            "stage_seconds_quartiles": {k: quartiles(p["stage_seconds"].get(k, 0.0) for p in synced)
                                        for k in stages},
            "outside": sorted({n for p in unsynced + synced for n in p["outside"]})}


def boards_summary(turns: list) -> dict:
    """The boards passes' pairs/s quartiles (unsynced) and stage seconds
    quartiles (synced), over a checkout's turns; {} without --boards."""
    unsynced = [p for t in turns for p in t["boards"].get("unsynced", [])]
    synced = [p for t in turns for p in t["boards"].get("synced", [])]
    if not unsynced:
        return {}
    stages = sorted({k for p in synced for k in p["stage_seconds"]})
    return {"pairs_per_s_quartiles": quartiles(p["pairs_per_s"] for p in unsynced),
            "synced_seconds_quartiles": quartiles(p["seconds"] for p in synced),
            "stage_seconds_quartiles": {k: quartiles(p["stage_seconds"].get(k, 0.0) for p in synced)
                                        for k in stages},
            "finite": all(p["finite"] for p in unsynced + synced)}


def fmt(d: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in d.items())


def fmt_q(q: list) -> str:
    """A median with its interquartile range in brackets."""
    return f"{q[1]:.4f} ({q[0]:.4f}-{q[2]:.4f})"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, help="root of the other checkout")
    ap.add_argument("--new", type=Path, default=REPO, help="root of the checkout under test (default: this one)")
    ap.add_argument("--rounds", type=int, default=1, help="rounds of old, new, new, old")
    ap.add_argument("--passes", type=int, default=2, help="esc-default and esc-dot passes a turn, synced and not")
    ap.add_argument("--largescan", action="store_true", help="also run_largescan at 200k points, seeds 0-2")
    ap.add_argument("--boards", action="store_true", help="also register_many on the 64 board pairs, one batch")
    ap.add_argument("--out", type=Path, default=REPO / "_scratch" / "tree_ab", help="directory for the JSON")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        print(json.dumps(worker(args.worker.resolve(), args.passes, args.largescan, args.boards)), flush=True)
        return 0
    import torch

    if args.old is None:
        ap.error("--old is required")
    if not torch.cuda.is_available():
        print("torch_tree_ab: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    trees = {"old": args.old.resolve(), "new": args.new.resolve()}
    turns = {"old": [], "new": []}
    for _ in range(args.rounds):
        for which in ("old", "new", "new", "old"):
            t = run_turn(trees[which], args.passes, args.largescan, args.boards)
            turns[which].append(t)
            print(f"[{which}] build {t['build_s']:.2f} s; nn1 wrapper ms {fmt(t['nn1_ms'])}; fps wrapper ms "
                  f"{fmt(t['fps_ms'])}; field wrapper ms {fmt(t['field_ms'])}; unsynced pass s "
                  + ", ".join(f"{p['seconds']:.4f}" for p in t["unsynced"])
                  + "; synced pass s " + ", ".join(f"{p['seconds']:.4f}" for p in t["synced"])
                  + "; esc-dot unsynced pass s " + ", ".join(f"{p['seconds']:.4f}" for p in t["dot"]["unsynced"])
                  + "".join(f"; largescan seed {k} register_s {r['register_s']:.4f} total_s {r['total_s']:.4f}"
                            for k, r in t["largescan"].items())
                  + "".join(f"; boards {k} pass s " + ", ".join(f"{p['seconds']:.4f}" for p in v)
                            for k, v in t["boards"].items()), flush=True)
    result = {"card": card, "trees": {k: str(v) for k, v in trees.items()}, "turns": turns,
              "summary": {k: summary(v) for k, v in turns.items()}}
    for which, s in result["summary"].items():
        print(f"[{which} mean] nn1 wrapper ms {fmt(s['nn1_ms'])}; fps wrapper ms {fmt(s['fps_ms'])}; field "
              f"wrapper ms {fmt(s['field_ms'])}; unsynced pass {s['unsynced_seconds']:.4f} s ({s['pairs_per_s']:.3f} "
              f"pairs/s); synced pass {s['synced_seconds']:.4f} s, stages {fmt(s['stage_seconds'])}; launches "
              f"{s['launches']}; pairs outside the band {s['outside']}"
              + "".join(f"; largescan seed {k} register_s {r['register_s']:.4f} total_s {r['total_s']:.4f}"
                        for k, r in s["largescan"].items())
              + f"; large scans outside the band {s['largescan_outside']}", flush=True)
        print(f"[{which} quartiles] esc-default unsynced pass s {fmt_q(s['unsynced_seconds_quartiles'])}; synced "
              f"pass s {fmt_q(s['synced_seconds_quartiles'])}; stages " + ", ".join(
                  f"{k} {fmt_q(v)}" for k, v in s["stage_seconds_quartiles"].items()), flush=True)
        d = s["dot"]
        print(f"[{which} esc-dot] pairs/s {fmt_q(d['pairs_per_s_quartiles'])}; synced pass s "
              f"{fmt_q(d['synced_seconds_quartiles'])}; stages " + ", ".join(
                  f"{k} {fmt_q(v)}" for k, v in d["stage_seconds_quartiles"].items())
              + f"; pairs outside the band {d['outside']}", flush=True)
        if s["boards"]:
            b = s["boards"]
            print(f"[{which} boards] many boards pairs/s {fmt_q(b['pairs_per_s_quartiles'])}; synced pass s "
                  f"{fmt_q(b['synced_seconds_quartiles'])}; stages " + ", ".join(
                      f"{k} {fmt_q(v)}" for k, v in b["stage_seconds_quartiles"].items()), flush=True)
    result["ok"] = not any(s["outside"] or s["dot"]["outside"] or s["largescan_outside"]
                           or (s["boards"] and not s["boards"]["finite"]) for s in result["summary"].values())
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "torch_tree_ab.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
