"""Command-line interface (port of kss_icp_tpu/cli.py).

Mirrors the shipped reference CLI (`KSS-ICP.exe PointSource.ply
PointTarget.ply` → Registration.xyz + MSE/RMSE/MAE printout,
EXE/Readme.txt + Main_KSS_ICP.cpp:61-95) and the batch/benchmark driver
shape of Main_KSS_List.cpp, with the JAX CLI's subcommands, flags, printed
lines and JSON keys, so a script that parses one parses the other.

    python -m kss_icp_torch register source.ply target.ply -o out.xyz
    python -m kss_icp_torch batch list.txt data_dir/            (per-pair table)
    python -m kss_icp_torch measure aligned.xyz target.xyz

Every subcommand runs on the card (`--device cuda`, the default) unless
`--device cpu` asks for the plain PyTorch path; `--device cuda` without a
card exits with status 1 and never falls back to the CPU. The JAX CLI's
`--platform` is `--device` here. `view`, whose module is not ported yet, is
parsed, then exits with status 2 naming its ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np


class CLIError(Exception):
    """A refusal to run, printed to stderr by `main` with its exit status."""

    def __init__(self, message: str, status: int):
        super().__init__(message)
        self.status = status


def _unported(what: str, item: str):
    raise CLIError(f"kss_icp_torch does not implement {what} yet: ROADMAP.md queue 1 item 13 ({item})", 2)


def _device(args):
    """The torch device of --device: the card unless the caller asks for the CPU."""
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise CLIError("--device cuda needs a CUDA device and none is visible; pass --device cpu "
                       "to run the plain PyTorch path", 1)
    return device


def _cfg_from_args(args):
    from kss_icp_torch.config import KSSICPConfig

    kw = dict(
        rotation_steps=args.accurate,
        max_icp_iterations=args.iterations,
        max_candidates=args.max_candidates,
    )
    # --escalate/--no-escalate overrides cfg.auto_escalate everywhere a
    # config is built (register_pair consumes it directly; register_many's
    # `escalate=None` defers to it).
    if getattr(args, "escalate", None) is not None:
        kw["auto_escalate"] = args.escalate
    if getattr(args, "precise", False):
        # Winner-neighborhood precision restarts: re-converge from +-1/4
        # and +-1/2 grid-step Euler offsets of the winning pose, keep-better
        # by fitness (KSSICPConfig.neighborhood_fracs).
        kw["neighborhood_fracs"] = (0.25, 0.5)
    cfg = KSSICPConfig(**kw)
    if getattr(args, "overlap", False):
        # Overlap-robust mode for partially-overlapping scans (trimmed field,
        # trimmed similarity ICP, iterated inlier pre-shape).
        cfg = cfg.overlap_config()
    return cfg


def _logger_from_args(args):
    import io

    from kss_icp_torch.utils.log import JsonlLogger

    sink = getattr(args, "log_json", None)
    # Default: swallow events unless --log-json is given.
    return JsonlLogger(sink) if sink else JsonlLogger(io.StringIO())


def _aligned(transform, points, device) -> np.ndarray:
    """The (N, 3) float32 source moved by one pair's transform, on the host."""
    import torch

    from kss_icp_torch.core.transforms import apply_similarity

    return apply_similarity(transform, torch.as_tensor(np.asarray(points, np.float32), device=device)).cpu().numpy()


def _row(transform, i: int):
    """Pair i's transform of a batch result."""
    return type(transform)(*(x[i] for x in transform))


def _register(args) -> int:
    device = _device(args)
    cfg = _cfg_from_args(args)
    with contextlib.closing(_logger_from_args(args)) as log:
        return _register_logged(args, device, cfg, log)


def _register_logged(args, device, cfg, log) -> int:
    import torch

    from kss_icp_torch.io.formats import load_points, save_xyz
    from kss_icp_torch.metrics import registration_measure
    from kss_icp_torch.models.kss_icp import register_pair

    with log.stage("load", source=str(args.source), target=str(args.target)):
        src = load_points(args.source)
        tgt = load_points(args.target)
    print(f"loaded source={src.shape[0]} target={tgt.shape[0]} points")

    cap = getattr(args, "pre_downsample", 0)
    if cap:
        # Room/block large-scan protocol: octree voxel downsample to ~cap
        # points before registration (Method_Octree.hpp:16-108).
        from kss_icp_torch.ops.simplify import octree_simplify

        def shrink(pts):
            if pts.shape[0] <= cap:
                return pts
            p_, keep = octree_simplify(torch.as_tensor(pts, dtype=torch.float32, device=device),
                                       torch.ones(pts.shape[0], dtype=torch.bool, device=device), cap)
            return p_[keep].cpu().numpy()

        src, tgt = shrink(src), shrink(tgt)
        print(f"pre-downsampled to source={src.shape[0]} target={tgt.shape[0]}")

    prof = None
    if getattr(args, "profile", None):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts)
    t0 = time.perf_counter()
    with log.stage("register", n_source=src.shape[0], n_target=tgt.shape[0]):
        if prof is not None:
            with prof:
                res = register_pair(src, tgt, cfg, device=device)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
        else:
            res = register_pair(src, tgt, cfg, device=device)
    aligned = _aligned(res.transform, src, device)
    dt = time.perf_counter() - t0
    if prof is not None:
        out = Path(args.profile)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / "trace.json"))

    m = registration_measure(aligned, tgt.astype(np.float32), device=device)
    log.emit("result", time_s=dt, multistart=bool(res.used_multistart), **m)
    print(f"registration time: {dt:.3f}s  (multistart={bool(res.used_multistart)})")
    print(f"MSE:  {m['mse']:.6g}")
    print(f"RMSE: {m['rmse']:.6g}")
    print(f"MAE:  {m['mae']:.6g}")
    if args.output:
        save_xyz(args.output, aligned)
        print(f"saved {args.output}")
    if args.json:
        print(json.dumps({"time_s": dt, **m}))
    return 0


def _batch(args) -> int:
    """Per-model table over a name list — the Main_KSS_List protocol
    (Main_KSS_List.cpp:151-179): register <name>.gird onto <name>.wlop."""
    device = _device(args)
    from kss_icp_torch.io.formats import load_points, save_xyz
    from kss_icp_torch.metrics import registration_measure
    from kss_icp_torch.models.kss_icp import register_pair

    cfg = _cfg_from_args(args)
    data = Path(args.data_dir)
    names = [
        ln.strip() for ln in Path(args.list_file).read_text().splitlines() if ln.strip()
    ]

    if args.batched:
        # The whole list as one batch: every stage over all pairs at once.
        from kss_icp_torch.parallel.batch import register_many

        pairs = [
            (load_points(data / f"{n}{args.source_ext}"),
             load_points(data / f"{n}{args.target_ext}"))
            for n in names
        ]
        t0 = time.perf_counter()
        res, metrics = register_many(pairs, cfg, escalate=args.escalate, device=device)
        dt = time.perf_counter() - t0
        for i, name in enumerate(names):
            print(f"{name:12s} MSE={metrics['mse'][i]:.6g} "
                  f"RMSE={metrics['rmse'][i]:.6g} MAE={metrics['mae'][i]:.6g}")
            if args.output_dir:
                out = Path(args.output_dir)
                out.mkdir(parents=True, exist_ok=True)
                save_xyz(out / f"{name}Align.xyz", _aligned(_row(res.transform, i), pairs[i][0], device))
        print(f"{'TOTAL':12s} time={dt:7.3f}s (incl. compile) "
              f"pairs/sec={len(names)/dt:.3f} "
              f"amortized={dt/len(names):.4f}s/pair")
        return 0

    rows = []
    for name in names:
        if args.resume and args.output_dir and (
            Path(args.output_dir) / f"{name}Align.xyz"
        ).exists():
            print(f"{name:12s} skipped (resume: output exists)")
            continue
        src = load_points(data / f"{name}{args.source_ext}")
        tgt = load_points(data / f"{name}{args.target_ext}")
        t0 = time.perf_counter()
        res = register_pair(src, tgt, cfg, device=device)
        aligned = _aligned(res.transform, src, device)
        dt = time.perf_counter() - t0
        m = registration_measure(aligned, tgt.astype(np.float32), device=device)
        rows.append((name, dt, m, float(res.fitness)))
        print(f"{name:12s} time={dt:7.3f}s MSE={m['mse']:.6g} "
              f"RMSE={m['rmse']:.6g} MAE={m['mae']:.6g}")
        if args.output_dir:
            out = Path(args.output_dir)
            out.mkdir(parents=True, exist_ok=True)
            save_xyz(out / f"{name}Align.xyz", aligned)
    if rows:
        total = sum(r[1] for r in rows)
        print(f"{'TOTAL':12s} time={total:7.3f}s pairs/sec={len(rows)/total:.3f}")
    if args.success_list:
        # The data/registration/ICP.txt protocol: a "success:" line listing
        # models whose converged fitness clears the threshold.
        ok = [r[0] for r in rows if r[3] <= args.success_threshold]
        Path(args.success_list).write_text("success: " + " ".join(ok) + "\n")
        print(f"success: {' '.join(ok)}")
    return 0


def _bench_dir(args) -> int:
    """Full bench protocol over a user-supplied directory of model pairs:
    every `<name><source-ext>` with a matching `<name><target-ext>`,
    registered as one batch (register_many: resample, coarse, multi-start
    ICP, escalation), per-pair MSE/RMSE/MAE, and, where a transfer.txt-style
    manifest records the ground-truth perturbations, each recovered
    transform scored by its pose error (RMSE between the recovered- and the
    truth-aligned source points) with a success-rate summary."""
    device = _device(args)
    from kss_icp_torch.io.formats import load_points
    from kss_icp_torch.parallel.batch import register_many
    from kss_icp_torch.transfer import load_transfer_log, unapply_record

    cfg = _cfg_from_args(args)
    data = Path(args.data_dir)
    if not data.is_dir():
        print(f"error: {data} is not a directory", file=sys.stderr)
        return 2

    names = sorted(
        p.name[: -len(args.source_ext)]
        for p in data.glob(f"*{args.source_ext}")
        if (data / f"{p.name[: -len(args.source_ext)]}{args.target_ext}").exists()
    )
    if args.limit:
        names = names[: args.limit]
    if not names:
        print(f"error: no <name>{args.source_ext} / <name>{args.target_ext} "
              f"pairs found in {data}", file=sys.stderr)
        return 2

    # Ground-truth manifest (transfer.txt protocol): pose-score any pair
    # whose name has a record.
    manifest = Path(args.manifest) if args.manifest else data / "transfer.txt"
    records = {}
    if manifest.exists():
        records = {r.name: r for r in load_transfer_log(manifest)}
        print(f"manifest: {manifest} ({len(records)} records)")

    pairs = [
        (load_points(data / f"{n}{args.source_ext}"),
         load_points(data / f"{n}{args.target_ext}"))
        for n in names
    ]
    t0 = time.perf_counter()
    res, metrics = register_many(pairs, cfg, full_pad=args.full_pad,
                                 escalate=args.escalate, device=device)
    dt = time.perf_counter() - t0

    fitness = res.fitness.cpu().numpy()
    rows = []
    n_scored = n_pass = 0
    for i, name in enumerate(names):
        row = {"name": name,
               "mse": float(metrics["mse"][i]),
               "rmse": float(metrics["rmse"][i]),
               "mae": float(metrics["mae"][i]),
               "fitness": float(fitness[i])}
        line = (f"{name:16s} MSE={row['mse']:.6g} RMSE={row['rmse']:.6g} "
                f"MAE={row['mae']:.6g}")
        if name in records:
            src = np.asarray(pairs[i][0], np.float32)
            d = _aligned(_row(res.transform, i), src, device) - unapply_record(src, records[name])
            pose = float(np.sqrt(np.mean(np.sum(d * d, axis=-1))))
            ok = pose <= args.pose_threshold
            row.update(pose_rmse=pose, pose_ok=ok)
            n_scored += 1
            n_pass += int(ok)
            line += f" pose={pose:.5f} [{'ok' if ok else 'FAIL'}]"
        rows.append(row)
        print(line)
    print(f"{'TOTAL':16s} pairs={len(names)} time={dt:.3f}s (incl. compile) "
          f"pairs/sec={len(names)/dt:.3f}")
    summary = {
        "dir": str(data), "pairs": len(names), "time_s": round(dt, 3),
        "pairs_per_sec": round(len(names) / dt, 4),
        "median_rmse": round(float(np.median(metrics["rmse"])), 6),
    }
    if n_scored:
        poses = [r["pose_rmse"] for r in rows if "pose_rmse" in r]
        summary.update(
            pose_scored=n_scored,
            pose_success_rate=round(n_pass / n_scored, 4),
            median_pose_rmse=round(float(np.median(poses)), 6),
        )
        print(f"{'POSE':16s} scored={n_scored} success={n_pass}/{n_scored} "
              f"median_pose_rmse={summary['median_pose_rmse']:.5f}")
    if args.json:
        Path(args.json).write_text(
            json.dumps({**summary, "rows": rows}, indent=1))
        print(f"wrote {args.json}")
    return 0


def _measure(args) -> int:
    device = _device(args)
    from kss_icp_torch.io.formats import load_points
    from kss_icp_torch.metrics import registration_measure

    a = load_points(args.aligned)
    t = load_points(args.target)
    m = registration_measure(a, t, device=device)
    print(f"MSE:  {m['mse']:.6g}")
    print(f"RMSE: {m['rmse']:.6g}")
    print(f"MAE:  {m['mae']:.6g}")
    return 0


def _resample(args) -> int:
    device = _device(args)
    from kss_icp_torch.core.cloud import PointCloud
    from kss_icp_torch.io.formats import load_points, save_xyz

    from kss_icp_torch.ops.resample import fps_points

    pts = load_points(args.input)
    cloud = PointCloud.from_points(pts, device=device)
    out, mask = fps_points(cloud.points, cloud.mask, args.count)
    save_xyz(args.output, out[mask].cpu().numpy())
    print(f"resampled {pts.shape[0]} -> {int(mask.sum())}")
    return 0


def _simplify(args) -> int:
    """Cloud simplification front-end — the Method_CGAL / Method_Octree / AIVS
    tool surface (grid, hierarchy, wlop, octree, aivs, fps)."""
    device = _device(args)
    import torch

    from kss_icp_torch.core.cloud import PointCloud
    from kss_icp_torch.io.formats import load_points, save_xyz

    pts = load_points(args.input)
    cloud = PointCloud.from_points(pts, device=device)
    pj, mj = cloud.points, cloud.mask

    if args.method == "fps":
        from kss_icp_torch.ops.resample import fps_points

        out, mask = fps_points(pj, mj, args.count)
    elif args.method == "aivs":
        from kss_icp_torch.ops.aivs import aivs_resample

        out, mask = aivs_resample(pj, mj, args.count)
    elif args.method == "wlop":
        from kss_icp_torch.ops.wlop import wlop_resample

        out, mask = wlop_resample(pj, mj, min(args.count, int(cloud.count)))
    elif args.method == "grid":
        from kss_icp_torch.ops.simplify import grid_simplify
        from kss_icp_torch.ops.spatial import estimate_radius

        cell = args.cell if args.cell else float(estimate_radius(pj, mj)) / 1.5
        out, mask = grid_simplify(pj, mj, torch.tensor(cell, dtype=pj.dtype, device=device))
    elif args.method == "hierarchy":
        from kss_icp_torch.ops.simplify import hierarchy_simplify

        out, mask = hierarchy_simplify(pj, mj, max_cluster_size=args.cluster_size)
    else:  # octree
        from kss_icp_torch.ops.simplify import octree_simplify

        out, mask = octree_simplify(pj, mj, target_points=args.count)

    result = out[mask].cpu().numpy()
    save_xyz(args.output, result)
    print(f"{args.method}: {pts.shape[0]} -> {result.shape[0]} points")
    return 0


def _make_pairs(args) -> int:
    """Synthetic benchmark-pair generation — the TransferPC driver
    (transferPC.hpp): resample to .wlop/.gird and perturb by a recorded
    transform, logging transfer.txt."""
    device = _device(args)
    from kss_icp_torch.io.formats import load_points
    from kss_icp_torch.transfer import TransferRecord, generate_fixture_set

    clouds, records = [], []
    for spec in args.cloud:
        # name=path[:axis:angle[:scale[:translation]]]
        name_path, *rest = spec.split(":")
        name, path = name_path.split("=")
        axis = rest[0] if rest else "x"
        angle = float(rest[1]) if len(rest) > 1 else 0.0
        scale = float(rest[2]) if len(rest) > 2 else 1.0
        trans = float(rest[3]) if len(rest) > 3 else 0.0
        clouds.append((name, load_points(path)))
        records.append(TransferRecord(name, axis, angle, scale, trans))
    pairs = generate_fixture_set(clouds, records, args.output_dir, device=device, wlop_points=args.wlop_points)
    for p in pairs:
        print(f"{p.name}: wlop={p.target.shape[0]} gird={p.source.shape[0]} "
              f"({p.record.line()})")
    return 0


def _measure_resample(args) -> int:
    """Resampling-quality metric — simMeasurement (pointCloudMeasure.hpp)."""
    device = _device(args)
    from kss_icp_torch.core.cloud import PointCloud
    from kss_icp_torch.io.formats import load_points
    from kss_icp_torch.measure_resample import simplification_measure

    original = PointCloud.from_points(load_points(args.original), device=device)
    simplified = PointCloud.from_points(load_points(args.simplified), device=device)
    m = simplification_measure(original.points, original.mask, simplified.points, simplified.mask)
    for k, v in m.items():
        print(f"{k}: {float(v):.6g}")
    return 0


def _view(args) -> int:
    _unported("view", "viz/view")


def _largescan(args) -> int:
    """Room-class end-to-end benchmark (kss_icp_torch/largescan.py): prints
    one JSON dict with per-stage wall times, full-res RMSE, pose error and
    the metric stage's rate."""
    device = _device(args)
    from kss_icp_torch.largescan import run_largescan

    out = run_largescan(n_points=args.points, pre_downsample=args.pre_downsample,
                        seed=args.seed, repeats=args.repeats, device=device)
    print(json.dumps(out))
    return 0


def _serve(args) -> int:
    """JSONL registration server.

    One request per stdin line: {"source": path, "target": path,
    "output": optional .xyz path}. Every request runs register_many on its
    one pair at the fixed `--full-pad`, so every request has the same
    shapes; the kernels are built by the first. One JSON response line per
    request on stdout, flushed; a failed request answers {"ok": false,
    "error": ...} and the server goes on. The reference ships no serving
    surface: this is its batch loop (Main_KSS_List.cpp:151-179) as a
    long-lived process."""
    device = _device(args)
    from kss_icp_torch.io.formats import load_points, save_xyz
    from kss_icp_torch.parallel.batch import register_many

    cfg = _cfg_from_args(args)
    print(json.dumps({"event": "ready", "full_pad": args.full_pad}),
          flush=True)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
            t0 = time.perf_counter()
            src = load_points(req["source"])
            tgt = load_points(req["target"])
            res, metrics = register_many(
                [(src, tgt)], cfg, full_pad=args.full_pad,
                escalate=args.escalate, device=device,
            )
            dt = time.perf_counter() - t0
            if req.get("output"):
                save_xyz(req["output"], _aligned(_row(res.transform, 0), src, device))
            out = {
                "ok": True,
                "source": req["source"],
                "target": req["target"],
                "mse": float(metrics["mse"][0]),
                "rmse": float(metrics["rmse"][0]),
                "mae": float(metrics["mae"][0]),
                "fitness": float(res.fitness[0]),
                "time_s": round(dt, 4),
            }
        except Exception as e:  # keep serving; report the failure
            out = {"ok": False, "error": f"{type(e).__name__}: {e}",
                   "request": line[:500]}
        print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="kss_icp_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    def add_device(p):
        p.add_argument("--device", default="cuda",
                       help="torch device: cuda (the default; the port's kernels) or cpu "
                            "(the plain PyTorch path); no fallback between them")

    def add_common(p):
        p.add_argument("--accurate", type=int, default=8,
                       help="rotation grid steps per axis (reference: 8)")
        p.add_argument("--escalate", action=argparse.BooleanOptionalAction,
                       default=None,
                       help="re-solve high-fitness results on a finer 16^3 "
                            "grid (default: on, via cfg.auto_escalate; "
                            "--no-escalate disables)")
        p.add_argument("--iterations", type=int, default=1000,
                       help="max ICP iterations (reference: 1000)")
        p.add_argument("--overlap", action="store_true",
                       help="overlap-robust mode for partially-overlapping "
                            "scans (trimmed coarse field + trimmed "
                            "similarity ICP + iterated inlier pre-shape)")
        p.add_argument("--max-candidates", type=int, default=32)
        p.add_argument("--precise", action="store_true",
                       help="winner-neighborhood precision restarts "
                            "(12 extra warm-started converges around the "
                            "winning pose; slower, tighter poses on "
                            "narrow-basin shapes)")
        add_device(p)
        p.add_argument("--log-json", default=None, metavar="FILE",
                       help="append structured JSON-lines events to FILE")

    p = sub.add_parser("register", help="register source onto target")
    p.add_argument("source")
    p.add_argument("target")
    p.add_argument("-o", "--output", default=None, help=".xyz output path")
    p.add_argument("--json", action="store_true")
    p.add_argument("--pre-downsample", type=int, default=0, metavar="N",
                   help="octree-downsample inputs above N points first (the "
                        "reference's Room/block large-scan protocol, "
                        "Method_Octree.hpp:16 / start_Cuda.bat)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the registration "
                        "(CPU and CUDA activity) to DIR/trace.json")
    add_common(p)
    p.set_defaults(fn=_register)

    p = sub.add_parser("batch", help="register a list of model pairs")
    p.add_argument("list_file")
    p.add_argument("data_dir")
    p.add_argument("--source-ext", default=".gird")
    p.add_argument("--target-ext", default=".wlop")
    p.add_argument("--output-dir", default=None)
    p.add_argument("--success-list", default=None, metavar="FILE",
                   help="write an ICP.txt-style success line")
    p.add_argument("--success-threshold", type=float, default=0.0015,
                   help="fitness threshold for the success list")
    p.add_argument("--resume", action="store_true",
                   help="skip models whose <name>Align.xyz already exists")
    p.add_argument("--batched", action="store_true",
                   help="register the whole list as one batch (register_many)")
    add_common(p)
    p.set_defaults(fn=_batch)

    p = sub.add_parser(
        "bench-dir",
        help="run the full bench protocol over a directory of model pairs "
             "(pose-scored when a transfer.txt manifest is present)")
    p.add_argument("data_dir")
    p.add_argument("--source-ext", default=".gird",
                   help="source suffix (e.g. .gird, _source.ply)")
    p.add_argument("--target-ext", default=".wlop",
                   help="target suffix (e.g. .wlop, _target.ply)")
    p.add_argument("--manifest", default=None,
                   help="transfer.txt-style ground-truth log "
                        "(default: <dir>/transfer.txt if present)")
    p.add_argument("--pose-threshold", type=float, default=0.2,
                   help="pose-RMSE success bar for manifest-scored pairs "
                        "(default 0.2 = the calibrated basin-correctness "
                        "bar; pass 0.1 for the strict precision bar)")
    p.add_argument("--full-pad", type=int, default=8192,
                   help="static padded cloud size")
    p.add_argument("--limit", type=int, default=0,
                   help="only the first N discovered pairs")
    p.add_argument("--json", default=None, metavar="FILE",
                   help="write the per-pair table + summary as JSON")
    add_common(p)
    p.set_defaults(fn=_bench_dir)

    p = sub.add_parser(
        "largescan",
        help="Room/block-class large-scan benchmark (octree -> register -> "
             "full-res metric; reference protocol EXE/start_Cuda.bat + "
             "Method_Octree.hpp:16-108)")
    p.add_argument("-n", "--points", type=int, default=200_000,
                   help="points per synthetic room scan")
    p.add_argument("--pre-downsample", type=int, default=80_000,
                   help="octree target working-set size (Method_Octree.hpp:16)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--repeats", type=int, default=1,
                   help="timed passes after the first run")
    add_device(p)
    p.set_defaults(fn=_largescan)

    p = sub.add_parser("serve", help="JSONL registration server on stdin/stdout")
    p.add_argument("--full-pad", type=int, default=8192,
                   help="static padded cloud size (every request the same shapes)")
    add_common(p)
    p.set_defaults(fn=_serve)

    p = sub.add_parser("measure", help="MSE/RMSE/MAE of aligned vs target")
    p.add_argument("aligned")
    p.add_argument("target")
    add_device(p)
    p.set_defaults(fn=_measure)

    p = sub.add_parser("resample", help="FPS-resample a cloud to N points")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-n", "--count", type=int, default=2000)
    add_device(p)
    p.set_defaults(fn=_resample)

    p = sub.add_parser("simplify", help="simplify/resample a cloud")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-m", "--method", default="fps",
                   choices=["fps", "aivs", "wlop", "grid", "hierarchy", "octree"])
    p.add_argument("-n", "--count", type=int, default=2000)
    p.add_argument("--cell", type=float, default=None,
                   help="grid cell size (default: radius/1.5)")
    p.add_argument("--cluster-size", type=int, default=10)
    add_device(p)
    p.set_defaults(fn=_simplify)

    p = sub.add_parser("make-pairs",
                       help="generate synthetic benchmark pairs (TransferPC)")
    p.add_argument("cloud", nargs="+",
                   help="name=path[:axis:angle[:scale[:translation]]]")
    p.add_argument("-o", "--output-dir", default="pairs")
    p.add_argument("--wlop-points", type=int, default=8000)
    add_device(p)
    p.set_defaults(fn=_make_pairs)

    p = sub.add_parser("measure-resample",
                       help="MLS displacement quality of a simplified cloud")
    p.add_argument("original")
    p.add_argument("simplified")
    add_device(p)
    p.set_defaults(fn=_measure_resample)

    p = sub.add_parser("view", help="render a registration overlay PNG (not ported yet)")
    p.add_argument("target")
    p.add_argument("-s", "--source", default=None)
    p.add_argument("-a", "--aligned", default=None)
    p.add_argument("-o", "--output", default="view.png")
    p.add_argument("--size", type=int, default=800)
    p.add_argument("--spin", type=float, default=0.0,
                   help="trackball drag magnitude for an off-axis view")
    p.add_argument("--interactive", action="store_true",
                   help="interactive terminal viewer instead of a PNG")
    p.set_defaults(fn=_view)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except CLIError as e:
        print(f"error: {e}", file=sys.stderr)
        return e.status


if __name__ == "__main__":
    sys.exit(main())
