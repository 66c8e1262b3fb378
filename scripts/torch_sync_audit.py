"""The host-device syncs of the port's hot path, as CUDA's sync debug mode sees them.

    python3 scripts/torch_sync_audit.py [--cells NAME,...] [--seed N] [--out FILE]

For each benchmark cell of BENCHMARK.json (all by default): the cell's
entry (regbench/entries) prepared at its configuration, one warm-up call,
then one call under torch.cuda.set_sync_debug_mode("warn"). Every
synchronizing operation of that call is listed by its site (the innermost
frame in kss_icp_torch, else in regbench), the innermost "kss.sync.*" span
around it ("-" where no sync span names it) and the innermost other "kss."
span, with how often the call reached it; then the syncs a lockstep ICP
iteration (those inside "kss.icp.step" spans over the call's growth of
`icp.lockstep_iterations`) and how many of those iterations ran the
`icp_update` kernel (`icp.fused_steps`), and the call's `nn1` launches by
plan (`nn1.plan_launches`: queries a thread, cluster). The spans are
tracked by standing in for the profiler's ranges (utils/profiling.py), so
no profiler runs. Needs a CUDA card; writes the table as JSON to FILE
(default sync_audit.json).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import traceback
import warnings
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _site(frames) -> str:
    """The innermost frame in the port (past its read helpers), else in the
    benchmark's entries."""
    for pkg in ("kss_icp_torch/", "regbench/"):
        for f in reversed(frames):
            if pkg in f.filename and f.name not in ("_host", "_to_device"):
                return f"{f.filename[f.filename.index(pkg):]}:{f.lineno} {f.name}"
    return "outside the repo"


def audit(cell: str, seed: int):
    import torch

    from kss_icp_torch.ops.nn_cuda import nn1
    from kss_icp_torch.utils import profiling
    from regbench import entries, generate, harness

    spec = harness.load_cell(cell)
    config, mix = spec["config"], spec["mix"]
    device = torch.device("cuda", 0)
    calls = generate.make_calls(config, mix, seed)
    call = __import__(f"regbench.entries.{mix['entry']}", fromlist=["prepare"]).prepare(config, mix, device)
    call(calls[0], None)
    torch.cuda.synchronize()

    stack = []

    @contextlib.contextmanager
    def tracked(name):
        stack.append(name)
        try:
            yield
        finally:
            stack.pop()

    seen = Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        sync = next((n for n in reversed(stack) if n.startswith("kss.sync.")), "-")
        where = next((n for n in reversed(stack) if not n.startswith("kss.sync.")), "-")
        seen[_site(traceback.extract_stack()[:-1]), sync, where, "kss.icp.step" in stack] += 1

    counter = entries.counters()["icp.lockstep_iterations"]
    icp = __import__("kss_icp_torch.models.icp", fromlist=["icp"]).icp
    saved = profiling._recording, profiling.trace_annotation
    profiling._recording, profiling.trace_annotation = (lambda: True), tracked
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            it0, fused0 = counter(), icp.fused_steps
            nn1.plan_launches.clear()
            call(calls[1 % len(calls)], None)
            torch.cuda.set_sync_debug_mode("default")
            iterations, fused = counter() - it0, icp.fused_steps - fused0
    finally:
        profiling._recording, profiling.trace_annotation = saved
    torch.cuda.synchronize()
    rows = [{"site": s, "sync_span": sy, "span": w, "in_step": st, "count": n}
            for (s, sy, w, st), n in sorted(seen.items(), key=lambda kv: -kv[1])]
    in_step = sum(r["count"] for r in rows if r["in_step"])
    return {"cell": cell, "pairs": len(calls[1 % len(calls)]), "lockstep_iterations": iterations, "fused_steps": fused,
            "nn1_plans": {f"{q}x{c}": n for (q, c), n in sorted(nn1.plan_launches.items())},
            "syncs": sum(r["count"] for r in rows), "syncs_in_steps": in_step,
            "unnamed": sum(r["count"] for r in rows if r["sync_span"] == "-"),
            "syncs_per_iteration": in_step / iterations if iterations else None, "sites": rows}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cells", default=None, help="comma-separated cells (default: every cell)")
    p.add_argument("--seed", type=int, default=2718281828)
    p.add_argument("--out", default="sync_audit.json")
    args = p.parse_args(argv)
    cells = args.cells.split(",") if args.cells else [w["name"] for w in
                                                      json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
    out = []
    for cell in cells:
        try:
            r = audit(cell, args.seed)
        except Exception:
            traceback.print_exc()
            return 1
        out.append(r)
        print(f"{cell}: {r['syncs']} syncs over {r['pairs']} pairs, {r['lockstep_iterations']} lockstep iterations "
              f"({r['fused_steps']} fused), {r['syncs_per_iteration']} syncs an iteration, {r['unnamed']} in no sync "
              f"span; nn1 launches by plan (queries a thread x cluster): {r['nn1_plans']}", flush=True)
        for row in r["sites"]:
            print(f"  {row['count']:6d}  {row['sync_span']:22s} {row['span']:24s} "
                  f"{'step' if row['in_step'] else '    '}  {row['site']}", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
