"""One run of one cell: set-up, the measured window, the traced window, the
reference's check, the result line.

Everything a cell needs is found by name: BENCHMARK.json lists the cell with
its configuration and traffic mix; the configuration is
`regbench/configs/<config>.json` (its sizes, the program's settings, the
accuracy bar and the reference that judges it,
`regbench/reference/<reference>.py`); the mix is
`regbench/traffic/<traffic>.json` (read by regbench/generate.py, which finds
its pair source in `regbench/sources/`; naming the program's entry in
`regbench/entries/`; and holding the cell's limits of the numbers the
reference compares); each end-to-end metric is read by
`regbench/endtoend/<name>.py` and each per-layer metric by
`regbench/metrics/<name>.py`.
"""

from __future__ import annotations

import gc
import importlib
import json
import re
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from regbench import entries, generate, yardstick
from regbench.spans import Spans

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level modules that must not be loaded in a run (compared whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "kss_icp_tpu")


class NoCard(RuntimeError):
    pass


def load_cell(workload: str, bench: Optional[Dict] = None) -> Dict:
    """The cell's entry in BENCHMARK.json, its configuration and mix, and the
    metrics it reports."""
    bench = bench or json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    config = json.loads((HERE / "configs" / f"{cell['config']}.json").read_text())
    mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload] if m["moves"] in moved else [])]
    return {"cell": cell, "config": config, "mix": mix, "end_to_end": e2e, "per_layer": per_layer}


def kernel_names() -> List[str]:
    """The program's own kernels: the `__global__` functions of its CUDA
    sources."""
    names = []
    for src in sorted((ROOT / "kss_icp_torch" / "csrc").glob("*.cu")):
        text = re.sub(r"__launch_bounds__\s*\([^)]*\)", "", src.read_text())
        names += re.findall(r"__global__\s+void\s+(\w+)\s*\(", text)
    return names


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def _drive(call, calls, start: int, count: Optional[int], seconds: Optional[float], timer, device):
    """Calls from calls[start] on, cycling, until `count` calls or until
    `seconds` have passed at the end of a call. Returns ([(call index,
    answers or the exception, seconds)], host seconds)."""
    record = []
    t0 = time.perf_counter()
    i = start
    while True:
        pairs = calls[i % len(calls)]
        t1 = time.perf_counter()
        try:
            answers = call(pairs, timer)
            _sync(device)
        except Exception as e:  # a failed call is counted and the run goes on
            traceback.print_exc(file=sys.stderr)
            answers = e
        t2 = time.perf_counter()
        record.append((i % len(calls), answers, t2 - t1))
        i += 1
        if (count is not None and len(record) >= count) or (seconds is not None and t2 - t0 >= seconds):
            return record, t2 - t0


def _quarters(calls, record, window_s: float) -> List[float]:
    """Pairs a second in each quarter of the window, each call counted in the
    quarter in which it ended: whether the rate drifts inside a run."""
    ends = np.cumsum([s for _, _, s in record])
    quarter = np.minimum((4 * ends / max(window_s, 1e-9)).astype(int), 3)
    pairs = np.array([len(calls[k]) for k, _, _ in record])
    return [float(pairs[quarter == q].sum() / (window_s / 4)) for q in range(4)]


def _call_seconds(calls, record) -> Dict[str, List[float]]:
    """For each of the mix's calls, named by its first pair's name in sorted
    order: how often the window ran it and the median of its seconds."""
    seconds: Dict[str, List[float]] = {}
    for k, _, s in record:
        seconds.setdefault(min(p.name for p in calls[k]), []).append(s)
    return {name: [len(v), float(np.median(v))] for name, v in sorted(seconds.items())}


def _profile(fn, device, host: bool):
    """fn() under torch.profiler: the device's activity on the card, and with
    `host` the host's operations and the benchmark's spans too. Returns (fn's
    result, the events as chrome-trace dicts)."""
    from torch.profiler import ProfilerActivity, profile

    acts = ([ProfilerActivity.CPU] if host or device.type != "cuda" else []) + \
        ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        out = fn()
    return out, yardstick.events_of(prof)


def _check_sample(mix: Dict, done, seed: int):
    """Which of the window's finished calls (indices into `done`) get their
    metric checked: all, or with the mix's "check_calls" the first call of
    each of the mix's calls and the rest drawn from the seed up to that
    number."""
    if not mix.get("check_calls") or len(done) <= mix["check_calls"]:
        return set(range(len(done)))
    first = {}
    for j, (k, _) in enumerate(done):
        first.setdefault(k, j)
    rest = sorted(set(range(len(done))) - set(first.values()))
    extra = generate.rng_of(seed, 999).permutation(rest)[:max(0, mix["check_calls"] - len(first))]
    return set(first.values()) | {int(j) for j in extra}


def judge(spec: Dict, calls, record, device, seed: int, fresh=((), ())) -> Dict:
    """The reference's check of every answer the runs produced: the pose
    error of every pair, the metric of every pair or of a sample drawn from
    the seed (the mix's "check_calls"), and the pairs with no answer; then
    the same of the `fresh` (calls, record) that the seed drew afresh, every
    metric checked.

    Compared: "metric_gap", the worst pair's; "pose_median", over all pairs;
    "over_bar", the share of the window's pairs whose pose error is over the
    configuration's pose_bar, and "fresh_over_bar" the same of the fresh
    pairs (where the mix has them); "missing", the pairs with no answer.

    "failed" counts the operations that failed: the pairs with no answer (a
    call that raised, an answer of the wrong length, a value that is not
    finite). A pair answered with a pose over the bar is an answer, judged by
    "over_bar" and "fresh_over_bar"; "over_bar_pairs" counts those pairs."""
    config, mix = spec["config"], spec["mix"]
    ref = importlib.import_module(f"regbench.reference.{config['reference']}")
    ingest, bar = config["ingest"], config["pose_bar"]
    missing, gaps, poses, over = 0, [], [], {}
    for group, (g_calls, g_record) in (("window", (calls, record)), ("fresh", fresh)):
        if group == "fresh" and not g_calls:
            continue
        done = [(k, answers) for k, answers, _ in g_record if not isinstance(answers, Exception)]
        for k, answers, _ in g_record:
            if isinstance(answers, Exception) or len(answers) != len(g_calls[k]):
                missing += len(g_calls[k])
        checked = _check_sample(mix, done, seed) if group == "window" else set(range(len(done)))
        prepared, g_poses = {}, []
        for j, (k, answers) in enumerate(done):
            if len(answers) != len(g_calls[k]):
                continue
            for i, (pair, ans) in enumerate(zip(g_calls[k], answers)):
                if not all(np.all(np.isfinite(np.asarray(x, np.float64))) for x in ans):
                    missing += 1
                    continue
                if (k, i) not in prepared:
                    prepared[k, i] = ref.prepare(pair, ingest, device)
                got = ref.judge_pair(prepared[k, i], ans, metric=j in checked)
                gaps += [got["metric_gap"]] if j in checked else []
                g_poses.append(got["pose_error"])
        del prepared
        poses += g_poses
        over[group] = float(np.mean([p > bar for p in g_poses])) if g_poses else 1.0
    numbers = {"metric_gap": max(gaps) if gaps else float("inf"),
               "pose_median": float(np.median(poses)) if poses else float("inf"),
               "over_bar": over["window"]}
    if "fresh" in over:
        numbers["fresh_over_bar"] = over["fresh"]
    numbers["missing"] = float(missing)
    limits = mix["limits"]
    return {"numbers": numbers, "limits": limits,
            "correct": set(numbers) == set(limits) and all(numbers[k] <= limits[k] for k in limits),
            "failed": missing, "over_bar_pairs": int(sum(p > bar for p in poses)),
            "checked_pairs": len(gaps), "posed_pairs": len(poses)}


def run(workload: str, seed: int, seconds: float, trace: bool, device=None, spec: Optional[Dict] = None,
        call_of: Optional[Callable] = None, t_start: Optional[float] = None) -> Dict:
    """One run of the cell: returns the result line's dict. Without `device`
    it takes the card and raises NoCard where there is none (or fewer than
    the cell asks for): the measurement never falls back to the CPU. `spec`
    replaces the cell as load_cell gives it, and `call_of(spec, device)` the
    program's call (the tests use both at small sizes on the CPU)."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = spec or load_cell(workload)
    cell, config, mix = spec["cell"], spec["config"], spec["mix"]
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise NoCard(f"{workload} needs {cell['chips']} CUDA device(s); "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    entry = importlib.import_module(f"regbench.entries.{mix['entry']}")
    calls = generate.make_calls(config, mix, seed)
    call = (call_of or (lambda s, d: entry.prepare(s["config"], s["mix"], d)))(spec, device)
    for c in calls[:mix["warm_calls"]]:
        call(c, None)
    _sync(device)
    setup_s = time.perf_counter() - t_start

    counters = entries.counters()
    before = {k: f() for k, f in counters.items()}
    spans = Spans(timed=True, device=device) if trace else None
    record, window_s = _drive(call, calls, mix["warm_calls"], None, seconds, spans, device)
    grown = {k: f() - before[k] for k, f in counters.items()}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    result: Dict = {}
    if trace:
        # Two sub-windows after the timed one, each of the mix's trace_calls:
        # the device alone, for its busy time, its operations and its idle
        # share (recording the host's operations would slow the host and
        # widen the device's gaps); then the host too, for what the host did
        # in each gap and which launches the benchmark's spans made.
        t0 = time.perf_counter()
        start = mix["warm_calls"] + len(record)
        (sub, sub_s), events = _profile(lambda: _drive(call, calls, start, mix["trace_calls"], None, None, device),
                                        device, host=False)
        busy_s = yardstick.device_busy_us(events) * 1e-6
        device_ops = yardstick.device_ops(events)
        start += len(sub)
        (sub2, _), host_events = _profile(
            lambda: _drive(call, calls, start, mix["trace_calls"], None, Spans(timed=False, device=device), device),
            device, host=True)
        sub_pairs = [p for k, _, _ in sub for p in calls[k]]
        ctx = {"spans": dict(spans.seconds), "pairs": sum(len(calls[k]) for k, _, _ in record), "calls": len(record),
               "counters": grown, "trace": events, "host_trace": host_events, "trace_pairs": len(sub_pairs),
               "trace_calls": len(sub), "trace_window_s": sub_s, "busy_s": busy_s, "kernel_names": kernel_names(),
               "metric_rows": [entry.metric_rows(config, p) for k, _, _ in sub2 for p in calls[k]]}
        metrics = {}
        for m in spec["per_layer"]:
            value = importlib.import_module(f"regbench.metrics.{m['name']}").read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = {"device_ops": device_ops, "idle_gaps": yardstick.idle_gaps(host_events)}
        result["trace_seconds"] = time.perf_counter() - t0
        result["trace_events"] = [len(events), len(host_events)]
        record = record + sub + sub2
        del events, host_events, ctx
    else:
        window = {"pairs": sum(len(calls[k]) for k, _, _ in record), "seconds": window_s, "setup_s": setup_s,
                  "pair_latencies_ms": [1e3 * s for k, _, s in record for _ in calls[k]]}
        metrics = {m["name"]: {"value": importlib.import_module(f"regbench.endtoend.{m['name']}").read(window),
                               "unit": m["unit"]} for m in spec["end_to_end"]}
        result["window_quarters"] = _quarters(calls, record, window_s)
        result["call_s"] = _call_seconds(calls, record)

    # The check's fresh pairs, through the same call after the windows.
    fresh = generate.fresh_calls(config, mix, seed)
    fresh_record, _ = _drive(call, fresh, 0, len(fresh), None, None, device) if fresh else ([], 0.0)

    # The program's state goes before the reference runs on the device.
    del call
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    verdict = judge(spec, calls, record, device, seed, fresh=(fresh, fresh_record))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if trace:
        dev.update(busy_s=busy_s, window_s=sub_s)
    if device.type == "cuda":
        dev["power_limit"] = _power_limit()
    result = {"correct": verdict["correct"],
              "attempted": sum(len(calls[k]) for k, _, _ in record) + sum(len(c) for c in fresh),
              "failed": verdict["failed"], "metrics": metrics, "device": dev, **result,
              "setup_s": setup_s, "window_s": window_s, "calls": len(record),
              "reference_seconds": time.perf_counter() - t0, "checked_pairs": verdict["checked_pairs"],
              "over_bar_pairs": verdict["over_bar_pairs"],
              "compared": {k: {"value": v, "limit": verdict["limits"].get(k)} for k, v in verdict["numbers"].items()}}
    return result


def _power_limit() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
