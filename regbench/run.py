"""Run one cell of the benchmark once and print its result line.

    python3 regbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cell's CUDA devices.
The last line of standard output is one JSON object: "correct", "attempted",
"failed", "metrics" (the cell's end-to-end metrics, or with --trace 1 its
per-layer ones), "device", with --trace 1 "breakdown", and last "compared",
each number the reference compared beside its limit; those numbers are also
the last lines of standard error. Exits 2 without a card, 3 where the run
loaded JAX or the JAX package, 1 on any other failure, printing no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from regbench import harness

    try:
        result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    except harness.NoCard as e:
        print(f"regbench: {e}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"regbench: the run loaded {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
