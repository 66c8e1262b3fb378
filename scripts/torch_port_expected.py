"""Record the JAX package's answers on the 25 remesh fixture pairs.

Runs `kss_icp_tpu.register_pair` on the CPU with auto_escalate=False (the
slice the PyTorch port implements) at two configs, DEFAULT_CONFIG and
bench.bench_config(), applies the transform to the full-resolution source
and measures it with `registration_measure`. Writes, per pair, the chosen
candidate, ICP fitness, ICP iteration count, the hit-cap flag, the
similarity transform and the full-resolution RMSE to
fixtures/torch_port_expected.json — the reference that chip_smoke.py and
tests/test_torch_expected.py hold the port to (RMSE within JAX + 0.006).

    JAX_PLATFORMS=cpu python scripts/torch_port_expected.py [--out PATH]

About 16 s per pair at DEFAULT_CONFIG and 8 s at the bench config on an
8-core x86 CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path,
                    default=REPO / "fixtures" / "torch_port_expected.json")
    ap.add_argument("--limit", type=int, default=0,
                    help="only the first N pairs (0 = all 25)")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(REPO))
    from kss_icp_tpu.config import DEFAULT_CONFIG
    from kss_icp_tpu.core.transforms import apply_similarity
    from kss_icp_tpu.metrics import registration_measure
    from kss_icp_tpu.models.kss_icp import register_pair
    from kss_icp_tpu.stress import remesh_corpus

    from bench import bench_config

    corpus = remesh_corpus()
    if args.limit:
        corpus = corpus[: args.limit]

    def run(cfg):
        pairs = []
        for name, src, tgt, _ in corpus:
            t0 = time.perf_counter()
            res = register_pair(src, tgt, cfg)
            aligned = np.asarray(apply_similarity(res.transform, src))
            rmse = registration_measure(aligned, tgt)["rmse"]
            tr = res.transform
            pairs.append({
                "name": name,
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
            })
            p = pairs[-1]
            print(f"{name}: cand={p['chosen_candidate']} fit={p['fitness']:.6g} "
                  f"iters={p['icp_iterations']} rmse={rmse:.6f} "
                  f"({time.perf_counter() - t0:.1f} s)", file=sys.stderr, flush=True)
        return pairs

    bench = dataclasses.replace(bench_config(), auto_escalate=False)
    knobs = {f.name: getattr(bench, f.name) for f in dataclasses.fields(bench)
             if getattr(bench, f.name) != getattr(DEFAULT_CONFIG, f.name)}
    out = {
        "platform": "jax " + jax.__version__ + " on cpu",
        "rmse_band": 0.006,
        "config": "DEFAULT_CONFIG with auto_escalate=False",
        "pairs": run(dataclasses.replace(DEFAULT_CONFIG, auto_escalate=False)),
        "bench_config": {"knobs": knobs, "pairs": run(bench)},
    }
    args.out.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {len(corpus)} pairs x 2 configs to {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
