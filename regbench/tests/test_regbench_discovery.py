"""A configuration, a traffic mix and a per-layer metric added as new files,
with entries in BENCHMARK.json, are found and run without an edit to any file
the benchmark has."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from regbench.tests.small import SMALL_KSS  # noqa: E402


def test_new_files_are_found_by_name(tmp_path):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    shutil.copytree(ROOT / "regbench", tmp_path / "regbench", ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "kss_icp_torch", tmp_path / "kss_icp_torch")
    before = {p: p.read_bytes() for p in (tmp_path / "regbench").rglob("*") if p.is_file()}

    config = json.loads((ROOT / "regbench" / "configs" / "objects-shipped.json").read_text())
    config.update(name="objects-small", kss_config=SMALL_KSS, full_pad=1024)
    (tmp_path / "regbench" / "configs" / "objects-small.json").write_text(json.dumps(config))
    mix = json.loads((ROOT / "regbench" / "traffic" / "partial-overlap.b64.json").read_text())
    mix.update(batch=8, calls=2, points=600, trace_calls=1)
    (tmp_path / "regbench" / "traffic" / "partial.b8.json").write_text(json.dumps(mix))
    (tmp_path / "regbench" / "metrics" / "pairs_seen.py").write_text(
        "def read(ctx):\n    return float(ctx['pairs'])\n")
    bench["configs"].append({"name": "objects-small", "source": "https://arxiv.org/abs/2211.02807",
                             "file": "regbench/configs/objects-small.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "small.partial.b8", "config": "objects-small", "traffic": "partial.b8",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "pairs_seen", "unit": "pairs", "better": "higher", "source": "host_clock",
                               "layer": "entry", "moves": "pairs_per_s", "workloads": ["small.partial.b8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {str(tmp_path)!r})
        from regbench import harness
        spec = harness.load_cell("small.partial.b8")
        assert spec["config"]["name"] == "objects-small" and spec["mix"]["batch"] == 8
        assert [m["name"] for m in spec["per_layer"]] == ["pairs_seen"]
        r = harness.run("small.partial.b8", 3, 0.1, True, device="cpu")
        print(json.dumps({{"metrics": r["metrics"], "attempted": r["attempted"]}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["metrics"]["pairs_seen"]["value"] >= 8
    assert got["metrics"]["pairs_seen"]["unit"] == "pairs"
    after = {p: p.read_bytes() for p in before}
    assert after == before
