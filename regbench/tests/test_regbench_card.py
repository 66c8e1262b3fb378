"""The measurement path needs the card: without one it fails and prints no
result, and it never falls back to the CPU; in a directory holding only the
benchmark it fails too."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "objects.full-overlap.b64", "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"]


def _run(cwd: Path):
    return subprocess.run([sys.executable, "regbench/run.py", *ARGS], capture_output=True, text=True, timeout=300,
                          cwd=cwd)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the card-less path cannot be shown here")
    out = _run(ROOT)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_run_refuses_without_a_card_in_process():
    import torch

    sys.path.insert(0, str(ROOT))
    from regbench import harness

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(harness.NoCard):
        harness.run("objects.full-overlap.b64", 1, 1.0, False)


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for path in json.loads((ROOT / "BENCHMARK.json").read_text())["paths"]:
        shutil.copytree(ROOT / path, tmp_path / path, ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
