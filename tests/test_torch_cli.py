"""The port's command line, `python -m kss_icp_torch ... --device cpu`, at
tiny flags on small seeded clouds, mirroring tests/test_cli_smoke.py: the
subcommands run as subprocesses with the JAX CLI's printed lines and JSON
keys, the tools (simplify -m aivs|wlop|hierarchy, make-pairs,
measure-resample) and `view` against the JAX CLI on the same files (view's
PNG bytes equal), `--device cuda` without a card exits nonzero, and one in-process register is held to
`kss_icp_tpu.cli.main` on the same files (RMSE within JAX + 0.006)."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from helpers import random_cloud
from kss_icp_torch import cli
from kss_icp_torch.io.formats import load_points, save_xyz
from kss_icp_torch.transfer import TransferRecord, apply_record, save_transfer_log

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TINY = ["--accurate", "2", "--iterations", "20", "--max-candidates", "2"]
RMSE_BAND = 0.006


def _run(args, stdin=None, timeout=240):
    # One torch thread, as the test workers run (ROADMAP.md "Tests").
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "kss_icp_torch", *args], input=stdin, capture_output=True,
                          text=True, timeout=timeout, cwd=REPO, env=env)


def _metric(text, key):
    return float(re.search(rf"^{key}:\s+(\S+)$", text, re.M).group(1))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A wavy surface and a rotated, subsampled copy of it."""
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    tgt = random_cloud(rng, 1200)
    src = apply_record(tgt[::2], TransferRecord("s", "z", 0.3))
    save_xyz(d / "src.xyz", src)
    save_xyz(d / "tgt.xyz", tgt)
    return d


def test_register_then_measure_prints_the_same_rmse(files, tmp_path):
    out, log = tmp_path / "aligned.xyz", tmp_path / "events.jsonl"
    # --no-escalate: this pair's fitness would climb the escalation ladder,
    # minutes on the CPU (tests/test_torch_escalate.py and _overlap.py hold it).
    args = ["register", str(files / "src.xyz"), str(files / "tgt.xyz"), "-o", str(out), "--device", "cpu",
            "--no-escalate", *TINY]
    r = _run(args + ["--json", "--log-json", str(log)])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "loaded source=600 target=1200 points" in r.stdout and f"saved {out}" in r.stdout
    assert set(json.loads(r.stdout.splitlines()[-1])) == {"time_s", "mse", "rmse", "mae"}
    events = [json.loads(ln)["event"] for ln in log.read_text().splitlines()]
    assert events == ["load.start", "load.end", "register.start", "register.end", "result"]
    rmse = _metric(r.stdout, "RMSE")
    assert 0 < rmse < 0.05
    m = _run(["measure", str(out), str(files / "tgt.xyz"), "--device", "cpu"])
    assert m.returncode == 0, m.stderr[-2000:]
    assert _metric(m.stdout, "RMSE") == pytest.approx(rmse, rel=1e-5)  # the file holds %.6g
    lines = out.read_text().splitlines()
    assert int(lines[0]) == 600 and len(lines) == 601
    again = _run(args)  # a rerun truncates: the file does not grow
    assert again.returncode == 0, again.stderr[-2000:]
    assert out.read_text().splitlines() == lines


def test_serve_answers_each_request(files, tmp_path):
    """Escalation on (the default); the pair is the target twice, so no
    pair is flagged, as in tests/test_cli_smoke.py."""
    out = tmp_path / "served.xyz"
    good = json.dumps({"source": str(files / "tgt.xyz"), "target": str(files / "tgt.xyz"), "output": str(out)})
    bad = json.dumps({"source": str(tmp_path / "missing.xyz"), "target": str(files / "tgt.xyz")})
    r = _run(["serve", "--device", "cpu", "--full-pad", "2048", *TINY], stdin=good + "\n\n" + bad + "\n")
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [json.loads(ln) for ln in r.stdout.splitlines() if ln.strip()]
    assert lines[0] == {"event": "ready", "full_pad": 2048}
    assert lines[1]["ok"] is True and lines[1]["rmse"] < 1e-3 and out.exists()
    assert set(lines[1]) == {"ok", "source", "target", "mse", "rmse", "mae", "fitness", "time_s"}
    assert lines[2]["ok"] is False and lines[2]["error"].startswith("FileNotFoundError")
    assert len(lines) == 3


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """tests/test_cli_smoke.py::test_bench_dir_no_x64's two pairs and manifest."""
    rng = np.random.default_rng(3)
    d = tmp_path_factory.mktemp("ds")
    recs = []
    for i, ang in enumerate((0.7, 1.5)):
        u = rng.uniform(-1, 1, 900)
        v = rng.uniform(-1, 1, 900)
        z = 0.3 * np.sin(3 * u) * np.cos(2 * v) + 0.25 * u + 0.15 * v * v
        tgt = np.stack([u, v, z], axis=-1)
        rec = TransferRecord(name=f"m{i}", axis="z", angle=ang)
        save_xyz(d / f"m{i}.wlop", tgt)
        save_xyz(d / f"m{i}.gird", apply_record(tgt[::2], rec))
        recs.append(rec)
    save_transfer_log(d / "transfer.txt", recs)
    (d / "orphan.gird").write_text("1\n0 0 0\n")  # no target: not discovered
    return d


def test_bench_dir_scores_poses_from_the_manifest(dataset, tmp_path):
    out = tmp_path / "bd.json"
    r = _run(["bench-dir", str(dataset), "--accurate", "3", "--iterations", "30", "--max-candidates", "2",
              "--no-escalate", "--full-pad", "1024", "--json", str(out), "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "manifest:" in r.stdout and "POSE" in r.stdout
    res = json.loads(out.read_text())
    assert set(res) == {"dir", "pairs", "time_s", "pairs_per_sec", "median_rmse", "pose_scored",
                        "pose_success_rate", "median_pose_rmse", "rows"}
    assert res["pairs"] == 2 and res["pose_scored"] == 2
    assert res["pose_success_rate"] == 1.0, res
    assert res["median_rmse"] < 0.05, res
    assert set(res["rows"][0]) == {"name", "mse", "rmse", "mae", "fitness", "pose_rmse", "pose_ok"}


def test_batch_writes_the_success_list_and_resumes(dataset, tmp_path, capsys):
    names = tmp_path / "list.txt"
    names.write_text("m0\n")
    ok, outdir = tmp_path / "ICP.txt", tmp_path / "out"
    args = ["batch", str(names), str(dataset), "--device", "cpu", *TINY, "--no-escalate", "--output-dir", str(outdir)]
    r = _run(args + ["--success-list", str(ok), "--success-threshold", "1.0"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert ok.read_text() == "success: m0\n"
    assert re.search(r"^m0 +time= *\S+s MSE=\S+ RMSE=\S+ MAE=\S+$", r.stdout, re.M)
    assert sorted(p.name for p in outdir.iterdir()) == ["m0Align.xyz"]
    # --resume skips the models already written, and --batched runs the list as one batch.
    assert cli.main(args + ["--resume"]) == 0
    assert capsys.readouterr().out.count("skipped (resume: output exists)") == 1
    names.write_text("m0\nm1\n")
    assert cli.main(args[:-2] + ["--batched"]) == 0
    printed = capsys.readouterr().out
    assert re.search(r"^m1 +MSE=\S+ RMSE=\S+ MAE=\S+$", printed, re.M) and "amortized=" in printed


@pytest.mark.parametrize("method, count", [("fps", 300), ("grid", 0), ("octree", 300)])
def test_simplify_methods(files, tmp_path, method, count):
    out = tmp_path / f"{method}.xyz"
    r = _run(["simplify", str(files / "tgt.xyz"), str(out), "-m", method, "-n", str(count or 2000),
              "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    pts = load_points(out)
    assert r.stdout.strip() == f"{method}: 1200 -> {len(pts)} points"
    assert (len(pts) == count) if method == "fps" else (1 <= len(pts) < 1200)


def test_resample(files, tmp_path):
    out = tmp_path / "rs.xyz"
    r = _run(["resample", str(files / "tgt.xyz"), str(out), "-n", "250", "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "resampled 1200 -> 250"
    np.testing.assert_array_equal(np.unique(load_points(out), axis=0).shape, (250, 3))


@pytest.mark.parametrize("argv, item", [
    (["make-pairs", "a=a.xyz"], "make-pairs"),
    (["measure-resample", "a.xyz", "b.xyz"], "measure_resample"),
    (["view", "a.xyz"], "viz/view"),
    (["simplify", "a.xyz", "b.xyz", "-m", "aivs"], "aivs"),
    (["simplify", "a.xyz", "b.xyz", "-m", "wlop"], "wlop"),
    (["simplify", "a.xyz", "b.xyz", "-m", "hierarchy"], "hierarchy"),
])
def test_unported_subcommands_exit_2(capsys, files, tmp_path, argv, item):
    """Every case is ported: each runs the port's and the JAX CLI on the same
    files and holds them to the same printed lines and points, `view` to the
    same PNG bytes, with and without the trackball's spin (WLOP at its bar:
    median |Δ| 5e-5, max 2e-3 bounding-box diagonals; measure-resample's
    displacements follow each package's PCA normal signs, so they are held
    to the port's own simplification_measure, the sampling rate to JAX's)."""
    from kss_icp_tpu import cli as jcli

    src, tgt = str(files / "src.xyz"), str(files / "tgt.xyz")
    if item == "viz/view":
        # The JAX CLI's view takes no --platform, the port's no --device: both render on the host.
        for spin in ("0", "0.3"):
            pngs = {}
            for name, main in (("jax", jcli.main), ("torch", cli.main)):
                pngs[name] = tmp_path / f"{name}_{spin}.png"
                assert main(["view", tgt, "-s", src, "-a", tgt, "-o", str(pngs[name]), "--size", "200",
                             "--spin", spin]) == 0
                assert capsys.readouterr().out == f"saved {pngs[name]}\n"
            assert pngs["torch"].read_bytes() == pngs["jax"].read_bytes()
        return
    cases = {"aivs": ["simplify", tgt, "{out}.xyz", "-m", "aivs", "-n", "300"],
             "wlop": ["simplify", tgt, "{out}.xyz", "-m", "wlop", "-n", "300"],
             "hierarchy": ["simplify", tgt, "{out}.xyz", "-m", "hierarchy"],
             "make-pairs": ["make-pairs", f"t={tgt}:y:0.5", f"s={src}:z:-0.3:1.2:0.1", "-o", "{out}",
                            "--wlop-points", "300"],
             "measure_resample": ["measure-resample", tgt, src]}
    outs = {}
    for name, main, flags in (("jax", jcli.main, ["--platform", "cpu"]), ("torch", cli.main, ["--device", "cpu"])):
        out = tmp_path / name
        assert main([a.replace("{out}", str(out)) for a in cases[item]] + flags) == 0
        outs[name], outs[name + " printed"] = out, capsys.readouterr().out
    printed = outs["torch printed"]
    if item == "measure_resample":
        from kss_icp_torch.core.cloud import PointCloud
        from kss_icp_torch.measure_resample import simplification_measure

        o, s = (PointCloud.from_points(load_points(f)) for f in (tgt, src))
        m = simplification_measure(o.points, o.mask, s.points, s.mask)
        assert printed == "".join(f"{k}: {float(v):.6g}\n" for k, v in m.items())
        jlines = outs["jax printed"].splitlines()
        assert [ln.split(":")[0] for ln in printed.splitlines()] == [ln.split(":")[0] for ln in jlines]
        assert printed.splitlines()[2] == jlines[2] == "sampling_rate: 0.5"
        return
    assert printed == outs["jax printed"]
    if item == "make-pairs":
        assert printed.splitlines()[0].startswith("t: wlop=300 gird=")
        for f in ("t.gird", "s.gird", "transfer.txt"):
            assert (outs["torch"] / f).read_bytes() == (outs["jax"] / f).read_bytes(), f
        got, want = (load_points(outs[k] / "t.wlop") for k in ("torch", "jax"))
    else:
        got, want = (load_points(f"{outs[k]}.xyz") for k in ("torch", "jax"))
    if item == "wlop" or item == "make-pairs":
        pts = load_points(tgt)
        d = np.linalg.norm(got - want, axis=1) / np.linalg.norm(pts.max(0) - pts.min(0))
        assert got.shape == want.shape and np.median(d) <= 5e-5 and d.max() <= 2e-3
    else:
        np.testing.assert_array_equal(got, want)


def test_help_lists_the_jax_subcommands():
    r = _run(["--help"])
    assert r.returncode == 0
    for name in ("register", "batch", "bench-dir", "largescan", "serve", "measure", "resample", "simplify",
                 "make-pairs", "measure-resample", "view"):
        assert name in r.stdout


def test_device_cuda_without_a_card_exits_nonzero(files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run(["measure", str(files / "tgt.xyz"), str(files / "tgt.xyz")])  # --device defaults to cuda
    assert r.returncode == 1 and "CUDA" in r.stderr and "MSE" not in r.stdout


def test_largescan_and_profile_in_process(files, tmp_path, monkeypatch, capsys):
    """largescan prints run_largescan's dict (here at a tiny config), and
    register --profile writes a torch.profiler trace."""
    import dataclasses

    import kss_icp_torch.largescan as ls

    monkeypatch.setattr(ls, "DEFAULT_CONFIG", dataclasses.replace(
        ls.DEFAULT_CONFIG, rotation_steps=2, max_candidates=2, max_resample_points=128, resample_pad=128,
        max_icp_iterations=8, auto_escalate=False))
    assert cli.main(["largescan", "-n", "4000", "--pre-downsample", "1000", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert {"n_points", "octree_s", "register_s", "metric_s", "total_s", "rmse", "pose_rmse", "metric_tflops",
            "n_s", "n_t"} <= set(out)
    assert out["device"] == "cpu" and out["n_points"] == 4000
    assert cli.main(["register", str(files / "src.xyz"), str(files / "tgt.xyz"), "--device", "cpu",
                     "--no-escalate", "--profile", str(tmp_path / "prof"), *TINY]) == 0
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_register_matches_the_jax_cli(files, capsys):
    from kss_icp_tpu import cli as jcli

    args = ["register", str(files / "src.xyz"), str(files / "tgt.xyz"), *TINY, "--no-escalate", "--precise"]
    assert jcli.main(args + ["--platform", "cpu"]) == 0
    want = capsys.readouterr().out
    assert cli.main(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert [ln.split(":")[0] for ln in got.splitlines()] == [ln.split(":")[0] for ln in want.splitlines()]
    assert _metric(got, "RMSE") <= _metric(want, "RMSE") + RMSE_BAND
