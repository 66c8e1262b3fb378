"""The port on the CPU against the JAX package's recorded answers
(scripts/torch_port_expected.py): on the 25 remesh fixture pairs, per-pair
RMSE within the JAX value + 0.006 at DEFAULT_CONFIG and at the bench config
with escalation off (fixtures/torch_port_expected.json) and on
(fixtures/torch_port_expected_escalation.json, overlap_escalate=False, the
"dot" field too); on the category, deform and scale boards, the pass/fail
of every pair by pose error as JAX's, se/7 (the recorded cross-platform
knife edge) excepted; and at the unmodified DEFAULT_CONFIG, the overlap
tier on (fixtures/torch_port_expected_overlap.json), the remesh 25 and the
five boards' 64 pairs, with each pair's overlap rungs run and adopted as
JAX's.

About 25 s per pair at DEFAULT_CONFIG on a few CPU threads, so it stays out
of the tier-1 run; chip_smoke.py makes the same checks on the card."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import kss_icp_torch as kt
from kss_icp_torch.challenge import BOARDS, transform_rmse
from kss_icp_torch.config import DEFAULT_CONFIG

FIXTURES = Path(__file__).resolve().parents[1] / "fixtures"
EXPECTED = json.loads((FIXTURES / "torch_port_expected.json").read_text())
CONFIGS = {
    "default": (dataclasses.replace(DEFAULT_CONFIG, auto_escalate=False), EXPECTED["pairs"]),
    "bench": (dataclasses.replace(DEFAULT_CONFIG, **EXPECTED["bench_config"]["knobs"]),
              EXPECTED["bench_config"]["pairs"]),
}
ESCALATION = json.loads((FIXTURES / "torch_port_expected_escalation.json").read_text())
ESC_CONFIGS = {
    "default": (dataclasses.replace(DEFAULT_CONFIG, overlap_escalate=False), ESCALATION["pairs"]),
    "dot": (dataclasses.replace(DEFAULT_CONFIG, overlap_escalate=False, coarse_method="dot"), ESCALATION["pairs"]),
    "bench": (dataclasses.replace(DEFAULT_CONFIG, **ESCALATION["bench_config"]["knobs"]),
              ESCALATION["bench_config"]["pairs"]),
}
BOARD_PAIRS = [(b, i) for b, _, _ in BOARDS if b in ESCALATION["boards"]
               for i in range(len(ESCALATION["boards"][b]["pairs"]))]
OVERLAP = json.loads((FIXTURES / "torch_port_expected_overlap.json").read_text())
OVERLAP_BOARD_PAIRS = [(b, i) for b, _, _ in BOARDS for i in range(len(OVERLAP["boards"][b]["pairs"]))]


@pytest.mark.slow
@pytest.mark.parametrize("label", sorted(CONFIGS))
@pytest.mark.parametrize("index", range(len(EXPECTED["pairs"])))
def test_remesh_pair_within_jax_band(label, index):
    cfg, pairs = CONFIGS[label]
    exp = pairs[index]
    with np.load(FIXTURES / "remesh_transfer.npz") as z:
        src, tgt = z[exp["name"] + "_src"], z[exp["name"] + "_tgt"]
    res = kt.register_pair(src, tgt, cfg, device="cpu")
    aligned = kt.apply_similarity(res.transform, torch.as_tensor(src))
    rmse = kt.registration_measure(aligned, tgt, device="cpu")["rmse"]
    assert np.isfinite(rmse) and rmse <= exp["rmse"] + EXPECTED["rmse_band"], (rmse, exp["rmse"])


@pytest.mark.slow
@pytest.mark.parametrize("label", sorted(ESC_CONFIGS))
@pytest.mark.parametrize("index", range(len(ESCALATION["pairs"])))
def test_remesh_pair_with_escalation_within_jax_band(label, index):
    cfg, pairs = ESC_CONFIGS[label]
    exp = pairs[index]
    with np.load(FIXTURES / "remesh_transfer.npz") as z:
        src, tgt = z[exp["name"] + "_src"], z[exp["name"] + "_tgt"]
    res = kt.register_pair(src, tgt, cfg, device="cpu")
    aligned = kt.apply_similarity(res.transform, torch.as_tensor(src))
    rmse = kt.registration_measure(aligned, tgt, device="cpu")["rmse"]
    assert np.isfinite(rmse) and rmse <= exp["rmse"] + ESCALATION["rmse_band"], (rmse, exp["rmse"])


@pytest.mark.slow
@pytest.mark.parametrize("board, index", BOARD_PAIRS)
def test_board_pair_passes_as_jax(board, index):
    corpus = dict((b, fn) for b, fn, _ in BOARDS)[board]
    name, src, tgt, gt = corpus()[index]
    exp = ESCALATION["boards"][board]
    assert name == exp["pairs"][index]["name"]
    res = kt.register_pair(src, tgt, ESC_CONFIGS["default"][0], device="cpu")
    pose = transform_rmse(kt.apply_similarity(res.transform, torch.as_tensor(src)).numpy(), src, gt)
    if name != "se/7":
        assert (pose <= exp["threshold"]) == exp["pairs"][index]["passed"], (name, pose)


def _rungs():
    """Records the port's overlap rungs as scripts/torch_port_expected.py
    records JAX's."""
    from kss_icp_torch.ladder_log import RungLog
    from kss_icp_torch.models import kss_icp as tk

    return RungLog(tk, DEFAULT_CONFIG.overlap_adopt_margin)


def _jax_rungs(rec):
    return ["adopted" if r["adopted"] else "ran" if r["ran"] else "skipped" for r in rec["rungs"]]


@pytest.mark.slow
@pytest.mark.parametrize("index", range(len(OVERLAP["pairs"])))
def test_remesh_pair_at_default_config_within_jax_band(index):
    exp = OVERLAP["pairs"][index]
    with np.load(FIXTURES / "remesh_transfer.npz") as z:
        src, tgt = z[exp["name"] + "_src"], z[exp["name"] + "_tgt"]
    with _rungs() as rungs:
        res = kt.register_pair(src, tgt, DEFAULT_CONFIG, device="cpu")
    aligned = kt.apply_similarity(res.transform, torch.as_tensor(src))
    rmse = kt.registration_measure(aligned, tgt, device="cpu")["rmse"]
    assert np.isfinite(rmse) and rmse <= exp["rmse"] + OVERLAP["rmse_band"], (rmse, exp["rmse"])
    assert rungs.outcomes() == _jax_rungs(exp)


@pytest.mark.slow
@pytest.mark.parametrize("board, index", OVERLAP_BOARD_PAIRS)
def test_board_pair_at_default_config_passes_as_jax(board, index):
    corpus = dict((b, fn) for b, fn, _ in BOARDS)[board]
    name, src, tgt, gt = corpus()[index]
    exp = OVERLAP["boards"][board]
    assert name == exp["pairs"][index]["name"]
    with _rungs() as rungs:
        res = kt.register_pair(src, tgt, DEFAULT_CONFIG, device="cpu")
    pose = transform_rmse(kt.apply_similarity(res.transform, torch.as_tensor(src)).numpy(), src, gt)
    if name != "se/7":
        assert (pose <= exp["threshold"]) == exp["pairs"][index]["passed"], (name, pose)
    print(name, "rungs", rungs.outcomes(), "jax", _jax_rungs(exp["pairs"][index]))
