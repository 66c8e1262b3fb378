"""The port on the CPU against the JAX package's recorded answers on the 25
remesh fixture pairs (fixtures/torch_port_expected.json, written by
scripts/torch_port_expected.py): per-pair RMSE within the JAX value + 0.006
at DEFAULT_CONFIG and at the bench config, both with escalation off.

About 25 s per pair at DEFAULT_CONFIG on a few CPU threads, so it stays out
of the tier-1 run; chip_smoke.py makes the same check on the card."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import kss_icp_torch as kt
from kss_icp_torch.config import DEFAULT_CONFIG

FIXTURES = Path(__file__).resolve().parents[1] / "fixtures"
EXPECTED = json.loads((FIXTURES / "torch_port_expected.json").read_text())
CONFIGS = {
    "default": (dataclasses.replace(DEFAULT_CONFIG, auto_escalate=False), EXPECTED["pairs"]),
    "bench": (dataclasses.replace(DEFAULT_CONFIG, **EXPECTED["bench_config"]["knobs"]),
              EXPECTED["bench_config"]["pairs"]),
}


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
