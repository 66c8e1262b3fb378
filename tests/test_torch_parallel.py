"""The device mesh (kss_icp_torch/parallel: mesh.py, rotation_shard.py,
point_shard.py and batch.py's "pairs" axis) against the JAX package and the
port's own unsharded answers on the CPU, at tiny sizes.

The torch side runs in gloo ranks, one process each
(tests/torch_parallel_worker.py, jax-free), spawned once a world size (2 and
4) by a module-scoped fixture; rank 0 writes every case's outputs to an .npz
that many small tests read. The JAX side runs in this process on the 8
virtual CPU devices of tests/conftest.py, as do the port's unsharded calls.

Bars: the sharded field and the pairs axis involve no cross-rank sum, so
they equal the port's unsharded answers bit for bit; point-sharded ICP sums
over ranks in an order of its own, so it is held to JAX's bars of
tests/test_point_shard.py (atol 1e-5, fitness rtol 1e-4, ±1 iteration; see
the test for an exact copy's rounding floor); JAX's field and metric differ
by its expansion-form distances (rtol 2e-5, 1e-5)."""

import dataclasses
import json
import sys

import jax
import numpy as np
import pytest
import torch

import kss_icp_tpu.escalate as je
import torch_parallel_worker as w
from helpers import random_cloud
from kss_icp_torch import escalate as te
from kss_icp_torch.ladder_log import LadderLog
from kss_icp_torch.metrics import registration_measure_padded
from kss_icp_torch.models.coarse import score_rotation_field
from kss_icp_torch.parallel import batch as tb
from kss_icp_tpu.config import KSSICPConfig as JConfig
from kss_icp_tpu.models.icp import ICPParams as JParams
from kss_icp_tpu.parallel import batch as jb
from kss_icp_tpu.parallel.mesh import make_mesh as jax_mesh
from kss_icp_tpu.parallel.point_shard import icp_point_sharded as jax_icp_sharded
from kss_icp_tpu.parallel.point_shard import mean_nn_distance_sharded as jax_metric_sharded
from kss_icp_tpu.parallel.rotation_shard import score_rotation_field_sharded as jax_field_sharded

torch.set_num_threads(1)
ti = sys.modules["kss_icp_torch.models.icp"]
RMSE_BAND = 0.006
ICP_FIELDS = ("rotation", "translation", "fitness", "iterations", "converged", "scale")


def _jcfg(cfg) -> JConfig:
    return JConfig(**dataclasses.asdict(cfg))


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


@pytest.fixture(scope="module", params=(2, 4), ids=("world2", "world4"))
def ranks(request, tmp_path_factory):
    """(world size, rank 0's outputs) of one spawn of the worker's ranks."""
    return request.param, w.spawn(request.param, tmp_path_factory.mktemp(f"world{request.param}"))


@pytest.fixture(scope="module")
def jax_side():
    """JAX's sharded answers on its 8 virtual CPU devices."""
    assert jax.device_count() >= 8
    out = {"field": np.asarray(jax_field_sharded(*w.field_clouds(), steps=w.FIELD_STEPS, mesh=jax_mesh(("rot",))))}
    points = jax_mesh(("points",))
    for label, (n, valid, iterations, noise) in w.ICP_CASES.items():
        res = jax_icp_sharded(*w.point_pair(n, valid, noise),
                              JParams.from_config(JConfig(max_icp_iterations=iterations)), mesh=points)
        out[label] = {f: np.asarray(getattr(res, f)) for f in ICP_FIELDS}
    out["metric"] = float(jax_metric_sharded(*w.metric_clouds(), mesh=points))
    for label, (pairs, cfg, kw) in w.many_settings().items():
        with LadderLog(je, len(pairs)) as ladder:
            _, metrics = jb.register_many(pairs, _jcfg(cfg), mesh=jax_mesh(("pairs",)), **kw)
        out[label] = np.asarray(metrics["rmse"]), w.ladder_rows(ladder)
    return out


@pytest.fixture(scope="module")
def unsharded():
    """The port's answers without a mesh, in this process."""
    out = {"field": score_rotation_field(*_t(*w.field_clouds()), steps=w.FIELD_STEPS).numpy()}
    for label, (n, valid, iterations, noise) in w.ICP_CASES.items():
        src, smask, tgt, tmask = _t(*w.point_pair(n, valid, noise))
        res = ti.icp(src[None], smask[None], tgt, tmask, w.icp_params(iterations))
        out[label] = {f: getattr(res, f)[0].numpy() for f in ICP_FIELDS}
    out["metric"] = float(registration_measure_padded(*_t(*w.metric_clouds()))["mae"])
    out.update(w.flat(tb.register_batch(*w.batch_clouds(), w.BATCH), "batch"))
    clouds = w.resampled(w.partial_pairs(), w.LADDER)
    for solver in ("field", "screen"):
        out.update(w.flat(tb.overlap_batch(*clouds, w.identity(3), w.LADDER.overlap_config(), solver=solver),
                          f"overlap/{solver}"))
    for label, (pairs, cfg, kw) in w.many_settings().items():
        with LadderLog(te, len(pairs)) as ladder:
            res, metrics = tb.register_many(pairs, cfg, device="cpu", **kw)
        out.update(w.flat(res, f"many/{label}/res"))
        out.update(w.flat(metrics, f"many/{label}/metrics"))
        out[f"ladder/{label}"] = w.ladder_rows(ladder)
    return out


def _leaves(outputs: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in outputs.items() if k.startswith(prefix)}


def _same_bits(got: dict, want: dict) -> None:
    assert got.keys() == want.keys() and got
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k], equal_nan=True), k


# --- mesh.py ---

def test_make_mesh_refuses_a_shape_off_the_world_size(ranks):
    world, out = ranks
    assert str(out["mesh_shape_error"]) == f"mesh shape ({world + 1},) != world size {world}"


def test_distributed_init_is_a_no_op_once_the_group_exists(ranks):
    """A second distributed_init, with another store and world size, leaves
    the group as it was."""
    world, out = ranks
    assert int(out["world_after_init"]) == world


# --- rotation_shard.py ---

@pytest.mark.parametrize("label", ["1d", "2d"])
def test_sharded_field_equals_the_unsharded_field_and_jax(ranks, jax_side, unsharded, label):
    """Over a "rot" mesh of every rank (1d) and over the "rot" axis of a
    ("pairs", "rot") mesh (2d): the unsharded field's bits, and JAX's
    sharded field within rtol 2e-5."""
    _, out = ranks
    got = out[f"field/{label}"]
    assert got.shape == (w.FIELD_STEPS,) * 3
    assert np.array_equal(got, unsharded["field"])
    np.testing.assert_allclose(got, jax_side["field"], rtol=2e-5)


def test_sharded_field_refuses_a_grid_off_the_axis(ranks):
    world, out = ranks
    assert str(out["field_error"]) == f"steps^3=27 not divisible by {world} shards"


# --- point_shard.py ---

@pytest.mark.parametrize("label", sorted(w.ICP_CASES))
@pytest.mark.parametrize("reference", ["jax", "unsharded"])
def test_point_sharded_icp_matches_jax_and_the_unsharded_icp(ranks, jax_side, unsharded, label, reference):
    """tests/test_point_shard.py's exact copies, all rows valid (full) and a
    padded tail (tail), and a noisy copy (noisy): JAX's bars against JAX's
    icp_point_sharded and against the port's unsharded lane ICP.

    An exact copy converges into rounding noise: JAX's fitness sits at its
    expansion-form floor (~2e-8) where the port's exact differences read
    ~1e-12, so there the port's fitness is held under JAX's; and the
    relative-MSE gate then stops on noise (JAX's own icp_point_sharded takes
    38 iterations at 2 shards where its unsharded icp takes 33), so the
    iteration count is held against the unsharded ICP only on the noisy
    copy, which converges above the floor."""
    _, out = ranks
    got = _leaves(out, f"icp/{label}/")
    want = (jax_side if reference == "jax" else unsharded)[label]
    exact = not w.ICP_CASES[label][3]
    for f in ("rotation", "translation"):
        np.testing.assert_allclose(got[f], want[f], atol=1e-5)
    if exact and reference == "jax":
        assert float(got["fitness"]) <= float(want["fitness"])
    else:
        np.testing.assert_allclose(float(got["fitness"]), float(want["fitness"]), rtol=1e-4, atol=1e-9)
    if not (exact and reference == "unsharded"):
        # The all-reduce's order can flip the convergence test by one iteration.
        assert abs(int(got["iterations"]) - int(want["iterations"])) <= 1
    assert float(got["fitness"]) < (1e-4 if not exact else 1e-6) and bool(got["converged"])
    assert float(got["scale"]) == 1.0


@pytest.mark.parametrize("reference", ["jax", "unsharded"])
def test_sharded_metric_matches_jax_and_the_unsharded_metric(ranks, jax_side, unsharded, reference):
    _, out = ranks
    np.testing.assert_allclose(float(out["metric"]), jax_side["metric"] if reference == "jax"
                               else unsharded["metric"], rtol=1e-5)


def test_sharded_metric_refuses_rows_off_the_axis(ranks):
    world, out = ranks
    assert str(out["metric_error"]) == f"Q=511 not divisible by {world} shards"


def test_trimmed_icp_refuses_a_group(ranks):
    _, out = ranks
    assert "per-shard quantiles are not global quantiles" in str(out["trim_error"])


# --- batch.py: the pairs axis ---

@pytest.mark.parametrize("label", ["1d", "2d"])
def test_register_batch_over_pairs_equals_the_unsharded_batch(ranks, unsharded, label):
    """3 pairs (dividing neither axis size: the last pair repeated, the pads
    dropped) over a "pairs" mesh, and over the "pairs" axis of a ("pairs",
    "rot") mesh: every field of the result, bit for bit."""
    _, out = ranks
    _same_bits(_leaves(out, f"batch/{label}/"), _leaves(unsharded, "batch/"))


@pytest.mark.parametrize("solver", ["field", "screen"])
def test_overlap_batch_over_pairs_equals_the_unsharded_batch(ranks, unsharded, solver):
    _, out = ranks
    _same_bits(_leaves(out, f"overlap/{solver}/"), _leaves(unsharded, f"overlap/{solver}/"))


@pytest.mark.parametrize("label", ["variable sizes", "forced ladder"])
def test_register_many_over_pairs_equals_the_unsharded_port_and_jax(ranks, jax_side, unsharded, label):
    """register_many over a "pairs" mesh: the port's unsharded rows and
    ladder bit for bit; each pair's RMSE within JAX's register_many over its
    8-device "pairs" mesh + 0.006, with JAX's escalated set. "forced ladder"
    (__graft_entry__.py:140-146) escalates every pair and runs every overlap
    rung, over 3 pairs."""
    _, out = ranks
    got = _leaves(out, f"many/{label}/")
    _same_bits(got, _leaves(unsharded, f"many/{label}/"))
    ladder = json.loads(str(out["ladders"]))[label]
    want = unsharded[f"ladder/{label}"]
    assert ladder["rungs"] == [[list(r) for r in rows] for rows in want["rungs"]]
    assert {k: ladder[k] for k in ("escalated", "won", "finisher")} == {
        k: want[k] for k in ("escalated", "won", "finisher")}
    jax_rmse, jax_ladder = jax_side[label]
    assert (got["metrics/rmse"] <= jax_rmse + RMSE_BAND).all(), (got["metrics/rmse"], jax_rmse)
    assert ladder["escalated"] == jax_ladder["escalated"]
    if label == "forced ladder":
        assert all(ladder["escalated"]) and all(r[1] for rows in ladder["rungs"] for r in rows)


MANY_LABELS = ["variable sizes", "forced ladder"]


@pytest.mark.parametrize("label", MANY_LABELS)
def test_register_many_over_pairs_opens_one_slice_and_one_gather_span_a_rank_under_a_profiler(ranks, label):
    """Under a profiler each rank's register_many over the "pairs" mesh opens
    "kss.mesh.slice" (its own pairs, ladder included) once and
    "kss.mesh.gather" once."""
    world, out = ranks
    rows = json.loads(str(out["mesh_spans"]))[label]
    assert [(r["slice"], r["gather"]) for r in rows] == [(1, 1)] * world


@pytest.mark.parametrize("label", MANY_LABELS)
def test_register_many_over_pairs_hands_the_timer_its_slice_once(ranks, label):
    """With a timer, each rank's register_many over the "pairs" mesh enters
    timer("mesh.slice") once, around the stages of its own slice."""
    world, out = ranks
    timed = [r["timed"] for r in json.loads(str(out["mesh_spans"]))[label]]
    assert all(n == 1 and stages > 1 for n, stages in timed), timed


@pytest.mark.parametrize("label", MANY_LABELS)
def test_all_gather_rows_counts_a_collective_a_gathered_leaf(ranks, label):
    """all_gather_rows.collectives grows by one a tensor leaf of the result
    and of the metrics on every rank."""
    _, out = ranks
    rows = json.loads(str(out["mesh_spans"]))[label]
    assert all(r["collectives"] == r["leaves"] > 0 for r in rows), rows


@pytest.mark.parametrize("label", MANY_LABELS)
def test_register_many_over_pairs_opens_no_span_without_a_profiler(ranks, label):
    _, out = ranks
    assert [r["unprofiled"] for r in json.loads(str(out["mesh_spans"]))[label]] == [0] * ranks[0]


@pytest.mark.parametrize("label", MANY_LABELS)
def test_register_many_over_pairs_keeps_its_bits_under_a_profiler(ranks, label):
    _, out = ranks
    _same_bits(_leaves(out, f"many_profiled/{label}/"), _leaves(out, f"many/{label}/"))


# --- models/icp.py without a group ---

def _icp_cases() -> dict:
    """The port's icp, kabsch and point_to_plane_step on seeded inputs, each
    knob that changes their arithmetic once: {name: numpy outputs}."""
    rng = np.random.default_rng(11)
    tgt = np.stack([random_cloud(rng, 128) for _ in range(2)]).astype(np.float32)
    src = (tgt[[0, 1, 1], :96] @ np.diag([1.0, -1.0, -1.0]).T * 1.05 + 0.03
           + rng.normal(0, 0.01, (3, 96, 3))).astype(np.float32)
    normals = rng.normal(size=(2, 128, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    weights = (rng.uniform(size=(3, 96)) < 0.8).astype(np.float32)
    src, tgt, normals, weights = _t(src, tgt, normals, weights)
    smask = torch.as_tensor(np.arange(96) < 90)
    tmask = torch.as_tensor(np.arange(128) < 120).expand(2, 128).contiguous()
    lane_ref = torch.tensor([0, 1, 1], dtype=torch.int32)
    params = ti.ICPParams.from_config(w.KSSICPConfig(max_icp_iterations=25))
    runs = {
        "icp": ti.icp(src, smask, tgt, tmask, params, lane_ref=lane_ref),
        "icp_trim_scale": ti.icp(src, smask, tgt, tmask, params, lane_ref=lane_ref, trim_fraction=0.7,
                                 estimate_scale=True),
        "icp_point_to_plane": ti.icp(src, smask, tgt, tmask, params, lane_ref=lane_ref, variant="point_to_plane",
                                     target_normals=normals),
        "kabsch": ti.kabsch(src, tgt[[0, 1, 1], :96], weights),
        "kabsch_scale": ti.kabsch(src, tgt[[0, 1, 1], :96], weights, estimate_scale=True),
        "point_to_plane_step": ti.point_to_plane_step(src, tgt[[0, 1, 1], :96], normals[[0, 1, 1], :96], weights),
    }
    return {name: w.flat(tuple(res), name) for name, res in runs.items()}


ICP_BEFORE = w.REPO / "fixtures" / "torch_icp_before_group.npz"


@pytest.mark.parametrize("case", ["icp", "icp_trim_scale", "icp_point_to_plane", "kabsch", "kabsch_scale",
                                  "point_to_plane_step"])
def test_group_none_leaves_icp_bits_as_they_were(case):
    """Without a group, icp, kabsch and point_to_plane_step give the bits
    they gave before the group parameter: fixtures/torch_icp_before_group.npz,
    `_icp_cases` run on the tree before it (torch 2.13.0 on the CPU, one
    thread)."""
    with np.load(ICP_BEFORE) as z:
        want = {k: z[k] for k in z.files if k.startswith(case + "/")}
    _same_bits(_icp_cases()[case], want)
