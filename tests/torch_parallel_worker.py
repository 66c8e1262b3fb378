"""The port's side of the mesh tests: one process a rank, jax-free.

    python tests/torch_parallel_worker.py RANK WORLD STORE OUT CASES BACKEND

Each rank joins a group of WORLD ranks (BACKEND gloo, or nccl on a card)
through the FileStore file STORE (no ports, so parallel test workers cannot
collide), runs each of the comma-separated CASES on meshes made by
kss_icp_torch.parallel.make_mesh (on the CPU; the "card" case on cuda:0),
on the inputs below (made from seeds with numpy), and rank 0 writes each
case's outputs to OUT (.npz). tests/test_torch_parallel.py imports this
module for the same inputs and configs, runs JAX on them and the port
without a mesh, and compares; tests/test_torch_batch.py and
tests/test_torch_card.py spawn it too (`spawn`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[:0] = [str(REPO), str(REPO / "tests")]

import torch  # noqa: E402

from helpers import random_cloud  # noqa: E402
from kss_icp_torch import escalate as te  # noqa: E402
from kss_icp_torch.challenge import partial_corpus  # noqa: E402
from kss_icp_torch.config import KSSICPConfig  # noqa: E402
from kss_icp_torch.core.transforms import Similarity  # noqa: E402
from kss_icp_torch.ladder_log import LadderLog  # noqa: E402
from kss_icp_torch.models import kss_icp as tk  # noqa: E402
from kss_icp_torch.models.icp import ICPParams, icp  # noqa: E402

FIELD_STEPS = 4  # 64 rotations: divides 2, 4 and JAX's 8 devices
# tests/test_register_many.py:13-16, and tests/test_torch_batch.py's tiny modes.
MANY = KSSICPConfig(rotation_steps=8, max_candidates=8, max_resample_points=256, resample_pad=256,
                    max_icp_iterations=100, rotation_chunk=64, screen_points=128)
BATCH = KSSICPConfig(rotation_steps=4, max_candidates=4, max_resample_points=128, resample_pad=128,
                     max_icp_iterations=8, rotation_chunk=16, auto_escalate=False, screen_points=64,
                     refine_candidates=2)
LADDER = KSSICPConfig(rotation_steps=4, max_candidates=4, max_resample_points=160, resample_pad=192,
                      max_icp_iterations=12, rotation_chunk=16, screen_points=64, refine_candidates=2,
                      escalate_rotation_steps=5, escalate_max_candidates=5, escalate_coarse_points=64,
                      escalate_coarse_target_points=64, overlap_screen_steps=4, overlap_screen_iters=4,
                      overlap_iterations=2, overlap_adopt_margin=0.8)
# __graft_entry__.py:140-146: every pair escalated and offered every overlap rung.
FORCED = dataclasses.replace(LADDER, escalate_threshold=0.0, overlap_threshold=0.0, overlap_gate_ratio=100.0)
PARTIAL = (0, 2, 7)
# rows, valid rows, iterations, source noise: tests/test_point_shard.py's exact copies, then a noisy copy,
# whose ICP converges above the rounding floor.
ICP_CASES = {"full": (512, 512, 60, 0.0), "tail": (256, 200, 40, 0.0), "noisy": (512, 512, 60, 0.005)}
NAMES = ("Angelg", "Buddhag", "Catg")  # 3 pairs: B divides neither 2 nor 4


def point_pair(n: int, valid: int, noise: float = 0.0):
    """tests/test_point_shard.py::_pair on a fresh default_rng(0), the first
    `valid` source rows valid, the source moved by gaussian `noise`."""
    tgt = random_cloud(np.random.default_rng(0), n).astype(np.float32)
    c, s = np.cos(0.35), np.sin(0.35)
    r = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    src = tgt @ r.T + np.array([0.05, -0.02, 0.01], np.float32)
    if noise:
        src = (src + np.random.default_rng(5).normal(0, noise, src.shape)).astype(np.float32)
    return src, np.arange(n) < valid, tgt, np.ones((n,), bool)


def metric_clouds():
    """tests/test_point_shard.py::test_sharded_mean_nn_distance's clouds."""
    rng = np.random.default_rng(0)
    q = random_cloud(rng, 512).astype(np.float32)
    r = random_cloud(rng, 300).astype(np.float32)
    return q, np.arange(512) < 480, r, np.ones((300,), bool)


def field_clouds():
    """A pair with suffix-masked tails on both clouds."""
    rng = np.random.default_rng(3)
    src = random_cloud(rng, 128).astype(np.float32)
    tgt = (src[::-1] @ np.diag([1.0, -1.0, -1.0]).astype(np.float32).T * 1.1
           + rng.normal(0, 0.01, (128, 3))).astype(np.float32)
    return src, np.arange(128) < 100, tgt, np.arange(128) < 118


def icp_params(iterations: int) -> ICPParams:
    return ICPParams.from_config(KSSICPConfig(max_icp_iterations=iterations))


def resampled(pairs, cfg):
    """[(source, target)] FPS-resampled by the port, stacked (source points,
    mask, target points, mask)."""
    s = [torch.as_tensor(np.asarray(a, np.float32)) for a, _ in pairs]
    t = [torch.as_tensor(np.asarray(b, np.float32)) for _, b in pairs]
    n = max(len(x) for x in s + t)

    def pad(xs):
        pts = torch.zeros((len(xs), n, 3))
        mask = torch.zeros((len(xs), n), dtype=torch.bool)
        for i, x in enumerate(xs):
            pts[i, :len(x)], mask[i, :len(x)] = x, True
        return pts, mask

    counts = torch.tensor([cfg.resample_count(len(a), len(b)) for a, b in zip(s, t)])
    (sp, sm), (tp, tm) = tk.resample_pairs(*pad(s), *pad(t), counts, cfg)
    return sp, sm, tp, tm


def batch_clouds():
    with np.load(REPO / "fixtures" / "remesh_transfer.npz") as z:
        return resampled([(z[n + "_src"], z[n + "_tgt"]) for n in NAMES], BATCH)


def partial_pairs():
    return [(s, t) for i, (_, s, t, _) in enumerate(partial_corpus(n_points=1500)) if i in PARTIAL]


def many_settings():
    """(pairs, cfg, register_many keywords) of each register_many case."""
    rng = np.random.default_rng(0)
    pairs = []
    for i in range(4):  # tests/test_register_many.py:19-27
        tgt = random_cloud(rng, 400 + 50 * i)
        c, s = np.cos(0.3 + 0.2 * i), np.sin(0.3 + 0.2 * i)
        r = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        pairs.append(((tgt @ r.T).astype(np.float32), tgt.astype(np.float32)))
    return {"variable sizes": (pairs, MANY, dict(full_pad=512)),
            "forced ladder": (partial_pairs(), FORCED, dict(full_pad=1536))}


def flat(tree, prefix: str) -> dict:
    """{prefix/field/...: numpy array} of a result tree's leaves."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: v for f in tree._fields for k, v in flat(getattr(tree, f), f"{prefix}/{f}").items()}
    if isinstance(tree, (tuple, list)):
        return {k: v for i, x in enumerate(tree) for k, v in flat(x, f"{prefix}/{i}").items()}
    if isinstance(tree, dict):
        return {k: v for f, x in tree.items() for k, v in flat(x, f"{prefix}/{f}").items()}
    return {prefix: tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)}


def identity(b: int) -> Similarity:
    """b identity transforms: the overlap rungs' incumbents in the batch cases."""
    return Similarity(torch.ones(b), torch.eye(3).expand(b, 3, 3).clone(), torch.zeros(b, 3))


def ladder_rows(ladder: LadderLog) -> dict:
    """A LadderLog's rows as plain lists."""
    return {"escalated": ladder.escalated.tolist(), "won": ladder.won.tolist(), "finisher": ladder.finisher.tolist(),
            "rungs": [[(r["rung"], r["ran"], r["adopted"]) for r in rows] for rows in ladder.rungs]}


def error_of(fn) -> str:
    """The message of the ValueError fn raises ('' if none)."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


CASES = ("mesh", "field", "icp", "batch", "many")
CARD_STEPS, CARD_POINTS = 8, 65536  # the "card" case's grid and metric clouds


def run(rank: int, world: int, store: str, out: str, cases=CASES, backend: str = "gloo") -> None:
    """Rank `rank`'s part of every case in `cases`; rank 0 writes the outputs.
    The "card" case (not in CASES) runs on cuda:0, which the ranks share."""
    import torch.distributed as dist

    from kss_icp_torch.parallel import (distributed_init, icp_point_sharded, make_mesh, mean_nn_distance_sharded,
                                        overlap_batch, register_batch, register_many,
                                        score_rotation_field_sharded)

    torch.set_num_threads(1)
    distributed_init(f"file://{store}", world, rank, backend, timeout=300)
    t = torch.as_tensor
    res = {}
    if {"batch", "many"} & set(cases):
        pairs_mesh = make_mesh(("pairs",), device_type="cpu")
    if {"field", "batch"} & set(cases):
        mesh2d = make_mesh(("pairs", "rot"), (world // 2, 2), "cpu")
    if "icp" in cases:
        points_mesh = make_mesh(("points",), device_type="cpu")
    if "mesh" in cases:
        res["mesh_shape_error"] = error_of(lambda: make_mesh(("pairs",), (world + 1,), "cpu"))
        distributed_init("file:///nonexistent/store", world + 1, 0, "gloo")  # the group exists: a no-op
        res["world_after_init"] = dist.get_world_size()

    if "field" in cases:
        rot_mesh = make_mesh(("rot",), device_type="cpu")
        clouds = [t(x) for x in field_clouds()]
        for label, mesh in (("1d", rot_mesh), ("2d", mesh2d)):
            res[f"field/{label}"] = score_rotation_field_sharded(*clouds, steps=FIELD_STEPS, mesh=mesh).numpy()
        res["field_error"] = error_of(lambda: score_rotation_field_sharded(*clouds, steps=3, mesh=rot_mesh))

    if "icp" in cases:
        for label, (n, valid, iterations, noise) in ICP_CASES.items():
            res.update(flat(icp_point_sharded(*(t(x) for x in point_pair(n, valid, noise)), icp_params(iterations),
                                              mesh=points_mesh), f"icp/{label}"))
        q, qm, r, rm = (t(x) for x in metric_clouds())
        res["metric"] = mean_nn_distance_sharded(q, qm, r, rm, mesh=points_mesh).numpy()
        res["metric_error"] = error_of(lambda: mean_nn_distance_sharded(q[:-1], qm[:-1], r, rm, mesh=points_mesh))
        src, smask, tgt, tmask = (t(x) for x in point_pair(256, 256))
        res["trim_error"] = error_of(lambda: icp(src[None], smask[None], tgt, tmask, icp_params(10),
                                                 trim_fraction=0.7, group=points_mesh.get_group("points")))

    if "batch" in cases:
        clouds = batch_clouds()
        for label, mesh in (("1d", pairs_mesh), ("2d", mesh2d)):
            res.update(flat(register_batch(*clouds, BATCH, mesh=mesh), f"batch/{label}"))
        clouds = resampled(partial_pairs(), LADDER)
        for solver in ("field", "screen"):
            res.update(flat(overlap_batch(*clouds, identity(3), LADDER.overlap_config(), mesh=pairs_mesh,
                                          solver=solver), f"overlap/{solver}"))

    if "many" in cases:
        from torch.profiler import ProfilerActivity, profile

        from kss_icp_torch.parallel.mesh import all_gather_rows
        from kss_icp_torch.utils import profiling

        ladders, spans = {}, {}
        for label, (pairs, cfg, kw) in many_settings().items():
            annotate, opened = profiling.trace_annotation, []
            profiling.trace_annotation = lambda name: opened.append(name) or annotate(name)
            try:
                with LadderLog(te, -(-len(pairs) // world)) as ladder:  # this rank's pairs, padded
                    got, metrics = register_many(pairs, cfg, mesh=pairs_mesh, device="cpu", **kw)
            finally:
                profiling.trace_annotation = annotate
            res.update(flat(got, f"many/{label}/res"))
            res.update(flat(metrics, f"many/{label}/metrics"))
            rows = [None] * world
            dist.all_gather_object(rows, ladder_rows(ladder))
            ladders[label] = {k: [x for r in rows for x in r[k]][:len(pairs)] for k in rows[0]}
            # The same call under a profiler and with a timer: its mesh spans, the stages it
            # hands the timer and its collectives on this rank.
            before, stages = all_gather_rows.collectives, []
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                got, metrics = register_many(pairs, cfg, mesh=pairs_mesh, device="cpu",
                                             timer=lambda name: stages.append(name) or contextlib.nullcontext(), **kw)
            res.update(flat(got, f"many_profiled/{label}/res"))
            res.update(flat(metrics, f"many_profiled/{label}/metrics"))
            names = [e.name for e in prof.events()]
            counts = {"slice": names.count("kss.mesh.slice"), "gather": names.count("kss.mesh.gather"),
                      "collectives": all_gather_rows.collectives - before,
                      "leaves": len(flat(got, "res")) + len(flat(metrics, "metrics")), "unprofiled": len(opened),
                      "timed": [stages.count("mesh.slice"), len(stages)]}
            dist.all_gather_object(rows, counts)
            spans[label] = rows
        res["ladders"] = json.dumps(ladders)
        res["mesh_spans"] = json.dumps(spans)
    if "card" in cases:
        from kss_icp_torch.metrics import registration_measure_padded
        from kss_icp_torch.models.coarse import score_rotation_field
        from kss_icp_torch.ops.coarse_cuda import field_ave
        from kss_icp_torch.ops.nn_cuda import nn1

        rot_mesh, points_mesh = (make_mesh((name,), device_type="cuda") for name in ("rot", "points"))
        clouds = [t(x).cuda() for x in field_clouds()]
        launches = field_ave.launches, nn1.launches
        res["card/field"] = score_rotation_field_sharded(*clouds, steps=CARD_STEPS, mesh=rot_mesh).cpu().numpy()
        rng = np.random.default_rng(7)
        q, r = (t(random_cloud(rng, CARD_POINTS).astype(np.float32)).cuda() for _ in range(2))
        qm, rm = (t(np.arange(CARD_POINTS) < n).cuda() for n in (CARD_POINTS - 1000, CARD_POINTS))
        res["card/metric"] = mean_nn_distance_sharded(q, qm, r, rm, mesh=points_mesh).cpu().numpy()
        res["card/launches"] = np.array([field_ave.launches - launches[0], nn1.launches - launches[1]])
        res["card/field_unsharded"] = score_rotation_field(*clouds, steps=CARD_STEPS).cpu().numpy()
        res["card/metric_unsharded"] = registration_measure_padded(q, qm, r, rm)["mae"].cpu().numpy()
    if rank == 0:
        np.savez(out, **res)
    dist.destroy_process_group()


def spawn(world: int, directory: Path, cases=CASES, backend: str = "gloo", timeout: float = 600) -> dict:
    """Run `world` ranks of this script (one thread each) on `cases` over
    `backend`, with their FileStore and output under `directory`; returns
    rank 0's outputs. Raises with every rank's output if a rank fails or
    outlasts `timeout`."""
    out, logs = directory / "out.npz", []
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), str(r), str(world),
                               str(directory / "store"), str(out), ",".join(cases), backend],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    if any(p.returncode for p in procs):
        raise RuntimeError("a rank failed:\n" + "\n".join(logs))
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


if __name__ == "__main__":
    run(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5].split(","), sys.argv[6])
