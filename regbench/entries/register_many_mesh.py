"""Entry: `kss_icp_torch.parallel.batch.register_many` over a "pairs" mesh of
the configuration's `mesh["ranks"]` ranks, one process a card, as a sweep on
one node runs it: every rank calls register_many with the same global list
of pairs, registers its contiguous slice (its own escalation ladder
included) and all-gathers the result, so every rank returns the whole batch.

This process is rank 0, on the harness's device. `prepare` spawns ranks
1..W-1 (the spawn start method), rank r on cuda:r (on the CPU, which the
tests use, every rank on the CPU over gloo), and they meet it through a
FileStore in a temporary directory (`distributed_init`, `make_mesh`). Each
rank builds the mix's pool of pairs itself: the pool fixes every pair and
the seed only deals their order, so a call hands each rank only its pairs'
keys (a pair's name and ground truth, which with the source's code fix its
clouds); a pair the pool does not hold (the check's fresh pairs) goes
whole. After each call every rank answers with a digest of the batch it
returned, which must be rank 0's, and the host seconds of its own slice
(`timer("mesh.slice")`): rank 0 keeps in `WAITS`, for each call after the
warm-up, the slowest rank's slice seconds less the ranks' mean.

On a card every rank, this process included, is bound to its own quarter
of the process's CPUs and runs as many host threads as its quarter has
CPUs: four host-bound ranks would otherwise share and trade cores from run
to run.

A rank that raises, dies, or keeps its answer waiting longer than the
mesh's `deadline_s` fails the call; the ranks are then stopped and every
later call fails at once. Over NCCL a rank that fails before the gather
leaves the others waiting in its collective: PyTorch's watchdog ends them
at that deadline and, by default, their processes too, this one included,
so the run ends without a result. The ranks stop and the group
is destroyed when the call is dropped, or at the latest when the process
exits.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import multiprocessing
import multiprocessing.connection
import os
import shutil
import tempfile
import time
import traceback
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np

from regbench import generate
from regbench.entries import Answer, stage
from regbench.harness import forbidden_modules
from regbench.entries.register_many import metric_rows  # noqa: F401  (the same metric rows)

STOP_S = 30.0  # how long the ranks get to leave the group once told to stop
WAITS: List[float] = []  # a call's slowest slice less the ranks' mean, in seconds, a call after the warm-up


def pair_key(pair) -> tuple:
    """A pair's name and the bytes of its ground truth: with the source's code
    they fix the pair's clouds."""
    return (pair.name,) + tuple((k, np.asarray(v).tobytes()) for k, v in sorted(pair.truth.items()))


def pool_of(config, mix) -> Dict[tuple, Tuple[np.ndarray, np.ndarray]]:
    """{key: (source, target)} of every pair the mix's pool fixes; empty for
    a mix without a pool."""
    if "pool" not in mix:
        return {}
    return {pair_key(p): (p.src, p.tgt) for c in generate.make_calls(config, mix, 0) for p in c}


def handoff(pairs, pool_keys) -> Tuple[List[Optional[tuple]], Dict[int, Tuple[np.ndarray, np.ndarray]]]:
    """What a call hands ranks 1..W-1: each pair's key where the pool holds
    it (None where it does not), and {index: (source, target)} of the pairs
    it does not hold."""
    keys = [pair_key(p) for p in pairs]
    whole = {i: (p.src, p.tgt) for i, (p, k) in enumerate(zip(pairs, keys)) if k not in pool_keys}
    return [None if i in whole else k for i, k in enumerate(keys)], whole


def received(keys, whole, pool) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The clouds of a call handed off as `handoff` makes it: [(source,
    target)], in the call's order."""
    return [whole[i] if k is None else pool[k] for i, k in enumerate(keys)]


def _answers(res, metrics, n: int) -> Tuple[List[Answer], str]:
    """The batch's answers on the host, and a digest of what they are made
    of."""
    tr = res.transform
    parts = [x.cpu().numpy() for x in (tr.scale, tr.rotation, tr.translation)] + \
        [np.asarray(metrics[k]) for k in ("rmse", "mae")]
    digest = hashlib.sha256(b"".join(np.ascontiguousarray(x).tobytes() for x in parts)).hexdigest()
    scale, rot, trans, rmse, mae = parts
    return [Answer(float(scale[b]), rot[b], trans[b], float(rmse[b]), float(mae[b])) for b in range(n)], digest


def _kss_config(config):
    from kss_icp_torch.config import KSSICPConfig

    return dataclasses.replace(KSSICPConfig(), **config["kss_config"])


def core_sets(world: int) -> Optional[List[List[int]]]:
    """Disjoint equal shares of this process's CPUs, contiguous, one a rank;
    None where there are fewer CPUs than ranks. (The four-H100 nodes the
    cell was measured on show no NUMA node and no hyperthread siblings, so
    a deal by topology gives the same shares there; PERF.md.)"""
    cpus = sorted(os.sched_getaffinity(0))
    per = len(cpus) // world
    return [cpus[r * per:(r + 1) * per] for r in range(world)] if per else None


def pin(cpus) -> None:
    """Bind every thread of this process to `cpus`."""
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cpus)
        except OSError:  # a thread that ended meanwhile
            pass


class SliceClock:
    """The timer a rank hands register_many: the host seconds of its own
    slice ("mesh.slice"), every stage also handed to `inner` (the
    benchmark's timer, on rank 0), where there is one."""

    def __init__(self, inner=None):
        self.inner, self.seconds = inner, None

    @contextlib.contextmanager
    def _slice(self):
        with stage(self.inner, "mesh.slice"):
            t0 = time.perf_counter()
            yield
            self.seconds = time.perf_counter() - t0

    def __call__(self, name: str):
        return self._slice() if name == "mesh.slice" else stage(self.inner, name)


def _rank(rank: int, world: int, store: str, backend: str, device: str, config, mix, conn, parent: int,
          cpus: Optional[List[int]], threads: int) -> None:
    """Rank `rank` (1..W-1), in a process of its own, bound to `cpus` where
    given: builds the pool, joins the group, then runs each call rank 0
    hands it until told to stop or until rank 0's process is gone. Every
    message goes back on `conn`: ("ready", rank, the pool's keys), ("done",
    call, (digest, forbidden modules loaded, the slice's host seconds)) or
    ("error", rank, traceback)."""
    if cpus:
        pin(cpus)
    import torch
    import torch.distributed as dist

    try:
        from kss_icp_torch.parallel import batch, distributed_init, make_mesh

        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        torch.set_num_threads(threads)
        pool = pool_of(config, mix)
        conn.send(("ready", rank, list(pool)))
        distributed_init(f"file://{store}", world, rank, backend, timeout=config["mesh"]["deadline_s"])
        mesh = make_mesh(("pairs",), device_type=dev.type)
        cfg = _kss_config(config)
        while True:
            if not conn.poll(1.0):
                if os.getppid() != parent:
                    return
                continue
            msg = conn.recv()
            if msg[0] == "stop":
                return
            _, n, keys, whole = msg
            clock = SliceClock()
            res, metrics = batch.register_many(received(keys, whole, pool), cfg, mesh=mesh,
                                               full_pad=config["full_pad"], device=dev, timer=clock)
            conn.send(("done", n, (_answers(res, metrics, len(keys))[1], forbidden_modules(), clock.seconds)))
    except EOFError:  # rank 0's end of the pipe closed: its process is gone
        return
    except BaseException:
        try:
            conn.send(("error", rank, traceback.format_exc()))
        except OSError:
            pass
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class _Ranks:
    """What stopping the mesh needs, apart from the call that owns it: the
    ranks' processes and pipes, the FileStore's directory and this
    process's thread count and CPUs before the mesh."""

    def __init__(self, threads: int):
        self.procs: List = []
        self.conns: List = []
        self.tmp = tempfile.mkdtemp(prefix="regbench-mesh-")
        self.threads, self.cpus = threads, os.sched_getaffinity(0)


def _shutdown(ranks: _Ranks) -> None:
    """Tell every rank to stop, leave the group, and end the ranks that have
    not left within STOP_S."""
    import torch
    import torch.distributed as dist

    for c in ranks.conns:
        try:
            c.send(("stop",))
        except OSError:
            pass
    if dist.is_initialized():
        dist.destroy_process_group()
    end = time.monotonic() + STOP_S
    for p in ranks.procs:
        p.join(timeout=max(0.0, end - time.monotonic()))
    for p in ranks.procs:
        if p.is_alive():
            p.kill()
            p.join()
    for c in ranks.conns:
        c.close()
    torch.set_num_threads(ranks.threads)
    pin(ranks.cpus)
    shutil.rmtree(ranks.tmp, ignore_errors=True)


class MeshCall:
    """The cell's call on rank 0: (pairs, timer) -> [Answer]. `digests` holds
    each rank's digest of the last call's batch; `seconds` the host seconds
    of every call so far in handing the call to the ranks ("handoff") and in
    waiting for their digests once rank 0's own register_many returned
    ("digests"); `cpus` each rank's CPUs (None where no rank is bound)."""

    def __init__(self, config, mix, device):
        import torch

        from kss_icp_torch.parallel import distributed_init, make_mesh

        self.device = torch.device(device)
        self.world, self.deadline = config["mesh"]["ranks"], config["mesh"]["deadline_s"]
        self.full_pad, self.cfg = config["full_pad"], _kss_config(config)
        backend = config["mesh"]["backend"] if self.device.type == "cuda" else "gloo"
        devices = [f"cuda:{r}" if self.device.type == "cuda" else "cpu" for r in range(self.world)]
        self.calls, self.failed, self.digests = 0, None, {}
        self.warm_calls = mix["warm_calls"]
        self.seconds = {"handoff": 0.0, "digests": 0.0}
        WAITS.clear()
        self.ranks = _Ranks(torch.get_num_threads())
        self._stop = weakref.finalize(self, _shutdown, self.ranks)
        # Unbound, one thread a rank on the CPU, where the tests run every rank on the same few cores.
        self.cpus = core_sets(self.world) if self.device.type == "cuda" else None
        threads = len(self.cpus[0]) if self.cpus else 1
        store = os.path.join(self.ranks.tmp, "store")
        ctx = multiprocessing.get_context("spawn")
        for r in range(1, self.world):
            here, there = ctx.Pipe()
            p = ctx.Process(target=_rank, args=(r, self.world, store, backend, devices[r], config, mix, there,
                                                os.getpid(), self.cpus and self.cpus[r], threads),
                            daemon=True)
            p.start()
            there.close()
            self.ranks.procs.append(p)
            self.ranks.conns.append(here)
        if self.cpus:
            pin(self.cpus[0])
        torch.set_num_threads(threads)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        try:
            ready = self._answers_of("ready")
            self.pool_keys = set(ready[1]) if ready else set()
            distributed_init(f"file://{store}", self.world, 0, backend, timeout=self.deadline)
            self.mesh = make_mesh(("pairs",), device_type=self.device.type)
        except BaseException:
            self._stop()
            raise

    def __call__(self, pairs, timer):
        from kss_icp_torch.parallel import batch

        if self.failed:
            raise RuntimeError(f"the mesh failed on an earlier call: {self.failed}")
        self.calls += 1
        try:
            t0 = time.perf_counter()
            keys, whole = handoff(pairs, self.pool_keys)
            for c in self.ranks.conns:
                c.send(("call", self.calls, keys, whole))
            self.seconds["handoff"] += time.perf_counter() - t0
            clock = SliceClock(timer)
            res, metrics = batch.register_many([(p.src, p.tgt) for p in pairs], self.cfg, mesh=self.mesh,
                                               full_pad=self.full_pad, device=self.device, timer=clock)
            answers, digest = _answers(res, metrics, len(pairs))
            self.digests, slices = {0: digest}, [clock.seconds]
            t0 = time.perf_counter()
            done = self._answers_of("done")
            self.seconds["digests"] += time.perf_counter() - t0
            for r, (theirs, loaded, slice_s) in done.items():
                if loaded:
                    raise RuntimeError(f"rank {r} loaded {loaded}")
                self.digests[r] = theirs
                slices.append(slice_s)
                if theirs != digest:
                    raise RuntimeError(f"rank {r} returned another batch than rank 0")
            if self.calls > self.warm_calls and None not in slices:  # a program that times its slice
                WAITS.append(max(slices) - sum(slices) / len(slices))
        except Exception as e:
            self.failed = f"call {self.calls}: {e}" + "".join(self._errors())
            self._stop()
            raise RuntimeError(self.failed) from e
        return answers

    def _answers_of(self, kind: str) -> Dict[int, object]:
        """{rank: the payload of its `kind` message} from ranks 1..W-1, each
        within the deadline; raises where a rank reports an error, ends or
        keeps its message past the deadline."""
        end = time.monotonic() + self.deadline
        pending = {c: r for r, c in enumerate(self.ranks.conns, 1)}
        got = {}
        while pending:
            for c in multiprocessing.connection.wait(list(pending), timeout=1.0):
                r = pending.pop(c)
                try:
                    msg = c.recv()
                except EOFError:
                    raise RuntimeError(f"rank {r} ended (exit code {self.ranks.procs[r - 1].exitcode})") from None
                if msg[0] == "error":
                    raise RuntimeError(f"rank {r} failed:\n{msg[2]}")
                if msg[0] != kind or (kind == "done" and msg[1] != self.calls):
                    raise RuntimeError(f"rank {r} answered {msg[:2]}, not {kind} of call {self.calls}")
                got[r] = msg[2]
            dead = [r for r in pending.values() if not self.ranks.procs[r - 1].is_alive()]
            if dead:
                raise RuntimeError(f"rank(s) {dead} ended (exit codes "
                                   f"{[self.ranks.procs[r - 1].exitcode for r in dead]})")
            if pending and time.monotonic() > end:
                raise TimeoutError(f"rank(s) {sorted(pending.values())} gave no {kind} within {self.deadline} s")
        return got

    def _errors(self, wait: float = 2.0) -> List[str]:
        """The errors the ranks reported within `wait` seconds."""
        out, end = [], time.monotonic() + wait
        for r, c in enumerate(self.ranks.conns, 1):
            try:
                while c.poll(max(0.0, end - time.monotonic())):
                    msg = c.recv()
                    if msg[0] == "error":
                        out.append(f"\nrank {r} failed:\n{msg[2]}")
                        break
            except (EOFError, OSError):
                continue
        return out


def prepare(config, mix, device):
    """The call (pairs, timer) -> [Answer] at the configuration's settings,
    its ranks started and joined to the group."""
    return MeshCall(config, mix, device)
