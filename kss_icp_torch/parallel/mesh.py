"""Device meshes on torch.distributed (port of kss_icp_tpu/parallel/mesh.py).

The JAX package is one controller over a Mesh of devices. Here, as is
PyTorch's way, there is one process a device (SPMD: `torchrun
--nproc-per-node N`, or torch.multiprocessing with the spawn start
method). A JAX mesh is a DeviceMesh with named dimensions. A psum over an
axis is an all_reduce on mesh.get_group(name). A shard_map out-spec over an
axis is an all-gather in rank order. Every rank calls an entry point with
the same global inputs and returns the same global result, as JAX's
replicated out_specs do.

The axes:
  - "pairs": the batch of registrations (parallel/batch.py);
  - "rot": the rotation grid of one pair (parallel/rotation_shard.py);
  - "points": the source rows of one pair (parallel/point_shard.py).
"""

from __future__ import annotations

import math
from datetime import timedelta
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def distributed_init(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    timeout: Optional[float] = None,
) -> None:
    """Join the default process group (torch.distributed.init_process_group).

    With no arguments, reads torchrun's environment (init_method "env://").
    The backend is "nccl" where a CUDA device is present and "gloo"
    otherwise, unless named. `timeout` (seconds) bounds every collective, so
    that a rank that never arrives fails the others rather than hanging them.
    A no-op once the group exists, as JAX's distributed_init is."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank,
                            timeout=None if timeout is None else timedelta(seconds=timeout))


def make_mesh(axis_names: Sequence[str] = ("pairs",), shape: Optional[Sequence[int]] = None,
              device_type: str = "cuda"):
    """A DeviceMesh over every rank of the default group, its dimensions
    named `axis_names`. With shape=None, all ranks go to the first axis.
    Axis sizes must multiply to the world size. `device_type` "cuda" puts
    each rank on a card (several ranks may share one); "cpu" runs the plain
    versions, as the tests do."""
    from torch.distributed.device_mesh import init_device_mesh

    distributed_init()
    world = dist.get_world_size()
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {tuple(shape)} != world size {world}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axis_names))


def axis_rank(mesh, name: str) -> tuple[int, int]:
    """(size of the mesh axis `name`, this rank's coordinate on it)."""
    return mesh[name].size(), mesh.get_local_rank(name)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's x concatenated along dim 0 in rank order (a shard_map
    out-spec over the axis). Counts the collective in
    `all_gather_rows.collectives`."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    all_gather_rows.collectives += 1
    return torch.cat(parts)


all_gather_rows.collectives = 0  # collectives issued, a counter for measurement
