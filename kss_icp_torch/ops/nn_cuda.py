"""Wrapper of the `nn1` CUDA kernel (csrc/nn.cu): batched exact-f32 1-NN.

Ports kss_icp_tpu/ops/nn_pallas.py::nearest_neighbor_vpu (K3) and
::nearest_neighbor_pallas (K4), which share one contract. On CPU tensors the
wrapper runs the plain version, ops/nn.py::nearest_neighbor; on CUDA tensors
it launches the kernel or raises.
"""

from __future__ import annotations

import functools
from collections import Counter
from typing import NamedTuple, Optional, Tuple

import torch

from kss_icp_torch.ops import nn as nn_plain

SMS = 132  # streaming multiprocessors of an H100 SXM: the plan's default where no card is asked
MIN_SLICE = 256  # reference rows a cluster block scans at the least
MAX_CLUSTER = 8  # the portable cluster size
THREADS = 128  # threads a block (csrc/nn.cu)
QUERIES = (2, 4)  # queries a thread the kernel is built for
MAX_LANES = 65535  # lanes a launch: the grid's y extent (csrc/nn.cu)


class NN1Plan(NamedTuple):
    cluster: int  # blocks of a cluster, each scanning one slice of R
    slice: int    # reference rows a block scans; cluster * slice >= R
    queries: int  # queries a thread: a block holds THREADS x queries

    @property
    def tile_queries(self) -> int:
        """Queries a block."""
        return THREADS * self.queries


@functools.lru_cache(maxsize=256)  # the ICP loop asks for a few shapes thousands of times
def nn1_plan(lanes: int, q_n: int, r_n: int, sms: int = SMS) -> NN1Plan:
    """The launch plan of `nn1` for L lanes of Q queries against R rows on a
    card of `sms` streaming multiprocessors.

    4 queries a thread where the launch, R unsplit, still gives every SM two
    blocks: one staged row then feeds 4 queries. Otherwise 2. R is then
    split over a cluster of at least 2 blocks where it holds two slices of
    256 rows, and further only as far as it takes to give every SM two
    blocks: the smallest such power-of-two cluster, up to 8, with slices of
    at least 256 rows. At the main path's shapes on an H100 this was the
    fastest plan or within 6% of it, but for the 8192-row metrics of 25 and
    7 clouds, 7% and 10% off (scripts/torch_kernel_ab.py --sweep, PERF.md)."""
    queries = 4 if lanes * -(-q_n // (THREADS * 4)) >= 2 * sms else 2
    tiles = lanes * -(-q_n // (THREADS * queries))
    cluster = 2 if r_n >= 2 * MIN_SLICE else 1
    while cluster < MAX_CLUSTER and r_n >= 2 * cluster * MIN_SLICE and tiles * cluster < 2 * sms:
        cluster *= 2
    return NN1Plan(cluster, -(-r_n // cluster), queries)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA card `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def lane_refs(lane_ref: Optional[torch.Tensor], lanes: int, groups: int, device) -> torch.Tensor:
    """Each lane's reference cloud: `lane_ref` as given, else cloud 0 for
    every lane when one cloud serves them all, or cloud l for lane l."""
    if lane_ref is not None:
        if lane_ref.shape != (lanes,):
            raise ValueError(f"lane_ref must be ({lanes},), got {tuple(lane_ref.shape)}")
        return lane_ref
    if groups == 1:
        return torch.zeros((lanes,), dtype=torch.int32, device=device)
    if groups == lanes:
        return torch.arange(lanes, dtype=torch.int32, device=device)
    raise ValueError(f"lane_ref is required when {groups} reference clouds serve {lanes} lanes")


def nn1_plain(query, ref, ref_mask, lane_ref=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of `nn1`, with the same arguments."""
    lanes, groups = query.shape[0], ref.shape[0]
    if lane_ref is None and groups in (1, lanes):
        return nn_plain.nearest_neighbor(query, ref, ref_mask)
    sel = lane_refs(lane_ref, lanes, groups, query.device).long()
    return nn_plain.nearest_neighbor(query, ref[sel], ref_mask[sel])


def nn1(
    query: torch.Tensor,
    ref: torch.Tensor,
    ref_mask: torch.Tensor,
    lane_ref: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-NN of each query among the valid rows of its lane's reference cloud.

    query (L, Q, 3) float32; ref (G, R, 3) float32; ref_mask (G, R) bool;
    lane_ref (L,) int32 picks lane l's cloud (default: cloud 0 when G == 1,
    cloud l when G == L). Unbatched (Q, 3) / (R, 3) / (R,) inputs are one
    lane. Returns (d2 (L, Q) float32, idx (L, Q) int32); the first index wins
    ties, and a fully masked reference gives d2 = 1e30.
    """
    if query.dim() == 2:
        d2, idx = nn1(query[None], ref[None], ref_mask[None])
        return d2[0], idx[0]
    if query.dim() != 3 or query.shape[-1] != 3 or ref.dim() != 3 or ref.shape[-1] != 3:
        raise ValueError(f"expected query (L, Q, 3) and ref (G, R, 3), got {tuple(query.shape)}, {tuple(ref.shape)}")
    if ref_mask.shape != ref.shape[:2]:
        raise ValueError(f"ref_mask {tuple(ref_mask.shape)} does not match ref {tuple(ref.shape)}")
    if query.device.type == "cpu":
        return nn1_plain(query, ref, ref_mask, lane_ref)
    if query.device.type != "cuda":
        raise ValueError(f"nn1 runs on cpu or cuda tensors, not {query.device}")
    lanes, q_n = query.shape[:2]
    groups, r_n = ref.shape[:2]
    lane_ref = lane_refs(lane_ref, lanes, groups, query.device)
    _require(query, torch.float32, "query")
    _require(ref, torch.float32, "ref")
    _require(ref_mask, torch.bool, "ref_mask")
    _require(lane_ref, torch.int32, "lane_ref")
    for t in (ref, ref_mask, lane_ref):
        if t.device != query.device:
            raise ValueError(f"nn1 inputs on different devices: {query.device} and {t.device}")
    if r_n == 0 or lanes > MAX_LANES:
        raise ValueError(f"nn1 needs 1 <= R and L <= {MAX_LANES}, got R={r_n}, L={lanes}")
    d2 = torch.empty((lanes, q_n), dtype=torch.float32, device=query.device)
    idx = torch.empty((lanes, q_n), dtype=torch.int32, device=query.device)
    plan = nn1_plan(lanes, q_n, r_n, sm_count(query.device.index))
    from kss_icp_torch import _build

    lib = _build.library()
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.kss_nn1(query.data_ptr(), ref.data_ptr(), ref_mask.data_ptr(), lane_ref.data_ptr(),
                           lanes, q_n, groups, r_n, plan.cluster, plan.slice, plan.queries, d2.data_ptr(),
                           idx.data_ptr(), stream)
    _build.check(code, "nn1")
    nn1.launches += 1
    nn1.launch_shapes[(lanes, q_n, r_n, groups)] += 1
    nn1.plan_launches[(plan.queries, plan.cluster)] += 1
    return d2, idx


nn1.launches = 0
nn1.launch_shapes = Counter()  # (L, Q, R, G) -> launches, counted beside `launches`
nn1.plan_launches = Counter()  # (queries a thread, cluster) -> launches, counted beside `launches`


def _require(t: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
