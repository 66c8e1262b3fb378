"""Wrapper of the `nn1` CUDA kernel (csrc/nn.cu): batched exact-f32 1-NN.

Ports kss_icp_tpu/ops/nn_pallas.py::nearest_neighbor_vpu (K3) and
::nearest_neighbor_pallas (K4), which share one contract. On CPU tensors the
wrapper runs the plain version, ops/nn.py::nearest_neighbor; on CUDA tensors
it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from kss_icp_torch.ops import nn as nn_plain


def _lane_ref(lane_ref: Optional[torch.Tensor], lanes: int, groups: int, device) -> torch.Tensor:
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
    sel = _lane_ref(lane_ref, lanes, groups, query.device).long()
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
    lane_ref = _lane_ref(lane_ref, lanes, groups, query.device)
    _require(query, torch.float32, "query")
    _require(ref, torch.float32, "ref")
    _require(ref_mask, torch.bool, "ref_mask")
    _require(lane_ref, torch.int32, "lane_ref")
    for t in (ref, ref_mask, lane_ref):
        if t.device != query.device:
            raise ValueError(f"nn1 inputs on different devices: {query.device} and {t.device}")
    if r_n == 0 or lanes > 65535:
        raise ValueError(f"nn1 needs 1 <= R and L <= 65535, got R={r_n}, L={lanes}")
    d2 = torch.empty((lanes, q_n), dtype=torch.float32, device=query.device)
    idx = torch.empty((lanes, q_n), dtype=torch.int32, device=query.device)
    from kss_icp_torch import _build

    lib = _build.library()
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.kss_nn1(query.data_ptr(), ref.data_ptr(), ref_mask.data_ptr(), lane_ref.data_ptr(),
                           lanes, q_n, groups, r_n, d2.data_ptr(), idx.data_ptr(), stream)
    _build.check(code, "nn1")
    nn1.launches += 1
    return d2, idx


nn1.launches = 0


def _require(t: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
