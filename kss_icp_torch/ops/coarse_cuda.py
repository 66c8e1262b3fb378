"""Wrapper of the `field_ave` CUDA kernel (csrc/field.cu): the "ave" rotation field.

Ports kss_icp_tpu/ops/coarse_pallas.py::rotation_scores_pallas with
method="vpu" (K1). On CPU tensors the wrapper runs the plain version,
`field_ave_plain`; on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from kss_icp_torch.core.transforms import rotate_points
from kss_icp_torch.ops.nn import masked_mean_nn_distance

_THREADS = 256  # csrc/field.cu kThreads: one partial sum per 256 source points


def rotate_sources(rotations: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """(C, P, 3) rotated copies R_c · source of a (P, 3) source."""
    return rotate_points(rotations, source.unsqueeze(0)).contiguous()


def field_ave_plain(source, source_mask, target, target_mask, rotations) -> torch.Tensor:
    """The plain PyTorch version of `field_ave`, with the same arguments."""
    rotated = rotate_sources(rotations, source)
    return masked_mean_nn_distance(rotated, source_mask, target, target_mask)


def field_ave(
    source: torch.Tensor,
    source_mask: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    rotations: torch.Tensor,
) -> torch.Tensor:
    """Mean 1-NN distance of R_c · source to the target, for every rotation.

    source (P, 3), target (T, 3) float32 with bool masks; rotations
    (C, 3, 3). Returns (C,) float32: for each c, the mean over valid source
    points of the distance to the nearest valid target point."""
    if source.dim() != 2 or target.dim() != 2 or rotations.dim() != 3:
        raise ValueError(f"expected (P, 3), (T, 3), (C, 3, 3); got {tuple(source.shape)}, {tuple(target.shape)}, {tuple(rotations.shape)}")
    if source_mask.shape != source.shape[:1] or target_mask.shape != target.shape[:1]:
        raise ValueError("masks must match their clouds")
    if source.device.type == "cpu":
        return field_ave_plain(source, source_mask, target, target_mask, rotations)
    if source.device.type != "cuda":
        raise ValueError(f"field_ave runs on cpu or cuda tensors, not {source.device}")
    for t in (source, target, rotations):
        if t.dtype != torch.float32:
            raise TypeError(f"field_ave needs float32, got {t.dtype}")
    for t in (source_mask, target_mask):
        if t.dtype != torch.bool:
            raise TypeError(f"field_ave needs bool masks, got {t.dtype}")
    for t in (source_mask, target, target_mask, rotations):
        if t.device != source.device:
            raise ValueError(f"field_ave inputs on different devices: {source.device} and {t.device}")
    if not (target.is_contiguous() and target_mask.is_contiguous()):
        raise ValueError("field_ave needs a contiguous target and target mask")
    c_n, p_n, t_n = rotations.shape[0], source.shape[0], target.shape[0]
    if p_n == 0 or t_n == 0 or c_n > 65535:
        raise ValueError(f"field_ave needs P, T >= 1 and C <= 65535, got {p_n}, {t_n}, {c_n}")
    rotated = rotate_sources(rotations, source)
    weight = source_mask.to(torch.float32).contiguous()
    nblk = (p_n + _THREADS - 1) // _THREADS
    partial = torch.empty((c_n, nblk), dtype=torch.float32, device=source.device)
    sums = torch.empty((c_n,), dtype=torch.float32, device=source.device)
    from kss_icp_torch import _build

    lib = _build.library()
    with torch.cuda.device(source.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.kss_field_ave(rotated.data_ptr(), weight.data_ptr(), target.data_ptr(),
                                 target_mask.data_ptr(), c_n, p_n, t_n, partial.data_ptr(),
                                 sums.data_ptr(), stream)
    _build.check(code, "field_ave")
    field_ave.launches += 1
    return sums / weight.sum().clamp_min(1.0)


field_ave.launches = 0
