"""Wrappers of the two rotation-field CUDA kernels: the "ave" field.

`field_ave` (csrc/field.cu) ports kss_icp_tpu/ops/coarse_pallas.py::
rotation_scores_pallas with method="vpu" (K1), exact float32 differences;
`field_dot` (csrc/field_dot.cu) ports method="dot" (K1-dot), the augmented
dot product [R q, 1] . [-2 t, |t|^2] with |q|^2 added back, at a precision
("default" is one bf16 pass). On CPU tensors each wrapper runs its plain
version (`field_ave_plain`, `field_dot_plain`); on CUDA tensors it launches
its kernel or raises.
"""

from __future__ import annotations

import torch

from kss_icp_torch.core.transforms import rotate_points
from kss_icp_torch.ops.nn import BIG, _BLOCK_ELEMS, masked_mean, masked_mean_nn_distance

_THREADS = 256  # kThreads of csrc/field.cu and field_dot.cu: one partial sum per 256 source points
# precision -> does the dot round its operands to bf16? coarse_pallas.py:37-41:
# the TPU's dot takes one bf16 pass or full float32, and "high" is promoted
# to full float32.
BF16_OPERANDS = {"default": True, "high": False, "highest": False}


def rotate_sources(rotations: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """(C, P, 3) rotated copies R_c · source of a (P, 3) source."""
    return rotate_points(rotations, source.unsqueeze(0)).contiguous()


def field_ave_plain(source, source_mask, target, target_mask, rotations) -> torch.Tensor:
    """The plain PyTorch version of `field_ave`, with the same arguments."""
    rotated = rotate_sources(rotations, source)
    return masked_mean_nn_distance(rotated, source_mask, target, target_mask)


def _use_plain(name, source, source_mask, target, target_mask, rotations) -> bool:
    """The wrappers' shared checks: True for CPU inputs (run the plain
    version), False for CUDA inputs the kernel takes; raises otherwise."""
    if source.dim() != 2 or target.dim() != 2 or rotations.dim() != 3:
        raise ValueError(f"expected (P, 3), (T, 3), (C, 3, 3); got {tuple(source.shape)}, {tuple(target.shape)}, {tuple(rotations.shape)}")
    if source_mask.shape != source.shape[:1] or target_mask.shape != target.shape[:1]:
        raise ValueError("masks must match their clouds")
    if source.device.type == "cpu":
        return True
    if source.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda tensors, not {source.device}")
    for t in (source, target, rotations):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} needs float32, got {t.dtype}")
    for t in (source_mask, target_mask):
        if t.dtype != torch.bool:
            raise TypeError(f"{name} needs bool masks, got {t.dtype}")
    for t in (source_mask, target, target_mask, rotations):
        if t.device != source.device:
            raise ValueError(f"{name} inputs on different devices: {source.device} and {t.device}")
    if not (target.is_contiguous() and target_mask.is_contiguous()):
        raise ValueError(f"{name} needs a contiguous target and target mask")
    c_n, p_n, t_n = rotations.shape[0], source.shape[0], target.shape[0]
    if p_n == 0 or t_n == 0 or c_n > 65535:
        raise ValueError(f"{name} needs P, T >= 1 and C <= 65535, got {p_n}, {t_n}, {c_n}")
    return False


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
    if _use_plain("field_ave", source, source_mask, target, target_mask, rotations):
        return field_ave_plain(source, source_mask, target, target_mask, rotations)
    c_n, p_n, t_n = rotations.shape[0], source.shape[0], target.shape[0]
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


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (nearest, ties to even), back in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _dot_precision(precision: str) -> bool:
    if precision not in BF16_OPERANDS:
        raise ValueError(f"precision must be one of {sorted(BF16_OPERANDS)}, got {precision!r}")
    return BF16_OPERANDS[precision]


def dot_operands(source, source_mask, target, target_mask, rotations):
    """The K1-dot operands (coarse_pallas.py:147-166): the rotated source
    (C, P, 3); q2 = (x² + y²) + z² of the unrotated source (P,); the source
    weight (P,); ra = [-2 t m, |t|² or 1e30 where masked] (T, 4)."""
    rotated = rotate_sources(rotations, source)
    sx, sy, sz = source.unbind(-1)
    q2 = (sx * sx + sy * sy) + sz * sz
    weight = source_mask.to(torch.float32)
    tx, ty, tz = target.unbind(-1)
    t2 = torch.where(target_mask, (tx * tx + ty * ty) + tz * tz, torch.full_like(tx, BIG))
    ra = torch.cat([(-2.0 * target) * target_mask.to(torch.float32)[:, None], t2[:, None]], dim=1)
    return rotated, q2, weight, ra.contiguous()


def field_dot_plain(source, source_mask, target, target_mask, rotations, precision="highest") -> torch.Tensor:
    """The plain PyTorch version of `field_dot`, with the same arguments: the
    kernel's elementwise order rel = ((qx·ax + qy·ay) + qz·az) + aw, not a
    matrix product, so every rel agrees with the kernel bit for bit."""
    bf16 = _dot_precision(precision)
    rotated, q2, weight, ra = dot_operands(source, source_mask, target, target_mask, rotations)
    if bf16:
        rotated, ra = _bf16(rotated), _bf16(ra)
    ax, ay, az, aw = (ra[:, k] for k in range(4))
    c_n, p_n, t_n = rotated.shape[0], rotated.shape[1], ra.shape[0]
    rows = max(1, _BLOCK_ELEMS // max(1, p_n * t_n))
    mins = []
    for c0 in range(0, c_n, rows):
        q = rotated[c0:c0 + rows, :, None, :]
        rel = ((q[..., 0] * ax + q[..., 1] * ay) + q[..., 2] * az) + aw
        mins.append(rel.amin(dim=-1))
    m = torch.cat(mins, dim=0)
    return masked_mean(torch.sqrt((m + q2).clamp_min(0.0)), source_mask)


def field_dot(
    source: torch.Tensor,
    source_mask: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    rotations: torch.Tensor,
    precision: str = "highest",
) -> torch.Tensor:
    """The "ave" field of `field_ave` through the augmented dot product.

    Same arguments and result as `field_ave`, plus `precision`: "highest"
    and "high" compute every product in float32; "default" rounds the
    rotated source and the augmented target to bfloat16 first, the TPU's one
    bf16 pass (products exact, float32 sums). The expansion form cancels
    for near-coincident points; the clamp at 0 is part of the contract, so
    the field differs from `field_ave` by more than rounding."""
    bf16 = _dot_precision(precision)
    if _use_plain("field_dot", source, source_mask, target, target_mask, rotations):
        return field_dot_plain(source, source_mask, target, target_mask, rotations, precision)
    c_n, p_n, t_n = rotations.shape[0], source.shape[0], target.shape[0]
    rotated, q2, weight, ra = dot_operands(source, source_mask, target, target_mask, rotations)
    nblk = (p_n + _THREADS - 1) // _THREADS
    partial = torch.empty((c_n, nblk), dtype=torch.float32, device=source.device)
    sums = torch.empty((c_n,), dtype=torch.float32, device=source.device)
    from kss_icp_torch import _build

    lib = _build.library()
    with torch.cuda.device(source.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.kss_field_dot(rotated.data_ptr(), q2.data_ptr(), weight.data_ptr(),
                                 ra.data_ptr(), c_n, p_n, t_n, int(bf16), partial.data_ptr(),
                                 sums.data_ptr(), stream)
    _build.check(code, "field_dot")
    field_dot.launches += 1
    return sums / weight.sum().clamp_min(1.0)


field_dot.launches = 0
