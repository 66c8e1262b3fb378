"""Wrappers of the rotation-field CUDA kernels: the "ave", "trim", "max" and "diff" fields.

`field_ave` (csrc/field.cu) ports kss_icp_tpu/ops/coarse_pallas.py::
rotation_scores_pallas with method="vpu" (K1), exact float32 differences;
`field_dot` (csrc/field_dot.cu) ports method="dot" (K1-dot), the augmented
dot product [R q, 1] . [-2 t, |t|^2] with |q|^2 added back, at a precision
("default" is one bf16 pass). Both are one kernel (csrc/field_kernel.cuh)
launched with a plan from `field_plan`. `field_trim` (csrc/field_trim.cu) is
the same kernel in its per-point mode: it scores the overlap tier's "trim"
field, which JAX computes with XLA (kss_icp_tpu/models/coarse.py:115-131),
not a TPU kernel; `field_sq` (the same file) is the per-point mode writing
squared distances, for the "max" and "diff" fields, which JAX computes with
XLA too. On CPU tensors each wrapper runs its plain version
(`field_ave_plain`, `field_dot_plain`, `field_trim_plain`, `field_max_plain`,
`field_diff_plain`); on CUDA tensors it launches its kernel or raises.
"""

from __future__ import annotations

import torch

from kss_icp_torch.core.transforms import rotate_points
from kss_icp_torch.ops.nn import (BIG, _BLOCK_ELEMS, masked_mean, masked_mean_nn_distance, masked_nn_error,
                                  sq_error, trimmed_masked_mean)

FIELD_GROUP = 256  # kGroup of csrc/field_kernel.cuh: one partial sum per 256 source points
FIELD_Q = 4  # kQ of csrc/field_kernel.cuh: rotations a block
FIELD_SLOTS = (4, 2, 1)  # groups of 256 points a block scans at once
# precision -> does the dot round its operands to bf16? coarse_pallas.py:37-41:
# the TPU's dot takes one bf16 pass or full float32, and "high" is promoted
# to full float32.
BF16_OPERANDS = {"default": True, "high": False, "highest": False}


def field_plan(p_n: int) -> int:
    """The launch plan of `field_ave` and `field_dot` for P source points:
    the groups of 256 points a block scans at once (256 threads each), as
    many as the source has, up to 4. A block holds FIELD_Q rotations, so the
    grid is ceil(C / 4) blocks: 4 slots on the 8³ grid's padded clouds, 2 at
    512-point prefixes."""
    groups = -(-p_n // FIELD_GROUP)
    return next(s for s in FIELD_SLOTS if s <= groups)


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


def _scratch(c_n: int, p_n: int, device) -> tuple:
    """The kernels' outputs: partials (C, ceil(P / 256)) and sums (C,)."""
    groups = -(-p_n // FIELD_GROUP)
    return (torch.empty((c_n, groups), dtype=torch.float32, device=device),
            torch.empty((c_n,), dtype=torch.float32, device=device))


def field_ave_sums(rotated, weight, target, target_mask, slots: int) -> torch.Tensor:
    """One launch of the `field_ave` kernel with `slots` group slots (see
    `field_plan`): the (C,) sums over valid points of the distance to the
    nearest valid target row. rotated (C, P, 3), weight (P,) float32 0/1,
    target (T, 3), target_mask (T,) bool, all contiguous on one card. The
    sums' bits do not depend on `slots`. Counts the launch in
    `field_ave.launches`."""
    from kss_icp_torch import _build

    c_n, p_n = rotated.shape[:2]
    partial, sums = _scratch(c_n, p_n, rotated.device)
    lib = _build.library()
    with torch.cuda.device(rotated.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.kss_field_ave(rotated.data_ptr(), weight.data_ptr(), target.data_ptr(), target_mask.data_ptr(),
                                 c_n, p_n, target.shape[0], slots, partial.data_ptr(), sums.data_ptr(), stream)
    _build.check(code, "field_ave")
    field_ave.launches += 1
    return sums


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
    rotated = rotate_sources(rotations, source)
    weight = source_mask.to(torch.float32).contiguous()
    sums = field_ave_sums(rotated, weight, target, target_mask, field_plan(source.shape[0]))
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


def field_dot_sums(rotated, q2, weight, ra, target_mask, bf16: bool, slots: int) -> torch.Tensor:
    """One launch of the `field_dot` kernel with `slots` group slots on the
    operands of `dot_operands` (contiguous, on one card) and the target
    mask: the (C,) sums. The sums' bits do not depend on `slots`. Counts the
    launch in `field_dot.launches`."""
    from kss_icp_torch import _build

    c_n, p_n = rotated.shape[:2]
    partial, sums = _scratch(c_n, p_n, rotated.device)
    lib = _build.library()
    with torch.cuda.device(rotated.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.kss_field_dot(rotated.data_ptr(), q2.data_ptr(), weight.data_ptr(), ra.data_ptr(),
                                 target_mask.data_ptr(), c_n, p_n, ra.shape[0], int(bf16), slots, partial.data_ptr(),
                                 sums.data_ptr(), stream)
    _build.check(code, "field_dot")
    field_dot.launches += 1
    return sums


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
    rotated, q2, weight, ra = dot_operands(source, source_mask, target, target_mask, rotations)
    sums = field_dot_sums(rotated, q2, weight, ra, target_mask, bf16, field_plan(source.shape[0]))
    return sums / weight.sum().clamp_min(1.0)


field_dot.launches = 0


def field_trim_plain(source, source_mask, target, target_mask, rotations, trim_fraction=0.7) -> torch.Tensor:
    """The plain PyTorch version of `field_trim`, with the same arguments."""
    return masked_nn_error(rotate_sources(rotations, source), source_mask, target, target_mask, "trim", trim_fraction)


def field_trim_distances(rotated, weight, target, target_mask, slots: int) -> torch.Tensor:
    """One launch of the field kernel in its per-point mode with `slots`
    group slots: the (C, P) distances sqrt(max(min, 0)) of each rotated
    source point to the nearest valid target row, 0 where weight is 0, the
    bits of its plain version ops/nn.py::nn_distances(rotated, source_mask,
    target, target_mask). rotated (C, P, 3), weight (P,) float32 0/1,
    target (T, 3), target_mask (T,) bool, all contiguous on one card. Counts
    the launch in `field_trim.launches`."""
    from kss_icp_torch import _build

    c_n, p_n = rotated.shape[:2]
    dist = torch.empty((c_n, p_n), dtype=torch.float32, device=rotated.device)
    lib = _build.library()
    with torch.cuda.device(rotated.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.kss_field_trim(rotated.data_ptr(), weight.data_ptr(), target.data_ptr(), target_mask.data_ptr(),
                                  c_n, p_n, target.shape[0], slots, dist.data_ptr(), stream)
    _build.check(code, "field_trim")
    field_trim.launches += 1
    return dist


def field_trim(
    source: torch.Tensor,
    source_mask: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    rotations: torch.Tensor,
    trim_fraction: float = 0.7,
) -> torch.Tensor:
    """The trimmed field: for every rotation, the mean of the smallest
    ceil(trim_fraction * n_valid) 1-NN distances of the valid points of
    R_c · source to the valid target (kss_icp_tpu/ops/nn.py:195-198).

    Same arguments as `field_ave`, plus the fraction. The kernel writes the
    (C, P) per-point distances; the trimmed mean along P (`trimmed_masked_mean`:
    a sort, a cumulative sum) runs in PyTorch. Returns (C,) float32."""
    if _use_plain("field_trim", source, source_mask, target, target_mask, rotations):
        return field_trim_plain(source, source_mask, target, target_mask, rotations, trim_fraction)
    rotated = rotate_sources(rotations, source)
    weight = source_mask.to(torch.float32).contiguous()
    dist = field_trim_distances(rotated, weight, target, target_mask, field_plan(source.shape[0]))
    return trimmed_masked_mean(dist, source_mask.expand(dist.shape), trim_fraction)


field_trim.launches = 0


def field_max_plain(source, source_mask, target, target_mask, rotations) -> torch.Tensor:
    """The plain PyTorch version of `field_sq` at metric "max"."""
    return masked_nn_error(rotate_sources(rotations, source), source_mask, target, target_mask, "max")


def field_diff_plain(source, source_mask, target, target_mask, rotations) -> torch.Tensor:
    """The plain PyTorch version of `field_sq` at metric "diff"."""
    return masked_nn_error(rotate_sources(rotations, source), source_mask, target, target_mask, "diff")


SQ_PLAIN = {"max": field_max_plain, "diff": field_diff_plain}


def field_sq_distances(rotated, weight, target, target_mask, slots: int) -> torch.Tensor:
    """One launch of the field kernel in its squared per-point mode with
    `slots` group slots: the (C, P) squared distances of each rotated source
    point to the nearest valid target row (the raw biased min), 0 where weight
    is 0, the bits of its plain version ops/nn.py::nn_sqdistances(rotated,
    source_mask, target, target_mask). Arguments as `field_trim_distances`.
    Counts the launch in `field_sq.launches`."""
    from kss_icp_torch import _build

    c_n, p_n = rotated.shape[:2]
    dist = torch.empty((c_n, p_n), dtype=torch.float32, device=rotated.device)
    lib = _build.library()
    with torch.cuda.device(rotated.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.kss_field_sq(rotated.data_ptr(), weight.data_ptr(), target.data_ptr(), target_mask.data_ptr(),
                                c_n, p_n, target.shape[0], slots, dist.data_ptr(), stream)
    _build.check(code, "field_sq")
    field_sq.launches += 1
    return dist


def field_sq(
    source: torch.Tensor,
    source_mask: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    rotations: torch.Tensor,
    metric: str,
) -> torch.Tensor:
    """The "max" or "diff" field (kss_icp_tpu/ops/nn.py:183-194): for every
    rotation, the largest squared 1-NN distance of the valid points of
    R_c · source to the valid target, or the largest distance less the mean.

    Same arguments as `field_ave`, plus the metric. The kernel writes the
    (C, P) squared distances; each row's metric (`ops/nn.py::sq_error`)
    runs in PyTorch. Returns (C,) float32."""
    if metric not in SQ_PLAIN:
        raise ValueError(f"field_sq scores 'max' or 'diff', not {metric!r}")
    if _use_plain("field_sq", source, source_mask, target, target_mask, rotations):
        return SQ_PLAIN[metric](source, source_mask, target, target_mask, rotations)
    rotated = rotate_sources(rotations, source)
    weight = source_mask.to(torch.float32).contiguous()
    return sq_error(field_sq_distances(rotated, weight, target, target_mask, field_plan(source.shape[0])),
                    source_mask, metric)


field_sq.launches = 0
