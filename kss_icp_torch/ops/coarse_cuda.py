"""Wrappers of the rotation-field CUDA kernels: the "ave", "dot", "trim", "max" and "diff" fields.

`field_ave`, `field_trim` and `field_sq` are one kernel (csrc/field_trim.cu,
`kss_field_cull`), one launch a field after `field_order`'s sort: it rotates
the source, culls target tiles by their boxes exactly and reduces each
rotation's row itself. Its "ave" statistic ports kss_icp_tpu/ops/
coarse_pallas.py::rotation_scores_pallas with method="vpu" (K1); "trim",
"max" and "diff" score the fields JAX computes with XLA
(kss_icp_tpu/models/coarse.py:113-131), not a TPU kernel. Its probe mode
(`field_trim_distances`, `field_sq_distances`) writes the per-point values
for the tests. `field_dot` (csrc/field_dot.cu) ports method="dot" (K1-dot),
the augmented dot product [R q, 1] . [-2 t, |t|^2] with |q|^2 added back, on
the tensor cores at a precision ("default" is one bf16 pass, "high" and
"highest" six), on a grid and a staged share of the target from
`dot_plan`. On CPU tensors each
wrapper runs its plain version (`field_ave_plain`, `field_dot_plain`,
`field_trim_plain`, `field_max_plain`, `field_diff_plain`); on CUDA tensors
it launches its kernel or raises.
"""

from __future__ import annotations

from collections import Counter, namedtuple

import torch

from kss_icp_torch.core.transforms import rotate_points
from kss_icp_torch.ops.nn import (BIG, _BLOCK_ELEMS, QUANTILE_MAX_WIDTH, masked_mean, masked_mean_nn_distance,
                                  masked_nn_error, nn_distances, nn_sqdistances)
from kss_icp_torch.ops.nn_cuda import SMS

# precision -> does the dot round its operands to bf16 once? coarse_pallas.py:37-41:
# the TPU's dot takes one bf16 pass or HIGHEST (six), and "high" is promoted
# to HIGHEST.
BF16_OPERANDS = {"default": True, "high": False, "highest": False}


def rotate_sources(rotations: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """(C, P, 3) rotated copies R_c · source of a (P, 3) source: the plain
    versions' and the yardsticks' rotation (the kernels rotate in place)."""
    return rotate_points(rotations, source.unsqueeze(0)).contiguous()


def field_ave_plain(source, source_mask, target, target_mask, rotations) -> torch.Tensor:
    """The plain PyTorch version of `field_ave`, with the same arguments:
    the mean's sum in float64, as the kernel's sum."""
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
    *,
    scanned: torch.Tensor | None = None,
) -> torch.Tensor:
    """Mean 1-NN distance of R_c · source to the target, for every rotation.

    source (P, 3), target (T, 3) float32 with bool masks; rotations
    (C, 3, 3). Returns (C,) float32: for each c, the mean over valid source
    points of the distance to the nearest valid target point (0 with no
    valid source point), its sum in float64. On the card, one launch of the
    culling kernel at its "ave" statistic after `field_order`'s sort, the
    plain version's bits; `scanned` as `_cull_launch` takes it."""
    if _use_plain("field_ave", source, source_mask, target, target_mask, rotations):
        return field_ave_plain(source, source_mask, target, target_mask, rotations)
    return _field_cull("field_ave", field_ave, "ave", source, source_mask, target, target_mask, rotations,
                       scanned=scanned)


field_ave.launches = 0
field_ave.launch_grids = Counter()  # rotations C -> launches, counted beside `launches`


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (nearest, ties to even), back in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _dot_precision(precision: str) -> bool:
    if precision not in BF16_OPERANDS:
        raise ValueError(f"precision must be one of {sorted(BF16_OPERANDS)}, got {precision!r}")
    return BF16_OPERANDS[precision]


def dot_operands(source, source_mask, target, target_mask, rotations):
    """The K1-dot operands of the plain version (coarse_pallas.py:147-166):
    the rotated source (C, P, 3); q2 = (x² + y²) + z² of the unrotated
    source (P,); the source weight (P,); ra = [-2 t m, |t|² or 1e30 where
    masked] (T, 4). The kernel forms them itself."""
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
    elementwise float32 expansion rel = ((qx·ax + qy·ay) + qz·az) + aw, on
    bf16-rounded operands at "default", then the mean's sum in float64. The
    kernel's tensor-core sums agree with it to rtol 2e-5, not bit for bit."""
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
    return masked_mean(torch.sqrt((m + q2).clamp_min(0.0)), source_mask, torch.float64)


DOT_POINTS = 64  # kPoints of csrc/field_dot.cu: source points an item (a warp's four m16 tiles)
DOT_TILE = 64  # kTileRows: the staged target rows are padded to a multiple of it
DOT_MAX_POINTS = DOT_POINTS * 4096  # kMaxGroups groups of 64 source points
# Shared memory of the field_dot kernel on an H100: an SM's 228 KB, 1 KB of it reserved a block;
# the kernel's static share (the groups list, the warps' counts).
DOT_SM_SMEM = 233472
DOT_STATIC_SMEM = 2 * 4096 + 64
DotPlan = namedtuple("DotPlan", "blocks cap")


def dot_stage_bytes(rows: int, words: int) -> int:
    """csrc/field_dot.cu's staged target: `rows` rows, 4 coordinates of
    `words` 4-byte words each."""
    return rows * 4 * words * 4


def dot_plan(c_n: int, p_n: int, t_n: int, precision: str, sms: int = SMS) -> DotPlan:
    """The launch plan of `field_dot` for C rotations, P source and T target
    points at `precision` on a card of `sms` SMs (an operand value takes 3
    words at "high" / "highest", 1 at "default"): the persistent grid
    (two blocks an SM where two hold the staged target, else one; no more
    than C) and the target rows a block stages at once (the whole target,
    padded to 64 rows, where it fits one block's shared memory, else the
    most that fit: the kernel then walks it in chunks). Raises for a source
    past DOT_MAX_POINTS."""
    if p_n > DOT_MAX_POINTS:
        raise ValueError(f"field_dot takes at most {DOT_MAX_POINTS} source points, got {p_n}")
    words = 1 if _dot_precision(precision) else 3
    whole = -(-t_n // DOT_TILE) * DOT_TILE
    room = DOT_SM_SMEM // 2 - 1024 - DOT_STATIC_SMEM  # a block's share with two an SM
    per_sm = 2 if dot_stage_bytes(whole, words) <= room else 1
    room = DOT_SM_SMEM - 1024 - DOT_STATIC_SMEM if per_sm == 1 else room
    fit = room // dot_stage_bytes(DOT_TILE, words) * DOT_TILE
    return DotPlan(max(1, min(c_n, per_sm * sms)), min(whole, fit))


def field_dot(
    source: torch.Tensor,
    source_mask: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    rotations: torch.Tensor,
    precision: str = "highest",
) -> torch.Tensor:
    """The "ave" field through the augmented dot product (coarse_pallas.py
    method="dot"): for every rotation, the mean over valid source points of
    sqrt(max(min_t [R s, 1]·[-2t, |t|²] + |s|², 0)), masked target rows at
    1e30. Same arguments as `field_ave`, plus the dot precision. The
    expansion form cancels for near-coincident points; the clamp at 0 is
    part of the contract, so the field differs from `field_ave` by more
    than rounding.

    On the card one launch of csrc/field_dot.cu, which rotates the source
    and forms both operands itself and takes the product on the tensor
    cores (mma.sync): bf16 operands once at "default", three bf16 parts of
    each and six products at "high" / "highest", float32 accumulators (the
    head hh and the rest apart, added once rounded to nearest). Its sums are
    not the plain version's elementwise float32 expansion bit for bit (a
    deliberate divergence): the field agrees with `field_dot_plain` to rtol
    2e-5, repeated runs give the same bits, and a suffix-masked cloud its
    valid prefix's bits. Counts the launch in `field_dot.launches`."""
    _dot_precision(precision)
    if _use_plain("field_dot", source, source_mask, target, target_mask, rotations):
        return field_dot_plain(source, source_mask, target, target_mask, rotations, precision)
    return _field_dot(source, source_mask, target, target_mask, rotations, precision)


def _field_dot(source, source_mask, target, target_mask, rotations, precision, cap=None) -> torch.Tensor:
    """One launch of csrc/field_dot.cu on inputs `_use_plain` accepted, on
    `dot_plan`'s grid; `cap`: the target rows a block stages at once, a
    multiple of DOT_TILE, by default `dot_plan`'s (the tests force chunks
    with it). Counts the
    launch in `field_dot.launches`."""
    from kss_icp_torch import _build
    from kss_icp_torch.ops.nn_cuda import sm_count

    bf16 = _dot_precision(precision)
    c_n, p_n, t_n = rotations.shape[0], source.shape[0], target.shape[0]
    plan = dot_plan(c_n, p_n, t_n, precision, sm_count(source.device.index))
    cap = cap or plan.cap
    source, source_mask, rotations = source.contiguous(), source_mask.contiguous(), rotations.contiguous()
    dev = source.device
    out = torch.empty((c_n,), dtype=torch.float32, device=dev)
    partial = torch.empty((c_n, -(-p_n // DOT_POINTS), 4), dtype=torch.float64, device=dev)
    mins = None if t_n <= cap else torch.empty((c_n, p_n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = _build.library().kss_field_dot(
            source.data_ptr(), source_mask.data_ptr(), target.data_ptr(), target_mask.data_ptr(),
            rotations.data_ptr(), c_n, p_n, t_n, int(bf16), plan.blocks, cap,
            out.data_ptr(), partial.data_ptr(), None if mins is None else mins.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "field_dot")
    field_dot.launches += 1
    return out


field_dot.launches = 0


def field_trim_plain(source, source_mask, target, target_mask, rotations, trim_fraction=0.7) -> torch.Tensor:
    """The plain PyTorch version of `field_trim`, with the same arguments:
    the trimmed mean's cumulative sum in float64, as the kernel's sum."""
    return masked_nn_error(rotate_sources(rotations, source), source_mask, target, target_mask, "trim", trim_fraction)


def field_max_plain(source, source_mask, target, target_mask, rotations) -> torch.Tensor:
    """The plain PyTorch version of `field_sq` at metric "max"."""
    return masked_nn_error(rotate_sources(rotations, source), source_mask, target, target_mask, "max")


def field_diff_plain(source, source_mask, target, target_mask, rotations) -> torch.Tensor:
    """The plain PyTorch version of `field_sq` at metric "diff": the mean's
    sum in float64, as the kernel's sum."""
    return masked_nn_error(rotate_sources(rotations, source), source_mask, target, target_mask, "diff")


SQ_PLAIN = {"max": field_max_plain, "diff": field_diff_plain}

FIELD_TILE = 16  # kTileRows of csrc/field_trim.cu: target rows a box
FIELD_RUN = 128  # kRunRows: rows a run of 8 tiles' box; a block's share of the target is a multiple of it
# Shared memory a block of the field_trim kernel may take on an H100 (227 KB, less its static share).
FIELD_SMEM = 232448 - 2048
# Source points whose mins a block holds in shared memory; past it ("ave", "max", "diff", the probe
# modes) they go to a (C, P) scratch in device memory.
FIELD_MAX_POINTS = 32768
MORTON_BITS = 9  # bits an axis of field_keys' codes
# The kernel's statistics: the fields, and the probe modes' (C, P) distances and squared distances.
CULL_STATS = {"trim": 0, "max": 1, "diff": 2, "distances": 3, "sqdistances": 4, "ave": 5}
_CONSTANTS: dict = {}


def cull_smem_bytes(cap: int, p_n: int) -> int:
    """csrc/field_trim.cu::smem_bytes: a block's dynamic shared memory at
    `cap` staged target rows (16 B each, a 32 B box a tile and a run) and
    P source points' mins."""
    return cap * 16 + cap // FIELD_TILE * 32 + cap // FIELD_RUN * 32 + -(-p_n // 4) * 16


def check_width(p_n: int, stat: str) -> None:
    """Raise, before any launch, for P of 8192 or more at "trim" (the
    rank's rounding guard, as `trimmed_masked_mean` raises)."""
    if stat == "trim" and p_n >= QUANTILE_MAX_WIDTH:
        raise ValueError(f"field_trim takes fewer than {QUANTILE_MAX_WIDTH} values per row (the rank's rounding "
                         f"guard), got {p_n}")


def smem_points(p_n: int) -> int:
    """The source points whose mins a block holds in shared memory: all P
    up to FIELD_MAX_POINTS, none past it (a (C, P) scratch holds them)."""
    return p_n if p_n <= FIELD_MAX_POINTS else 0


def field_cull_plan(p_n: int, t_n: int, stat: str) -> int:
    """The target rows a block of the field_trim kernel stages at once, a
    multiple of FIELD_RUN: the whole target where it fits beside the mins
    `smem_points` keeps, else the most that fit (the kernel walks the target
    in chunks of it). Raises as `check_width` does."""
    check_width(p_n, stat)
    whole = -(-t_n // FIELD_RUN) * FIELD_RUN
    fit = (FIELD_SMEM - cull_smem_bytes(0, smem_points(p_n))) // cull_smem_bytes(FIELD_RUN, 0) * FIELD_RUN
    return min(whole, fit)


def _spread(device) -> torch.Tensor:
    """(512,) int32: each 9-bit index with its bits spread three apart, cached a device."""
    key = str(device)
    if key not in _CONSTANTS:
        i = torch.arange(1 << MORTON_BITS, dtype=torch.int32)
        _CONSTANTS[key] = sum(((i >> b) & 1) << (3 * b) for b in range(MORTON_BITS)).to(device)
    return _CONSTANTS[key]


def field_keys_plain(source, source_mask, target, target_mask) -> torch.Tensor:
    """The plain PyTorch version of `field_keys`, with the same arguments
    and bits."""
    p_n = source.shape[0]
    pts = torch.cat((source, target))
    lo, hi = torch.aminmax(pts, dim=0)
    span = (hi - lo).clamp_min(1e-30)
    scale = torch.full_like(span, float(1 << MORTON_BITS)) / span  # a division, as the kernel's
    cell = ((pts - lo) * scale).to(torch.int32).clamp_(0, (1 << MORTON_BITS) - 1)
    code = (_spread(source.device)[cell] << torch.arange(3, dtype=torch.int32, device=source.device)).sum(
        dim=-1, dtype=torch.int32)
    flags = torch.cat((source_mask, target_mask)).logical_not().to(torch.int32) << 27
    flags[p_n:] += 1 << 28
    return code + flags


def field_keys(source, source_mask, target, target_mask) -> torch.Tensor:
    """The sort keys of `field_order`: (P + T,) int32, cloud * 2^28 +
    invalid * 2^27 + the Morton code (9 bits an axis, x lowest) of the row's
    cell in a 512^3 grid over the box around both clouds' rows. One launch
    of csrc/field_trim.cu's keys kernel on CUDA tensors (counted in
    `field_keys.launches`), the plain version on CPU tensors. The inputs as
    `field_trim` takes them, contiguous."""
    if source.device.type == "cpu":
        return field_keys_plain(source, source_mask, target, target_mask)
    from kss_icp_torch import _build

    keys = torch.empty((source.shape[0] + target.shape[0],), dtype=torch.int32, device=source.device)
    with torch.cuda.device(source.device):
        code = _build.library().kss_field_keys(source.data_ptr(), source_mask.data_ptr(), target.data_ptr(),
                                               target_mask.data_ptr(), source.shape[0], target.shape[0],
                                               keys.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(code, "field_keys")
    field_keys.launches += 1
    return keys


field_keys.launches = 0


def field_order(source, source_mask, target, target_mask) -> torch.Tensor:
    """The field_trim kernel's order of both clouds: (P + T,) int64, the
    indices of a stable sort of `field_keys`, so the source's rows come
    first (indices 0..P-1), then the target's (P..P+T-1), each cloud's
    valid rows first, in the Z order of the grid. Any order gives the kernel
    the same bits; this one keeps each warp's 32 source points, and each
    tile's 16 target rows, near each other."""
    return torch.sort(field_keys(source, source_mask, target, target_mask), stable=True).indices


def _cull_launch(name, stat, source, source_mask, target, target_mask, order, rotations, out, trim_fraction=0.7,
                 scanned=None, cap=None) -> None:
    """One launch of the field_trim kernel (csrc/field_trim.cu) at `stat`
    into `out` ((C,) float32, or (C, P) in the probe modes) on contiguous
    inputs and `field_order`'s order; counts nothing (`_field_cull` counts
    the wrapper's launches; the smoke run and the A/B script time the
    kernel alone through it). `scanned`: a (2,) int64 tensor on the card
    the kernel adds the (point, row) pairs it scanned and the box tests it
    made to, or None. `cap`: the target rows a block stages at once, by
    default `field_cull_plan`'s (the tests force chunks with it). Past
    FIELD_MAX_POINTS source points the mins go to a (C, P) scratch."""
    from kss_icp_torch import _build

    c_n, p_n, t_n = rotations.shape[0], source.shape[0], target.shape[0]
    cap = cap or field_cull_plan(p_n, t_n, stat)
    if cap % FIELD_RUN:
        raise ValueError(f"{name}: a block's share of the target must be a multiple of {FIELD_RUN}, got {cap}")
    scratch = None if smem_points(p_n) else torch.empty((c_n, p_n), dtype=torch.float32, device=source.device)
    with torch.cuda.device(source.device):
        code = _build.library().kss_field_cull(
            source.data_ptr(), source_mask.data_ptr(), target.data_ptr(), target_mask.data_ptr(), order.data_ptr(),
            rotations.data_ptr(), c_n, p_n, t_n, CULL_STATS[stat], float(trim_fraction), cap, out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), None if scanned is None else scanned.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, name)


def _field_cull(name, counter, stat, source, source_mask, target, target_mask, rotations, trim_fraction=0.7,
                scanned=None, cap=None) -> torch.Tensor:
    """`field_order`, then one `_cull_launch` on inputs `_use_plain`
    accepted: (C,) float32, or (C, P) in the probe modes; `cap` as
    `_cull_launch` takes it. Raises as `check_width` does before any
    launch. Counts the launch in
    `counter.launches`, and by rotations in `counter.launch_grids`."""
    c_n, p_n = rotations.shape[0], source.shape[0]
    check_width(p_n, stat)
    source, source_mask, rotations = source.contiguous(), source_mask.contiguous(), rotations.contiguous()
    order = field_order(source, source_mask, target, target_mask)
    out = torch.empty((c_n, p_n) if stat in ("distances", "sqdistances") else (c_n,), dtype=torch.float32,
                      device=source.device)
    _cull_launch(name, stat, source, source_mask, target, target_mask, order, rotations, out, trim_fraction,
                 scanned, cap)
    counter.launches += 1
    counter.launch_grids[c_n] += 1
    return out


def field_trim(
    source: torch.Tensor,
    source_mask: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    rotations: torch.Tensor,
    trim_fraction: float = 0.7,
    *,
    scanned: torch.Tensor | None = None,
) -> torch.Tensor:
    """The trimmed field: for every rotation, the mean of the smallest
    ceil(trim_fraction * n_valid) 1-NN distances of the valid points of
    R_c · source to the valid target (kss_icp_tpu/ops/nn.py:195-198).

    Same arguments as `field_ave`, plus the fraction; on the card, `scanned`
    as `_cull_launch` takes it. One kernel launch after
    `field_order`'s sort: the kernel rotates the source, culls target tiles
    exactly and reduces each rotation's row itself. Returns (C,) float32,
    the plain version's bits."""
    if _use_plain("field_trim", source, source_mask, target, target_mask, rotations):
        return field_trim_plain(source, source_mask, target, target_mask, rotations, trim_fraction)
    return _field_cull("field_trim", field_trim, "trim", source, source_mask, target, target_mask, rotations,
                       trim_fraction, scanned)


field_trim.launches = 0
field_trim.launch_grids = Counter()  # rotations C -> launches, counted beside `launches`


def field_trim_distances(source, source_mask, target, target_mask, rotations, *, scanned=None) -> torch.Tensor:
    """The probe mode of `field_trim`'s kernel: the (C, P) distances
    sqrt(max(min, 0)) of each rotated source point to the nearest valid
    target row, 0 at a masked source point, in the caller's point order; on
    CPU tensors its plain version ops/nn.py::nn_distances of the rotated
    source, whose bits the kernel's equal. For tests and the smoke run: the
    main path never calls it. Counts the launch in `field_trim.launches`."""
    if _use_plain("field_trim", source, source_mask, target, target_mask, rotations):
        return nn_distances(rotate_sources(rotations, source), source_mask, target, target_mask)
    return _field_cull("field_trim", field_trim, "distances", source, source_mask, target, target_mask, rotations,
                       scanned=scanned)


def field_sq(
    source: torch.Tensor,
    source_mask: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    rotations: torch.Tensor,
    metric: str,
    *,
    scanned: torch.Tensor | None = None,
) -> torch.Tensor:
    """The "max" or "diff" field (kss_icp_tpu/ops/nn.py:183-194): for every
    rotation, the largest squared 1-NN distance of the valid points of
    R_c · source to the valid target, or the largest distance less the mean.

    Same arguments as `field_ave`, plus the metric; `scanned` as
    `field_trim`'s. One launch of `field_trim`'s kernel, which reduces each
    rotation's row to its metric (past FIELD_MAX_POINTS source points,
    through a (C, P) scratch of the mins). Returns (C,) float32, the plain
    version's bits."""
    if metric not in SQ_PLAIN:
        raise ValueError(f"field_sq scores 'max' or 'diff', not {metric!r}")
    if _use_plain("field_sq", source, source_mask, target, target_mask, rotations):
        return SQ_PLAIN[metric](source, source_mask, target, target_mask, rotations)
    return _field_cull("field_sq", field_sq, metric, source, source_mask, target, target_mask, rotations,
                       scanned=scanned)


field_sq.launches = 0
field_sq.launch_grids = Counter()  # rotations C -> launches, counted beside `launches`


def field_sq_distances(source, source_mask, target, target_mask, rotations, *, scanned=None) -> torch.Tensor:
    """The probe mode of `field_sq`: the (C, P) squared distances (the raw
    biased min), 0 at a masked source point; on CPU tensors its plain
    version ops/nn.py::nn_sqdistances of the rotated source. Arguments as
    `field_trim_distances`. Counts the launch in `field_sq.launches`."""
    if _use_plain("field_sq", source, source_mask, target, target_mask, rotations):
        return nn_sqdistances(rotate_sources(rotations, source), source_mask, target, target_mask)
    return _field_cull("field_sq", field_sq, "sqdistances", source, source_mask, target, target_mask, rotations,
                       scanned=scanned)
