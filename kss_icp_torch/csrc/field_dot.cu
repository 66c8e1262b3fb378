// field_dot: the "ave" rotation field through the augmented dot product.
//
// Replaces the Pallas TPU kernel kss_icp_tpu/ops/coarse_pallas.py::
// rotation_scores_pallas with method="dot" (body _field_kernel), the
// coarse_method="dot" field. Plain PyTorch version: kss_icp_torch/ops/
// coarse_cuda.py::field_dot_plain.
//
// For each rotation c: sum over source points p of
//   sqrt(max(min_t rel(p, t) + q2_p, 0)) * w_p,
//   rel(p, t) = ((qx*ax + qy*ay) + qz*az) + aw
// with (qx, qy, qz) = R_c s_p, a_t = (-2 t m_t, |t|^2 or 1e30 for a masked
// row), q2_p = |s_p|^2 of the unrotated source and w_p the source mask. The
// TPU kernel forms rel as the K=4 product [R q, 1] . a on its matrix unit;
// here every term rounds on its own in the order above, as in the plain
// version, so kernel and plain agree bit for bit on every rel. With bf16 set
// (precision "default", one bf16 pass on the TPU), q and a are rounded to
// bf16 first; a bf16 x bf16 product is exact in float32, so the sums alone
// round. The wrapper rotates the source and builds a and q2 (as
// coarse_pallas.py:147-166 does outside its kernel) and divides the sums by
// max(sum w, 1).
//
// What bounds it on an H100: arithmetic, on the valid rows. At "highest" the
// function needs 3 mul + 3 add + 1 min = 7 float32 operations an evaluation
// (rotation, valid source point, valid target row), 0.22 ms at 512 x 2048 x 2048
// with every row valid over 67e12/s; at "default" the products are a K=4 bf16
// matrix product that tensor cores would do in under 0.02 ms, leaving the
// float32 min. This kernel spends 7 float32 instructions an evaluation at either
// precision (no FMA, so rel rounds as in the plain version), one warp
// instruction a clock on each of 4 x 132 schedulers. No tensor cores and no
// TF32: a wgmma version of the bf16 path is later work (ROADMAP queue 2); its
// sums could not be bit-equal to the plain version's.
//
// Design: the kernel of field.cu (csrc/field_kernel.cuh), staging the rows of
// ra instead of the target's coordinates. Only the valid rows of ra are
// staged, compacted by a warp ballot and a popc prefix (a masked row's rel is
// exactly 1e30, never the min while one valid row exists; a target with no
// valid row scans every row, as the plain version does); groups and warps of
// masked source points skip the scan; a block holds 4 rotations and walks
// over every source point, so blocks do equal work whatever the masks (one
// broadcast LDS.128 of a row feeds 4 evaluations: 7 + 9/16 SASS instructions
// an evaluation, either precision); the plan, group slots a block, comes from
// ops/coarse_cuda.py::field_plan. The sums keep the first version's bits at
// every plan and precision (the same 256-point groups, shuffle tree and warp
// order, partials added in index order, no float atomics).

#include "field_kernel.cuh"

// rotated (C, P, 3) float32, q2 (P,) float32, weight (P,) float32, ra (T, 4)
// float32 (16-byte aligned rows), tmask (T,) uint8, bf16 0 or 1, the plan
// (group slots), partial (C, ceil(P/256)) float32 scratch -> out (C,) sums.
extern "C" int kss_field_dot(const float* rotated, const float* q2, const float* weight, const float* ra,
                             const unsigned char* tmask, int C, int P, int T, int bf16, int slots, float* partial,
                             float* out, cudaStream_t stream) {
  if (reinterpret_cast<size_t>(ra) % alignof(float4) != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  if (bf16) return launch_field<kDotBf16>(rotated, q2, weight, ra, tmask, C, P, T, slots, partial, out, stream);
  return launch_field<kDot>(rotated, q2, weight, ra, tmask, C, P, T, slots, partial, out, stream);
}
