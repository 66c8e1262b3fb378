// field_ave: the "ave" rotation field of the coarse search.
//
// Replaces the Pallas TPU kernel kss_icp_tpu/ops/coarse_pallas.py::
// rotation_scores_pallas with method="vpu" (body _field_kernel_vpu). Plain
// PyTorch version: kss_icp_torch/ops/nn.py::masked_mean_nn_distance, driven by
// kss_icp_torch/ops/coarse_cuda.py::field_ave_plain.
//
// For each rotation c: sum over source points p of
//   sqrt(max(min_t ((dx*dx + dy*dy) + dz*dz) + bias_t, 0)) * w_p
// with (dx, dy, dz) = t - R_c s_p, bias 1e30 for masked target rows and w_p the
// source mask (initRegistrationKSS.hpp:430-450). The wrapper rotates the source
// (as coarse_pallas.py:148-150 does outside its kernel) and divides the sums by
// max(sum w, 1).
//
// What bounds it on an H100: float32 instruction issue. An evaluation (rotation,
// valid source point, valid target row) needs 3 sub + 3 mul + 2 add + 1 min,
// each its own instruction (-fmad=false keeps the plain version's rounding), and
// the card issues one warp instruction a clock on each of its 4 x 132
// schedulers. The main path's rows are mostly padding: register_pair pads both
// resampled clouds to 2048 rows and 378-1534 of them are valid on the remesh
// pairs, so the work is 3-56% of the padded product; the first version of this
// kernel scanned every padded row.
//
// Design (csrc/field_kernel.cuh, shared with field_dot.cu):
//   - only valid rows are scanned. A block stages the target's valid rows,
//     compacted in order by a warp ballot and a popc prefix, into shared memory
//     (2048 rows, 32 KB, a tile loop past that) and loops over their count; the
//     1e30 bias add leaves the inner loop (a valid row's bias is +0 and a masked
//     row can never be the min while one valid row exists). Groups of 256
//     masked source points write a zero partial; warps of them skip the scan. A
//     target with no valid row takes the biased path over every row, found by a
//     block-wide OR over the mask on the device;
//   - a block holds 4 rotations and walks over all source points, 256 to
//     1024 threads a step, a thread a point: one broadcast LDS.128 of a row
//     feeds 4 evaluations, 4 independent min chains, 9 + 9/16 SASS
//     instructions an evaluation (2 rotations a block, tried, was slower at
//     every main-path shape, even where 4 leaves half the card's block slots
//     empty). Since the masks are the same for
//     every rotation, every block does the same work whatever they are, and the
//     staged target serves all of the block's groups. A block a (256 points,
//     4 rotations) tile, tried first, left part of the card idle in its last
//     wave when the masks emptied some tiles (PERF.md);
//   - 64 registers a thread (32 warps an SM at any block size), no spills;
//   - the plan, group slots a block, comes from the wrapper, ops/coarse_cuda.py::
//     field_plan: as many as the source has groups of 256 points, up to 4;
//   - the sums keep their bits whatever the plan, and equal the first version of
//     this kernel's: each rotation's partial over the same 256-point groups by the
//     same shuffle tree and warp order, and a second pass that adds the partials
//     in index order. No float atomics. So a suffix-masked cloud gives the bits of
//     its valid prefix.
// The rotation stays in the wrapper (rotate_sources), a (C, P, 3) tensor in
// device memory; at a small remesh pair it costs the wrapper more device time
// than this kernel (PERF.md).

#include "field_kernel.cuh"

// rotated (C, P, 3) float32, weight (P,) float32, target (T, 3) float32,
// tmask (T,) uint8, the plan (group slots), partial (C, ceil(P/256))
// float32 scratch -> out (C,) sums.
extern "C" int kss_field_ave(const float* rotated, const float* weight, const float* target,
                             const unsigned char* tmask, int C, int P, int T, int slots, float* partial, float* out,
                             cudaStream_t stream) {
  return launch_field<kAve>(rotated, nullptr, weight, target, tmask, C, P, T, slots, partial, out, stream);
}
