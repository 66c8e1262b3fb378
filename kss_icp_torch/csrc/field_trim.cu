// field_trim: the per-point distances of the overlap tier's trimmed rotation field;
// field_sq: the squared per-point distances of the "max" and "diff" fields.
//
// Not a TPU kernel: JAX scores error_metric="trim" with XLA
// (kss_icp_tpu/models/coarse.py:115-131 through ops/nn.py:195-198), since its
// Pallas field does only "ave". Plain PyTorch version:
// kss_icp_torch/ops/nn.py::nn_distances of the rotated source (the field:
// kss_icp_torch/ops/coarse_cuda.py::field_trim_plain).
//
// For each rotation c and source point p: sqrt(max(min_t ((dx*dx + dy*dy) + dz*dz)
// + bias_t, 0)) with (dx, dy, dz) = t - R_c s_p, 0 where the source mask is
// false, written to dist[c, p]. The wrapper (ops/coarse_cuda.py::field_trim)
// rotates the source and takes the trimmed mean of each row in PyTorch: a
// stable sort and a cumulative sum read at rank ceil(q * n_valid).
//
// Design: field_ave's kernel (csrc/field_kernel.cuh, design note in field.cu)
// in its per-point mode. The scan is the same: the valid target rows staged
// compacted in shared memory, 4 rotations a block, a thread a source point,
// the biased path over every row for a target with no valid row. Each thread
// writes its point's 4 values, one a rotation row of dist, and the shuffle
// tree and second pass are skipped. The min is exact, so dist equals the
// plain version bit for bit. The overlap configs score the field at full
// resolution (coarse_points = 0): 4096 x 2048 rows on the 16^3 grid, 33.5 MB
// of dist.
//
// Why a kernel and not the plain version: the plain field is a (C, P, T)
// scan in chunks, about 67 ms for 512 x 2048 x 2048 on an H100 and about
// 8 x that on the 16^3 grid; each overlap field rung runs 3 fields.

#include "field_kernel.cuh"

// rotated (C, P, 3) float32, weight (P,) float32, target (T, 3) float32,
// tmask (T,) uint8, the plan (group slots) -> dist (C, P) float32.
extern "C" int kss_field_trim(const float* rotated, const float* weight, const float* target,
                              const unsigned char* tmask, int C, int P, int T, int slots, float* dist,
                              cudaStream_t stream) {
  return launch_field_points<kAve>(rotated, weight, target, tmask, C, P, T, slots, dist, stream);
}

// field_sq: the same scan, each (rotation, point)'s min ((dx*dx + dy*dy) + dz*dz) [+ 1e30 on the
// biased path] written as it is, 0 at a masked source point. JAX scores error_metric "max" and
// "diff" with XLA too (kss_icp_tpu/ops/nn.py:183-194): the largest squared distance (the
// reference never takes the root there), and the largest distance less the mean. Plain version:
// kss_icp_torch/ops/nn.py::nn_sqdistances; the wrapper (ops/coarse_cuda.py::field_sq) reduces each
// row to its metric in PyTorch. Bound and design as field_trim's: the same kernel and plan.
extern "C" int kss_field_sq(const float* rotated, const float* weight, const float* target,
                            const unsigned char* tmask, int C, int P, int T, int slots, float* dist,
                            cudaStream_t stream) {
  return launch_field_points<kAve, true>(rotated, weight, target, tmask, C, P, T, slots, dist, stream);
}
