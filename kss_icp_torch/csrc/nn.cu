// nn1: exact-float32 1-nearest-neighbour over batched lanes.
//
// Replaces two Pallas TPU kernels of the same contract:
//   kss_icp_tpu/ops/nn_pallas.py::nearest_neighbor_vpu    (K3, ICP correspondences)
//   kss_icp_tpu/ops/nn_pallas.py::nearest_neighbor_pallas (K4, full-resolution metric)
// Plain PyTorch version: kss_icp_torch/ops/nn.py::nearest_neighbor.
//
// For every query of lane l, the min over valid rows r of reference cloud
// g = lane_ref[l] of ((dx*dx + dy*dy) + dz*dz) + bias (bias 0 for a valid row,
// 1e30 for a masked one), and the FIRST index that attains it. Output d2 is
// 1e30 where the min is >= 5e29 (fully masked reference), else max(min, 0);
// the index is clipped to [0, R-1] (nn_pallas.py:138-141).
//
// What bounds it on an H100: float32 instruction throughput. Each (query,
// reference) pair costs 3 sub + 3 mul + 3 add + compare/select, with no FMA
// (built with -fmad=false and written with __f*_rn) so the rounding equals the
// plain version's and argmins agree. Design: one thread per query, keeping a running (min, argmin)
// with a strict '<' so ties go to the first index; reference tiles are staged
// in shared memory as float4 (x, y, z, bias) and read by all threads of the
// block as broadcasts, so device-memory traffic is O(Q + R * Q / 256). The
// same kernel serves the ICP launch shape (lanes x 512..2048 queries against a
// 2048-point target) and the metric's (one lane, up to 10^5 x 10^5).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;
constexpr float kBig = 1e30f;

__global__ void __launch_bounds__(kThreads)
nn1_kernel(const float* __restrict__ query, const float* __restrict__ ref,
           const unsigned char* __restrict__ mask, const int* __restrict__ lane_ref,
           int Q, int G, int R, float* __restrict__ d2_out, int* __restrict__ idx_out) {
  __shared__ float4 tile[kTile];
  const int lane = blockIdx.y;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const size_t out = static_cast<size_t>(lane) * Q + q;
  const int g = lane_ref[lane];
  if (g < 0 || g >= G) {  // uniform over the block: no barrier is skipped by part of it
    if (q < Q) {
      d2_out[out] = __int_as_float(0x7fc00000);
      idx_out[out] = -1;
    }
    return;
  }
  const float* rbase = ref + static_cast<size_t>(g) * R * 3;
  const unsigned char* mbase = mask + static_cast<size_t>(g) * R;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (q < Q) {
    qx = query[out * 3 + 0];
    qy = query[out * 3 + 1];
    qz = query[out * 3 + 2];
  }
  float best = __int_as_float(0x7f800000);  // +inf
  int best_i = 0;
  for (int base = 0; base < R; base += kTile) {
    const int n = min(kTile, R - base);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float* rp = rbase + static_cast<size_t>(base + j) * 3;
      tile[j] = make_float4(rp[0], rp[1], rp[2], mbase[base + j] ? 0.f : kBig);
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float4 t = tile[j];
      const float dx = __fsub_rn(qx, t.x);
      const float dy = __fsub_rn(qy, t.y);
      const float dz = __fsub_rn(qz, t.z);
      const float d = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)), t.w);
      if (d < best) {
        best = d;
        best_i = base + j;
      }
    }
  }
  if (q < Q) {
    d2_out[out] = best >= 0.5f * kBig ? kBig : fmaxf(best, 0.f);
    idx_out[out] = min(max(best_i, 0), R - 1);
  }
}

}  // namespace

// query (L, Q, 3), ref (G, R, 3), mask (G, R) uint8, lane_ref (L,) int32 ->
// d2 (L, Q) float32, idx (L, Q) int32. A lane_ref outside [0, G) yields NaN / -1.
extern "C" int kss_nn1(const float* query, const float* ref, const unsigned char* mask,
                       const int* lane_ref, int L, int Q, int G, int R, float* d2_out,
                       int* idx_out, cudaStream_t stream) {
  if (L <= 0 || Q <= 0) return 0;
  if (L > 65535 || R <= 0 || G <= 0) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((Q + kThreads - 1) / kThreads, L);
  nn1_kernel<<<grid, kThreads, 0, stream>>>(query, ref, mask, lane_ref, Q, G, R, d2_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
