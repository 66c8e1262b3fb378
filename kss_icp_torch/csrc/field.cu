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
// What bounds it on an H100: float32 instruction throughput, C * P * T distance
// evaluations (512 x 2048 x 2048 = 2.1e9 at the default config). Design: grid (P/256, C),
// one thread per rotated source point keeping a running min over target tiles
// staged in shared memory as float4 (x, y, z, bias); a fixed-order block
// reduction writes one partial per (c, block), and a second pass adds the
// partials of each rotation in index order. No float atomics, so repeated runs
// agree bit for bit. Distances round without FMA, like the plain version.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;
constexpr float kBig = 1e30f;

__global__ void __launch_bounds__(kThreads)
field_partial_kernel(const float* __restrict__ rotated, const float* __restrict__ weight,
                     const float* __restrict__ target, const unsigned char* __restrict__ tmask,
                     int P, int T, float* __restrict__ partial) {
  __shared__ float4 tile[kTile];
  __shared__ float red[kThreads / 32];
  const int c = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (p < P) {
    const float* q = rotated + (static_cast<size_t>(c) * P + p) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
  }
  float best = __int_as_float(0x7f800000);
  for (int base = 0; base < T; base += kTile) {
    const int n = min(kTile, T - base);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float* tp = target + static_cast<size_t>(base + j) * 3;
      tile[j] = make_float4(tp[0], tp[1], tp[2], tmask[base + j] ? 0.f : kBig);
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float4 t = tile[j];
      const float dx = __fsub_rn(t.x, qx);
      const float dy = __fsub_rn(t.y, qy);
      const float dz = __fsub_rn(t.z, qz);
      const float d = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)), t.w);
      best = fminf(best, d);
    }
  }
  float v = p < P ? __fmul_rn(sqrtf(fmaxf(best, 0.f)), weight[p]) : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) s = __fadd_rn(s, red[w]);
    partial[static_cast<size_t>(c) * gridDim.x + blockIdx.x] = s;
  }
}

__global__ void field_sum_kernel(const float* __restrict__ partial, int C, int nblk,
                                 float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float s = 0.f;
  for (int b = 0; b < nblk; ++b) s = __fadd_rn(s, partial[static_cast<size_t>(c) * nblk + b]);
  out[c] = s;
}

}  // namespace

// rotated (C, P, 3) float32, weight (P,) float32, target (T, 3) float32,
// tmask (T,) uint8, partial (C, ceil(P/256)) float32 scratch -> out (C,) sums.
extern "C" int kss_field_ave(const float* rotated, const float* weight, const float* target,
                             const unsigned char* tmask, int C, int P, int T, float* partial,
                             float* out, cudaStream_t stream) {
  if (C <= 0) return 0;
  if (C > 65535 || P <= 0 || T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nblk = (P + kThreads - 1) / kThreads;
  field_partial_kernel<<<dim3(nblk, C), kThreads, 0, stream>>>(rotated, weight, target, tmask,
                                                                P, T, partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  field_sum_kernel<<<(C + 255) / 256, 256, 0, stream>>>(partial, C, nblk, out);
  return static_cast<int>(cudaGetLastError());
}
