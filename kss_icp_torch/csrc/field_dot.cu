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
// What bounds it on an H100: arithmetic. C * P * T evaluations (512 x 2048 x
// 2048 = 2.1e9 on the base grid, 4096 x 512 x 512 = 1.1e9 on the escalation
// grid). At "highest" the function needs 3 mul + 3 add + 1 min = 7 float32
// operations each, 2.1e9 * 7 / 67e12 = 0.22 ms at the base grid. At "default"
// the products are a K=4 bf16 matrix product, which tensor cores would do in
// under 0.02 ms, leaving the float32 min: 2.1e9 / 67e12 = 0.03 ms. This kernel
// spends 7 float32 instructions an evaluation at either precision (no FMA, so
// rel rounds as in the plain version), so it sits well above both bounds;
// chip_smoke.py measures it against them. Design: as field.cu, grid
// (P/256, C), one thread per rotated source point keeping a running min over
// target tiles staged in shared memory as float4 (-2x, -2y, -2z, |t|^2 | big),
// read by every thread as a broadcast; a fixed-order block reduction writes
// one partial per (c, block) and a second pass adds the partials of each
// rotation in index order. No float atomics, so repeated runs agree bit for
// bit. No tensor cores and no TF32: a wgmma version of the bf16 path is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
field_dot_partial_kernel(const float* __restrict__ rotated, const float* __restrict__ q2,
                         const float* __restrict__ weight, const float4* __restrict__ ra, int P,
                         int T, float* __restrict__ partial) {
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
    if (kBf16) {
      qx = round_bf16(qx);
      qy = round_bf16(qy);
      qz = round_bf16(qz);
    }
  }
  float best = __int_as_float(0x7f800000);
  for (int base = 0; base < T; base += kTile) {
    const int n = min(kTile, T - base);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kThreads) {
      float4 a = ra[base + j];
      if (kBf16) a = make_float4(round_bf16(a.x), round_bf16(a.y), round_bf16(a.z), round_bf16(a.w));
      tile[j] = a;
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float4 a = tile[j];
      const float rel = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(qx, a.x), __fmul_rn(qy, a.y)), __fmul_rn(qz, a.z)), a.w);
      best = fminf(best, rel);
    }
  }
  float v = p < P ? __fmul_rn(sqrtf(fmaxf(__fadd_rn(best, q2[p]), 0.f)), weight[p]) : 0.f;
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

__global__ void field_dot_sum_kernel(const float* __restrict__ partial, int C, int nblk,
                                     float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float s = 0.f;
  for (int b = 0; b < nblk; ++b) s = __fadd_rn(s, partial[static_cast<size_t>(c) * nblk + b]);
  out[c] = s;
}

}  // namespace

// rotated (C, P, 3) float32, q2 (P,) float32, weight (P,) float32, ra (T, 4)
// float32 (16-byte aligned rows), bf16 0 or 1, partial (C, ceil(P/256))
// float32 scratch -> out (C,) sums.
extern "C" int kss_field_dot(const float* rotated, const float* q2, const float* weight,
                             const float* ra, int C, int P, int T, int bf16, float* partial,
                             float* out, cudaStream_t stream) {
  if (C <= 0) return 0;
  if (C > 65535 || P <= 0 || T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<size_t>(ra) % alignof(float4) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int nblk = (P + kThreads - 1) / kThreads;
  const dim3 grid(nblk, C);
  const float4* ra4 = reinterpret_cast<const float4*>(ra);
  if (bf16) {
    field_dot_partial_kernel<true><<<grid, kThreads, 0, stream>>>(rotated, q2, weight, ra4, P, T,
                                                                  partial);
  } else {
    field_dot_partial_kernel<false><<<grid, kThreads, 0, stream>>>(rotated, q2, weight, ra4, P, T,
                                                                   partial);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  field_dot_sum_kernel<<<(C + 255) / 256, 256, 0, stream>>>(partial, C, nblk, out);
  return static_cast<int>(cudaGetLastError());
}
