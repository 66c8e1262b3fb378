// fps: batched farthest-point sampling, one thread block per cloud.
//
// Replaces the Pallas TPU kernel kss_icp_tpu/ops/resample_pallas.py::fps_batch_pallas
// (body _fps_kernel). Plain PyTorch version: kss_icp_torch/ops/resample.py::
// farthest_point_sampling.
//
// Contract, per cloud: score_i = squared distance of valid point i to the
// masked centroid (invalid points -1). Step s picks sel = the first index of
// max(score), writes it to idx[s], and replaces (s == 0) or mins (s > 0) every
// valid score with the squared distance to point sel, ((dx*dx + dy*dy) + dz*dz).
// The centroid comes from the wrapper, computed by the same torch op as the
// plain version, so both see the same seed scores.
//
// What bounds it on an H100: the S steps are sequential, and each ends in a
// block-wide (max value, lowest index) reduction and a broadcast of the picked
// point — latency, not bandwidth or arithmetic. Design: all B clouds in one
// launch (one block each); the update of step s and the local argmax of step
// s + 1 share one pass over the points; the points and running scores live as
// float4 (x, y, z, score) in shared memory when P * 16 bytes fits (P <= 12800),
// otherwise in a global workspace that stays in L2. Distances round without FMA
// (-fmad=false and __f*_rn), so picks equal the plain version's.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmemPoints = 12800;

struct Pick {
  float v;
  int i;
};

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Block-wide argmax with the lowest index winning ties; every thread gets it.
__device__ int block_argmax(float bv, int bi, Pick* red, int* sel_sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) red[warp] = Pick{bv, bi};
  __syncthreads();
  if (warp == 0) {
    bv = red[lane].v;  // kWarps == 32
    bi = red[lane].i;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) *sel_sh = bi;
  }
  __syncthreads();
  return *sel_sh;
}

__device__ __forceinline__ float sqdist(float ax, float ay, float az, float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ points, const unsigned char* __restrict__ mask,
           const float* __restrict__ centroid, int P, int S, float4* __restrict__ work,
           int use_smem, int* __restrict__ idx_out) {
  extern __shared__ float4 smem[];
  __shared__ Pick red[kWarps];
  __shared__ int sel_sh;
  const int b = blockIdx.x;
  float4* buf = use_smem ? smem : work + static_cast<size_t>(b) * P;
  const float* pts = points + static_cast<size_t>(b) * P * 3;
  const unsigned char* m = mask + static_cast<size_t>(b) * P;
  const float cx = centroid[b * 3 + 0];
  const float cy = centroid[b * 3 + 1];
  const float cz = centroid[b * 3 + 2];

  float bv = -__int_as_float(0x7f800000);
  int bi = 0x7fffffff;
  for (int i = threadIdx.x; i < P; i += kThreads) {
    const float x = pts[3 * i + 0], y = pts[3 * i + 1], z = pts[3 * i + 2];
    const float w = m[i] ? sqdist(x, y, z, cx, cy, cz) : -1.f;
    buf[i] = make_float4(x, y, z, w);
    if (w > bv) {
      bv = w;
      bi = i;
    }
  }
  int sel = block_argmax(bv, bi, red, &sel_sh);
  int* out = idx_out + static_cast<size_t>(b) * S;
  for (int s = 0; s < S; ++s) {
    if (threadIdx.x == 0) out[s] = sel;
    if (s + 1 == S) break;
    // Only x, y, z of the picked point are read; its owner may be writing .w.
    const float px = buf[sel].x, py = buf[sel].y, pz = buf[sel].z;
    bv = -__int_as_float(0x7f800000);
    bi = 0x7fffffff;
    for (int i = threadIdx.x; i < P; i += kThreads) {
      float w = buf[i].w;
      if (w >= 0.f) {  // valid points score >= 0, invalid ones -1 for good
        const float d = sqdist(buf[i].x, buf[i].y, buf[i].z, px, py, pz);
        w = s == 0 ? d : fminf(w, d);
        buf[i].w = w;
      }
      if (w > bv) {
        bv = w;
        bi = i;
      }
    }
    sel = block_argmax(bv, bi, red, &sel_sh);
  }
}

}  // namespace

// points (B, P, 3) float32, mask (B, P) uint8, centroid (B, 3) float32,
// work (B, P, 4) float32 scratch (used when P > 12800) -> idx (B, S) int32.
extern "C" int kss_fps(const float* points, const unsigned char* mask, const float* centroid,
                       int B, int P, int S, float* work, int* idx_out, cudaStream_t stream) {
  if (B <= 0 || S <= 0) return 0;
  if (P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int use_smem = P <= kMaxSmemPoints;
  const size_t smem = use_smem ? static_cast<size_t>(P) * sizeof(float4) : 0;
  if (use_smem) {
    const cudaError_t e = cudaFuncSetAttribute(
        fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fps_kernel<<<B, kThreads, smem, stream>>>(points, mask, centroid, P, S,
                                            reinterpret_cast<float4*>(work), use_smem, idx_out);
  return static_cast<int>(cudaGetLastError());
}
