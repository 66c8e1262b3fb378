// fps: batched farthest-point sampling, one thread block per cloud.
//
// Replaces the Pallas TPU kernel kss_icp_tpu/ops/resample_pallas.py::fps_batch_pallas
// (body _fps_kernel). Plain PyTorch version: kss_icp_torch/ops/resample.py::
// farthest_point_sampling.
//
// Contract, per cloud: score_i = squared distance of valid point i to the
// masked centroid (invalid points -1). Step s picks sel = the first index of
// max(score), writes it to idx[s], and replaces (s == 0) or mins (s > 0) every
// valid score with the squared distance to point sel, fma(dz, dz, fma(dy, dy,
// dx*dx)): XLA's CPU backend contracts JAX's jitted farthest_point_sampling's
// sum of squares so, and a near-tie of a 40960-point cloud parts on it.
// Only the first `steps` picks are made; idx[steps..S) is 0. The centroid
// comes from the wrapper, computed by the same torch op as the plain version,
// so both see the same seed scores.
//
// What bounds it on an H100: the steps are sequential, and each ends in a
// block-wide (max score, lowest index) reduction and a broadcast of the picked
// point: latency, not bytes or arithmetic. Design, to shorten that chain:
//   - points in registers: each thread owns K points (x, y, z, score), point
//     tid + j * blockDim.x for j < K, with K and the thread count from the
//     wrapper's plan (ops/resample_cuda.py::fps_plan: at most 512 threads,
//     16 points a thread, which measured faster than more threads with fewer
//     points at the main path's clouds) for P <= 8192, and a
//     read-only float4 copy of xyz in shared memory from which the picked
//     point is one broadcast load. Wider clouds keep float4 (x, y, z, score)
//     in shared memory (P <= 12800) or in a global workspace that stays in
//     L2 (the K = 0 path);
//   - a step costs a thread, per point, the distance (6 operations), one
//     fminf (an invalid point's -1 stays below any distance, so no branch)
//     and a strict '>' against its running best (the first index stays);
//   - an argmax without shuffle chains: a valid score s >= 0 maps to the
//     monotone key bits(s) + 1, an invalid point to 0, so a warp reduces with
//     __reduce_max_sync on the key and __reduce_min_sync on the index among
//     the lanes holding the max;
//   - across warps, one __syncthreads a step: each warp writes its (key,
//     index) to a slot double-buffered by the round's parity, and every warp
//     reduces all slots itself (no second barrier, no broadcast);
//   - after the seed pick, valid scores become +inf, so every step is a min.
// The large-scan path (kss_icp_torch/largescan.py) runs the K = 0 path at
// B = 2 and P up to 151552 (the wrapper takes P <= 2^18): one block a cloud,
// so two SMs work, each thread walking about 300 float4 a step in the
// workspace (2 x 151552 x 16 B = 4.8 MB, in L2) over ~2000 dependent steps.
// Measured there at about 62 us a step, some 400 cycles a point a thread
// (PERF.md): the loop stores to the buffer it loads from, so its L2 loads go
// out about one at a time and latency, not bytes, sets the time. Every index
// fits an int: the largest, 3 * P, is below 2^20; per-cloud offsets are size_t.
// Distances round as two explicit fused multiply-adds over a rounded dx*dx
// (__fmaf_rn and __f*_rn; -fmad=false contracts nothing else), so picks equal
// the plain version's.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxSmemPoints = 12800;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;

__device__ __forceinline__ float sqdist(float ax, float ay, float az, float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
}

// Valid scores are >= 0 (or +inf before the first update); invalid ones -1,
// and a thread with no point holds -inf.
__device__ __forceinline__ unsigned score_key(float w) {
  return w >= 0.f ? __float_as_uint(w) + 1u : 0u;
}

// The block's (max key, lowest index) over every thread's (key, idx), in
// every thread. One barrier; `round` picks the slot buffer.
__device__ __forceinline__ int block_pick(unsigned key, unsigned idx, uint2 (*slot)[kMaxWarps], int round) {
  const int lane = threadIdx.x & 31;
  const int buf = round & 1;
  const unsigned wkey = __reduce_max_sync(kFull, key);
  const unsigned widx = __reduce_min_sync(kFull, key == wkey ? idx : kNone);
  if (lane == 0) slot[buf][threadIdx.x >> 5] = make_uint2(wkey, widx);
  __syncthreads();
  const uint2 v = lane < static_cast<int>((blockDim.x + 31) >> 5) ? slot[buf][lane] : make_uint2(0u, kNone);
  const unsigned bkey = __reduce_max_sync(kFull, v.x);
  return static_cast<int>(__reduce_min_sync(kFull, v.x == bkey ? v.y : kNone));
}

// K > 0: K points a thread in registers, xyz copied to shared memory.
// K == 0: float4 points and scores in `buf` (shared memory or the workspace).
template <int K>
__global__ void __launch_bounds__(kMaxThreads)
fps_kernel(const float* __restrict__ points, const unsigned char* __restrict__ mask,
           const float* __restrict__ centroid, int P, int S, int steps, float4* __restrict__ work,
           int use_smem, int* __restrict__ idx_out) {
  extern __shared__ float4 smem[];
  __shared__ uint2 slot[2][kMaxWarps];
  const int b = blockIdx.x;
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const float* pts = points + static_cast<size_t>(b) * P * 3;
  const unsigned char* m = mask + static_cast<size_t>(b) * P;
  int* out = idx_out + static_cast<size_t>(b) * S;
  for (int s = steps + tid; s < S; s += T) out[s] = 0;
  if (steps <= 0) return;
  const float cx = centroid[b * 3 + 0];
  const float cy = centroid[b * 3 + 1];
  const float cz = centroid[b * 3 + 2];
  const float inf = __int_as_float(0x7f800000);

  float x[K > 0 ? K : 1], y[K > 0 ? K : 1], z[K > 0 ? K : 1], w[K > 0 ? K : 1];
  float4* buf = (K > 0 || use_smem) ? smem : work + static_cast<size_t>(b) * P;
  float bw = -inf;  // a strict '>' keeps the first of equal scores
  unsigned bi = kNone;
  if (K > 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int i = tid + j * T;
      x[j] = y[j] = z[j] = 0.f;
      w[j] = -1.f;
      if (i < P) {
        x[j] = pts[3 * i + 0];
        y[j] = pts[3 * i + 1];
        z[j] = pts[3 * i + 2];
        buf[i] = make_float4(x[j], y[j], z[j], 0.f);
        if (m[i]) w[j] = sqdist(x[j], y[j], z[j], cx, cy, cz);
      }
      if (w[j] > bw) {
        bw = w[j];
        bi = i;
      }
      if (w[j] >= 0.f) w[j] = inf;  // the first update replaces the seed score
    }
  } else {
    for (int i = tid; i < P; i += T) {
      const float px = pts[3 * i + 0], py = pts[3 * i + 1], pz = pts[3 * i + 2];
      const float s = m[i] ? sqdist(px, py, pz, cx, cy, cz) : -1.f;
      buf[i] = make_float4(px, py, pz, s >= 0.f ? inf : s);
      if (s > bw) {
        bw = s;
        bi = i;
      }
    }
  }
  int sel = block_pick(score_key(bw), bi, slot, 0);

  for (int s = 0;; ++s) {
    if (tid == 0) out[s] = sel;
    if (s + 1 >= steps) break;
    // x, y, z of the picked point are never written again (its owner may be
    // writing .w on the K == 0 path).
    const float px = buf[sel].x, py = buf[sel].y, pz = buf[sel].z;
    bw = -inf;
    bi = kNone;
    if (K > 0) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        w[j] = fminf(w[j], sqdist(x[j], y[j], z[j], px, py, pz));
        if (w[j] > bw) {
          bw = w[j];
          bi = tid + j * T;
        }
      }
    } else {
      for (int i = tid; i < P; i += T) {
        const float4 v = buf[i];
        const float nw = fminf(v.w, sqdist(v.x, v.y, v.z, px, py, pz));
        buf[i].w = nw;
        if (nw > bw) {
          bw = nw;
          bi = i;
        }
      }
    }
    sel = block_pick(score_key(bw), bi, slot, s + 1);
  }
}

template <int K>
cudaError_t launch(const float* points, const unsigned char* mask, const float* centroid, int B, int P,
                   int S, int steps, int threads, float4* work, int* idx_out, cudaStream_t stream) {
  const int use_smem = K > 0 || P <= kMaxSmemPoints;
  const size_t smem = use_smem ? static_cast<size_t>(P) * sizeof(float4) : 0;
  if (use_smem) {
    const cudaError_t e = cudaFuncSetAttribute(fps_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  fps_kernel<K><<<B, threads, smem, stream>>>(points, mask, centroid, P, S, steps, work, use_smem, idx_out);
  return cudaGetLastError();
}

}  // namespace

// points (B, P, 3) float32, mask (B, P) uint8, centroid (B, 3) float32,
// work (B, P, 4) float32 scratch (read only when k == 0 and P > 12800) ->
// idx (B, S) int32, the first `steps` picks and zeros after them. The plan
// (k points a thread in registers, 0 for the shared/global path; threads a
// block) is ops/resample_cuda.py::fps_plan's; k * threads must cover P.
extern "C" int kss_fps(const float* points, const unsigned char* mask, const float* centroid, int B, int P,
                       int S, int steps, int k, int threads, float* work, int* idx_out, cudaStream_t stream) {
  if (B <= 0 || S <= 0) return 0;
  if (P <= 0 || steps < 0 || steps > S || threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      (k > 0 && static_cast<long long>(k) * threads < P))
    return static_cast<int>(cudaErrorInvalidValue);
  float4* w4 = reinterpret_cast<float4*>(work);
  switch (k) {
    case 0: return static_cast<int>(launch<0>(points, mask, centroid, B, P, S, steps, threads, w4, idx_out, stream));
    case 1: return static_cast<int>(launch<1>(points, mask, centroid, B, P, S, steps, threads, w4, idx_out, stream));
    case 2: return static_cast<int>(launch<2>(points, mask, centroid, B, P, S, steps, threads, w4, idx_out, stream));
    case 4: return static_cast<int>(launch<4>(points, mask, centroid, B, P, S, steps, threads, w4, idx_out, stream));
    case 8: return static_cast<int>(launch<8>(points, mask, centroid, B, P, S, steps, threads, w4, idx_out, stream));
    case 16: return static_cast<int>(launch<16>(points, mask, centroid, B, P, S, steps, threads, w4, idx_out, stream));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
