// The one kernel behind the rotation fields: field_ave (field.cu, K1),
// field_dot (field_dot.cu, K1-dot) and, in its per-point mode, field_trim and
// field_sq (field_trim.cu). Each .cu file includes this header, instantiates it for
// its field and carries the design note.
//
// For each rotation c: the sum over valid source points p of
//   sqrt(max(min over target rows t of e(p, t) [+ q2_p], 0)) * w_p
// e(p, t) = ((dx*dx + dy*dy) + dz*dz) with (dx, dy, dz) = t - R_c s_p for
// field_ave; ((qx*ax + qy*ay) + qz*az) + aw with q = R_c s_p and the
// augmented row a for field_dot (+ q2_p, the unrotated |s_p|^2). Every term
// rounds on its own, in the plain versions' order (-fmad=false, __f*_rn).
//
// The min runs over the valid target rows only, staged compacted; a target
// with no valid row takes the biased path of the plain version (every row,
// + 1e30 for field_ave, the 1e30 row of ra for field_dot). Groups of masked
// source points write a zero partial, warps of them skip the scan; their
// contribution is +0, as sqrt(finite) * 0 was. The sum of each rotation keeps
// its bits at any plan: the same 256-point groups, the same shuffle tree and
// warp order, then a second pass over the groups in index order.
//
// The per-point mode (kPerPoint) writes each (rotation, point)'s
// sqrt(max(min, 0)) to a (C, P) buffer instead, 0 at a masked source point,
// and skips the shuffle tree and the second pass; with kSquared it writes the
// min itself, the squared distance (biased by 1e30 for a target with no valid
// row, as the plain version's).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {  // internal linkage: each .cu file keeps its own copy

enum FieldMode { kAve, kDot, kDotBf16 };

constexpr int kQ = 4;  // rotations a block: one staged row feeds kQ evaluations a thread
constexpr int kGroup = 256;  // source points a partial sum: 8 warps
constexpr int kGroupWarps = kGroup / 32;
constexpr int kMaxSlots = 4;  // groups a block scans at once: up to 1024 threads
constexpr int kMaxThreads = kMaxSlots * kGroup;
constexpr int kTile = 2048;  // target rows staged at once (32 KB): the main path's whole padded target
constexpr float kBig = 1e30f;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Target row r as staged: (x, y, z, -) for field_ave; the augmented row
// (-2x m, -2y m, -2z m, |t|^2 or 1e30) for field_dot, in bf16 at kDotBf16.
template <int kMode>
__device__ __forceinline__ float4 load_row(const float* __restrict__ target, int r) {
  if constexpr (kMode == kAve) {
    const float* t = target + static_cast<size_t>(r) * 3;
    return make_float4(t[0], t[1], t[2], 0.f);
  } else {
    float4 a = reinterpret_cast<const float4*>(target)[r];
    if constexpr (kMode == kDotBf16)
      a = make_float4(round_bf16(a.x), round_bf16(a.y), round_bf16(a.z), round_bf16(a.w));
    return a;
  }
}

// e(p, t) of one rotated point and one staged row; kBiased adds field_ave's 1e30.
template <int kMode, bool kBiased>
__device__ __forceinline__ float row_value(float4 t, float qx, float qy, float qz) {
  if constexpr (kMode == kAve) {
    const float dx = __fsub_rn(t.x, qx);
    const float dy = __fsub_rn(t.y, qy);
    const float dz = __fsub_rn(t.z, qz);
    const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
    return kBiased ? __fadd_rn(d, kBig) : d;
  } else {
    return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(qx, t.x), __fmul_rn(qy, t.y)), __fmul_rn(qz, t.z)), t.w);
  }
}

// The inner loop: one broadcast LDS.128 of a row serves kQ rotations, kQ
// independent min chains.
template <int kMode, bool kBiased>
__device__ __forceinline__ void scan_rows(const float4* tile, int m, const float (&qx)[kQ], const float (&qy)[kQ],
                                          const float (&qz)[kQ], float (&best)[kQ]) {
#pragma unroll 4
  for (int j = 0; j < m; ++j) {
    const float4 t = tile[j];
#pragma unroll
    for (int u = 0; u < kQ; ++u) best[u] = fminf(best[u], row_value<kMode, kBiased>(t, qx[u], qy[u], qz[u]));
  }
}

// Stages rows [base, base + n) of the target into tile, in order, and returns
// their count: only the valid ones, compacted by a warp ballot and a popc
// prefix (each warp its own run of rows; one barrier shares the runs'
// counts), or every row on the biased path. Ends with a barrier.
template <int kMode>
__device__ __forceinline__ int stage_rows(const float* __restrict__ target, const unsigned char* __restrict__ tmask,
                                          int base, int n, bool biased, float4* tile, int* run_count) {
  if (biased) {
    for (int j = threadIdx.x; j < n; j += blockDim.x) tile[j] = load_row<kMode>(target, base + j);
    __syncthreads();
    return n;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int run = (n + blockDim.x - 1) / blockDim.x * 32;  // rows a warp, whole ballots
  const int lo = min(n, warp * run), hi = min(n, lo + run);
  int count = 0;
  for (int j = lo; j < hi; j += 32) count += __popc(__ballot_sync(0xffffffffu, j + lane < hi && tmask[base + j + lane]));
  if (lane == 0) run_count[warp] = count;
  __syncthreads();
  int off = 0, total = 0;
  for (int w = 0; w < warps; ++w) {
    off += w < warp ? run_count[w] : 0;
    total += run_count[w];
  }
  const unsigned below = (1u << lane) - 1u;
  for (int j = lo; j < hi; j += 32) {
    const bool v = j + lane < hi && tmask[base + j + lane];
    const unsigned b = __ballot_sync(0xffffffffu, v);
    if (v) tile[off + __popc(b & below)] = load_row<kMode>(target, base + j + lane);
    off += __popc(b);
  }
  __syncthreads();
  return total;
}

// Grid ceil(C / kQ): a block holds kQ rotations and walks over the source in
// steps of blockDim / 256 groups of 256 points, a thread a point. Where the
// target fits one tile, the block stages it once for every group. Every
// block does the same work, whatever the masks, since the masks are the same
// for every rotation. At most 64 registers: 32 warps an SM at any block size.
// kPerPoint: partial is the (C, P) per-point output; kSquared: the min, not its root.
template <int kMode, bool kPerPoint = false, bool kSquared = false>
__global__ void __launch_bounds__(kMaxThreads, 1)
field_partial_kernel(const float* __restrict__ rotated, const float* __restrict__ q2,
                     const float* __restrict__ weight, const float* __restrict__ target,
                     const unsigned char* __restrict__ tmask, int C, int P, int T,
                     float* __restrict__ partial) {
  __shared__ float4 tile[kTile];
  __shared__ float red[kMaxSlots][kQ][kGroupWarps];
  __shared__ int run_count[kMaxThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31;
  const int slot = tid / kGroup, gwarp = (tid % kGroup) >> 5;  // group slot of the block, warp in the group
  const int slots = blockDim.x / kGroup;
  const int groups = (P + kGroup - 1) / kGroup;
  const int c0 = static_cast<int>(blockIdx.x) * kQ;
  int any = 0;
  for (int r = tid; r < T; r += blockDim.x) any |= tmask[r];
  const bool biased = !__syncthreads_or(any);  // no valid target row at all

  const bool keep = T <= kTile;  // one staging serves every group
  const int m_kept = keep ? stage_rows<kMode>(target, tmask, 0, T, biased, tile, run_count) : 0;

  for (int g0 = 0; g0 < groups; g0 += slots) {
    const int p = (g0 + slot) * kGroup + tid % kGroup;
    const float w = p < P ? weight[p] : 0.f;
    const bool valid = w != 0.f;
    // Thread (s, u) of the first slots * kQ writes group g0 + s's partial of rotation c0 + u.
    const int ws = tid / kQ, wu = tid % kQ;
    const bool writer = tid < slots * kQ && g0 + ws < groups && c0 + wu < C;
    float* out = partial + static_cast<size_t>(c0 + wu) * groups + g0 + ws;
    if (!__syncthreads_or(valid)) {  // a group of masked points
      if constexpr (kPerPoint) {
#pragma unroll
        for (int u = 0; u < kQ; ++u)
          if (p < P && c0 + u < C) partial[static_cast<size_t>(c0 + u) * P + p] = 0.f;
      } else if (writer) {
        *out = 0.f;
      }
      continue;
    }
    float qx[kQ], qy[kQ], qz[kQ], best[kQ];
#pragma unroll
    for (int u = 0; u < kQ; ++u) {
      qx[u] = qy[u] = qz[u] = 0.f;
      best[u] = __int_as_float(0x7f800000);  // +inf
      if (valid && c0 + u < C) {
        const float* q = rotated + (static_cast<size_t>(c0 + u) * P + p) * 3;
        qx[u] = q[0];
        qy[u] = q[1];
        qz[u] = q[2];
        if constexpr (kMode == kDotBf16) {
          qx[u] = round_bf16(qx[u]);
          qy[u] = round_bf16(qy[u]);
          qz[u] = round_bf16(qz[u]);
        }
      }
    }
    const bool active = __any_sync(0xffffffffu, valid);  // a warp of masked points skips the scan
    for (int base = 0; base < T; base += kTile) {
      int m = m_kept;
      if (!keep) {
        __syncthreads();  // every warp is done with the last tile
        m = stage_rows<kMode>(target, tmask, base, min(kTile, T - base), biased, tile, run_count);
      }
      if (!active) continue;
      if (biased)
        scan_rows<kMode, (kMode == kAve)>(tile, m, qx, qy, qz, best);
      else
        scan_rows<kMode, false>(tile, m, qx, qy, qz, best);
    }

    if constexpr (kPerPoint) {  // consecutive threads, consecutive points: coalesced rows
#pragma unroll
      for (int u = 0; u < kQ; ++u)
        if (p < P && c0 + u < C)
          partial[static_cast<size_t>(c0 + u) * P + p] = !valid ? 0.f : kSquared ? best[u] : sqrtf(fmaxf(best[u], 0.f));
      continue;
    }
#pragma unroll
    for (int u = 0; u < kQ; ++u) {
      float v = 0.f;
      if (valid) {
        float b = best[u];
        if constexpr (kMode != kAve) b = __fadd_rn(b, q2[p]);
        v = __fmul_rn(sqrtf(fmaxf(b, 0.f)), w);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
      if (lane == 0) red[slot][u][gwarp] = v;
    }
    __syncthreads();
    if (writer) {
      float s = 0.f;
      for (int k = 0; k < kGroupWarps; ++k) s = __fadd_rn(s, red[ws][wu][k]);
      *out = s;
    }
  }
}

// The second pass: each rotation's partials added in group order.
__global__ void field_sum_kernel(const float* __restrict__ partial, int C, int groups, float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float s = 0.f;
  for (int b = 0; b < groups; ++b) s = __fadd_rn(s, partial[static_cast<size_t>(c) * groups + b]);
  out[c] = s;
}

// The plan: `slots` groups of 256 source points a block scans at once (1, 2
// or 4: 256 to 1024 threads). partial is (C, ceil(P / 256)) float32
// scratch; out (C,) the sums.
template <int kMode>
int launch_field(const float* rotated, const float* q2, const float* weight, const float* target,
                 const unsigned char* tmask, int C, int P, int T, int slots, float* partial, float* out,
                 cudaStream_t stream) {
  if (C <= 0) return 0;
  if (C > 65535 || P <= 0 || T <= 0 || (slots != 1 && slots != 2 && slots != kMaxSlots))
    return static_cast<int>(cudaErrorInvalidValue);
  field_partial_kernel<kMode><<<(C + kQ - 1) / kQ, slots * kGroup, 0, stream>>>(rotated, q2, weight, target, tmask,
                                                                                C, P, T, partial);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  field_sum_kernel<<<(C + 255) / 256, 256, 0, stream>>>(partial, C, (P + kGroup - 1) / kGroup, out);
  return static_cast<int>(cudaGetLastError());
}

// The per-point mode: dist (C, P) float32 instead of partial and out, the
// same plan; one kernel, no second pass. kSquared writes the squared distances.
template <int kMode, bool kSquared = false>
int launch_field_points(const float* rotated, const float* weight, const float* target, const unsigned char* tmask,
                        int C, int P, int T, int slots, float* dist, cudaStream_t stream) {
  if (C <= 0) return 0;
  if (C > 65535 || P <= 0 || T <= 0 || (slots != 1 && slots != 2 && slots != kMaxSlots))
    return static_cast<int>(cudaErrorInvalidValue);
  field_partial_kernel<kMode, true, kSquared><<<(C + kQ - 1) / kQ, slots * kGroup, 0, stream>>>(
      rotated, nullptr, weight, target, tmask, C, P, T, dist);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
