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
// What bounds it on an H100: float32 instruction issue. Each (query,
// reference) pair costs 3 sub + 3 mul + 3 add + compare/select, with no FMA
// (built with -fmad=false and written with __f*_rn) so the rounding equals the
// plain version's and argmins agree. The main path's shapes are small (32 x
// 512 x 2048 in the ICP screen, 1 x 3072 x 8192 in the metric), so the other
// limit is filling 132 SMs. Design:
//   - R is split across a thread-block cluster of C blocks (1, 2, 4 or 8).
//     Block rank c scans rows [c * slice, (c + 1) * slice), staged into shared
//     memory as float4 (x, y, z, bias), which a raw async copy cannot build;
//   - each of 128 threads keeps 2 queries in registers, so one broadcast
//     shared-memory load of a row feeds 2 independent compare chains; a
//     running (min, argmin) with a strict '<' keeps the first index. Among
//     tiles of 1-4 queries x 32-128 threads this one was the fastest or
//     close to it at the main-path shapes (PERF.md);
//   - the per-query partials of the C blocks are merged through distributed
//     shared memory in rank order with a strict '<', so the lowest index still
//     wins ties across slices; each rank merges and writes its share of the
//     query tile. One launch, no atomics, no init pass;
//   - the cluster size and slice come from the wrapper
//     (ops/nn_cuda.py::nn1_plan): R is split only as far as it takes to give
//     every SM two blocks.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kQpt = 2;  // queries a thread
constexpr int kMaxCluster = 8;
constexpr int kTile = 1024;
constexpr float kBig = 1e30f;

__global__ void __launch_bounds__(kThreads)
nn1_kernel(const float* __restrict__ query, const float* __restrict__ ref,
           const unsigned char* __restrict__ mask, const int* __restrict__ lane_ref,
           int Q, int G, int R, int slice, float* __restrict__ d2_out, int* __restrict__ idx_out) {
  __shared__ float4 tile[kTile];
  __shared__ float part_d[kThreads * kQpt];
  __shared__ int part_i[kThreads * kQpt];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int T = kThreads;
  const int tid = threadIdx.x;
  const int QT = T * kQpt;
  const int q0 = (blockIdx.x / C) * QT;
  const int lane = blockIdx.y;
  const size_t lane_out = static_cast<size_t>(lane) * Q;
  // This rank's share of the tile's queries in the merge.
  const int m_lo = rank * QT / C, m_hi = (rank + 1) * QT / C;
  const int g = lane_ref[lane];
  if (g < 0 || g >= G) {  // uniform over the cluster: no cluster barrier is skipped by part of it
    for (int lq = m_lo + tid; lq < m_hi; lq += T) {
      if (q0 + lq < Q) {
        d2_out[lane_out + q0 + lq] = __int_as_float(0x7fc00000);
        idx_out[lane_out + q0 + lq] = -1;
      }
    }
    return;
  }
  const float* rbase = ref + static_cast<size_t>(g) * R * 3;
  const unsigned char* mbase = mask + static_cast<size_t>(g) * R;

  float qx[kQpt], qy[kQpt], qz[kQpt], best[kQpt];
  int best_i[kQpt];
#pragma unroll
  for (int u = 0; u < kQpt; ++u) {
    const int q = q0 + tid + u * T;
    qx[u] = qy[u] = qz[u] = 0.f;
    if (q < Q) {
      const float* qp = query + (lane_out + q) * 3;
      qx[u] = qp[0];
      qy[u] = qp[1];
      qz[u] = qp[2];
    }
    best[u] = __int_as_float(0x7f800000);  // +inf: an empty slice never wins the merge
    best_i[u] = 0;
  }
  const int r_lo = min(R, rank * slice), r_hi = min(R, r_lo + slice);
  for (int base = r_lo; base < r_hi; base += kTile) {
    const int n = min(kTile, r_hi - base);
    __syncthreads();
    for (int j = tid; j < n; j += T) {
      const float* rp = rbase + static_cast<size_t>(base + j) * 3;
      tile[j] = make_float4(rp[0], rp[1], rp[2], mbase[base + j] ? 0.f : kBig);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float4 t = tile[j];
#pragma unroll
      for (int u = 0; u < kQpt; ++u) {
        const float dx = __fsub_rn(qx[u], t.x);
        const float dy = __fsub_rn(qy[u], t.y);
        const float dz = __fsub_rn(qz[u], t.z);
        const float d = __fadd_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)), t.w);
        if (d < best[u]) {
          best[u] = d;
          best_i[u] = base + j;
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kQpt; ++u) {
    part_d[tid + u * T] = best[u];
    part_i[tid + u * T] = best_i[u];
  }
  cluster.sync();
  for (int lq = m_lo + tid; lq < m_hi; lq += T) {
    const int q = q0 + lq;
    if (q >= Q) continue;
    float b = __int_as_float(0x7f800000);
    int bi = 0;
    for (int r = 0; r < C; ++r) {  // rank order = row order: strict '<' keeps the first index
      const float v = cluster.map_shared_rank(part_d, r)[lq];
      if (v < b) {
        b = v;
        bi = cluster.map_shared_rank(part_i, r)[lq];
      }
    }
    d2_out[lane_out + q] = b >= 0.5f * kBig ? kBig : fmaxf(b, 0.f);
    idx_out[lane_out + q] = min(max(bi, 0), R - 1);
  }
  cluster.sync();  // keep this block's partials alive until every rank has read them
}

}  // namespace

// query (L, Q, 3), ref (G, R, 3), mask (G, R) uint8, lane_ref (L,) int32 ->
// d2 (L, Q) float32, idx (L, Q) int32. A lane_ref outside [0, G) yields NaN / -1.
// The plan: `cluster` blocks split R into slices of `slice` rows (cluster *
// slice >= R); each block holds 256 queries.
extern "C" int kss_nn1(const float* query, const float* ref, const unsigned char* mask, const int* lane_ref,
                       int L, int Q, int G, int R, int cluster, int slice, float* d2_out, int* idx_out,
                       cudaStream_t stream) {
  if (L <= 0 || Q <= 0) return 0;
  if (L > 65535 || R <= 0 || G <= 0 || cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) ||
      slice < 1 || static_cast<long long>(slice) * cluster < R)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (Q + kThreads * kQpt - 1) / (kThreads * kQpt);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles * cluster), static_cast<unsigned>(L), 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, nn1_kernel, query, ref, mask, lane_ref, Q, G, R, slice, d2_out,
                                           idx_out);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

extern "C" const char* kss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
