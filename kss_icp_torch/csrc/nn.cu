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
// What bounds it on an H100: float32 instruction issue, one warp instruction
// a clock on each SM sub-partition. No FMA (built with -fmad=false and
// written with __f*_rn), so the rounding equals the plain version's and
// argmins agree. The scan spends 9 instructions a (query, row) pair: 3 sub,
// 3 mul, 2 add and one min, with a shared-memory load of a row shared by the
// thread's queries. Design:
//   - R is split across a thread-block cluster of C blocks (1, 2, 4 or 8).
//     Block rank c scans rows [c * slice, (c + 1) * slice), staged into shared
//     memory 1024 rows at a time as float4 (x, y, z, 0); a masked row, and the
//     padding of a tile to whole chunks, is staged as (+inf, +inf, +inf), so
//     its distance is +inf and no bias is added a pair. For finite inputs
//     that is the plain version's answer: a valid row's distance is below
//     1e30, so a masked row's d + 1e30 never wins; over a fully masked
//     reference every d + 1e30 under 3.8e22 rounds to 1e30 and the plain
//     index is 0, which an untouched index gives;
//   - each of 128 threads keeps 2 or 4 queries (the plan's choice) in
//     registers and a running min of each over the rows, with no index. At
//     the end of every chunk of 32 rows a strict '<' against the min at the
//     last chunk's end records the chunk where the min fell, so the earliest
//     chunk holding the slice's min wins. At the end of a tile, each query
//     whose min fell in it rescans the winning chunk's 32 staged rows with
//     the same operations and takes the first row whose distance equals the
//     min; a slice with no finite distance keeps index 0. Where most lanes
//     of a warp rescan (the first tiles), each lane walks its own chunk,
//     rotated so that the 8 lanes of a quarter warp read 8 bank groups; where
//     a few do (later tiles, when a new min is rare), the warp rescans their
//     chunks one at a time, a row a lane, and a ballot finds the first;
//   - the per-query partials of the C blocks are merged through distributed
//     shared memory in rank order with a strict '<', so the lowest index still
//     wins ties across slices; each rank merges and writes its share of the
//     query tile. One launch, no atomics, no init pass;
//   - the plan (ops/nn_cuda.py::nn1_plan) sets the queries a thread, the
//     cluster size and the slice: 4 queries a thread where the launch still
//     gives every SM two blocks, else 2; R split over at least 2 blocks where
//     it holds two slices of 256 rows, and further only as far as it takes
//     to give every SM two blocks (scripts/torch_kernel_ab.py --sweep).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kMaxCluster = 8;
constexpr int kTile = 1024;  // rows staged at a time
constexpr int kChunk = 32;   // rows between two checks of the running min: a row a lane of a warp
constexpr int kWarpRescans = 16;  // up to this many lanes needing a rescan, the warp rescans their chunks together
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr float kBig = 1e30f;

static_assert(kTile % kChunk == 0 && kChunk == 32, "a whole tile is whole chunks, a chunk a row a lane");

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// ((dx*dx + dy*dy) + dz*dz), rounded as the plain version rounds it.
__device__ __forceinline__ float sq_dist(float qx, float qy, float qz, float x, float y, float z) {
  const float dx = __fsub_rn(qx, x);
  const float dy = __fsub_rn(qy, y);
  const float dz = __fsub_rn(qz, z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

template <int kQpt>
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

  float qx[kQpt], qy[kQpt], qz[kQpt], run[kQpt], best[kQpt];
  int win[kQpt];  // first row of the chunk where the min last fell; -1 while no distance is finite
  int bi[kQpt];   // the first row that attains the min
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
    run[u] = best[u] = inf();  // +inf: an empty slice never wins the merge
    win[u] = -1;
    bi[u] = 0;
  }
  const int r_lo = min(R, rank * slice), r_hi = min(R, r_lo + slice);
  for (int base = r_lo; base < r_hi; base += kTile) {
    const int n = min(kTile, r_hi - base);
    const int n_pad = (n + kChunk - 1) / kChunk * kChunk;
    __syncthreads();
    for (int j = tid; j < n_pad; j += T) {
      float4 v = make_float4(inf(), inf(), inf(), 0.f);
      if (j < n) {  // the mask and the row load together
        const float* rp = rbase + static_cast<size_t>(base + j) * 3;
        const float x = rp[0], y = rp[1], z = rp[2];
        if (mbase[base + j]) v = make_float4(x, y, z, 0.f);
      }
      tile[j] = v;
    }
    __syncthreads();
#pragma unroll 1
    for (int c = 0; c < n_pad; c += kChunk) {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float4 t = tile[c + j];
#pragma unroll
        for (int u = 0; u < kQpt; ++u) run[u] = fminf(run[u], sq_dist(qx[u], qy[u], qz[u], t.x, t.y, t.z));
      }
#pragma unroll
      for (int u = 0; u < kQpt; ++u) {
        if (run[u] < best[u]) {  // strict: the earliest chunk that holds the min wins
          best[u] = run[u];
          win[u] = base + c;
        }
      }
    }
    // Where the min fell in this tile, its row, while the tile is staged: the
    // first row of the winning chunk whose distance is the min.
#pragma unroll
    for (int u = 0; u < kQpt; ++u) {
      unsigned need = __ballot_sync(kFullWarp, win[u] >= base);
      if (__popc(need) > kWarpRescans) {
        // Most lanes: each its own chunk. Lane l reads the chunk's rows in
        // turn from the one in bank group (l + j) % 8 at step j, so the 8
        // lanes of a quarter warp never share a bank.
        if (win[u] >= base) {
          const int off = win[u] - base;
          const int turn = (tid - off) & 7;
          int first = kChunk;
#pragma unroll
          for (int j = 0; j < kChunk; ++j) {
            const int k = (j + turn) & (kChunk - 1);
            const float4 t = tile[off + k];
            first = sq_dist(qx[u], qy[u], qz[u], t.x, t.y, t.z) == best[u] ? min(first, k) : first;
          }
          bi[u] = win[u] + first;
        }
      } else {
        // A few lanes (late tiles): the warp rescans each of their chunks
        // together, a row a lane.
        while (need) {
          const int src = __ffs(need) - 1;
          need &= need - 1;
          const int w = __shfl_sync(kFullWarp, win[u], src);
          const float4 t = tile[w - base + (tid & 31)];
          const float d = sq_dist(__shfl_sync(kFullWarp, qx[u], src), __shfl_sync(kFullWarp, qy[u], src),
                                  __shfl_sync(kFullWarp, qz[u], src), t.x, t.y, t.z);
          const unsigned hits = __ballot_sync(kFullWarp, d == __shfl_sync(kFullWarp, best[u], src));
          if ((tid & 31) == src) bi[u] = w + __ffs(hits) - 1;
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kQpt; ++u) {
    part_d[tid + u * T] = best[u];
    part_i[tid + u * T] = bi[u];
  }
  cluster.sync();
  for (int lq = m_lo + tid; lq < m_hi; lq += T) {
    const int q = q0 + lq;
    if (q >= Q) continue;
    float b = inf();
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

template <int kQpt>
cudaError_t launch(const float* query, const float* ref, const unsigned char* mask, const int* lane_ref, int L,
                   int Q, int G, int R, int cluster, int slice, float* d2_out, int* idx_out, cudaStream_t stream) {
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
  return cudaLaunchKernelEx(&cfg, nn1_kernel<kQpt>, query, ref, mask, lane_ref, Q, G, R, slice, d2_out, idx_out);
}

}  // namespace

// query (L, Q, 3), ref (G, R, 3), mask (G, R) uint8, lane_ref (L,) int32 ->
// d2 (L, Q) float32, idx (L, Q) int32. A lane_ref outside [0, G) yields NaN / -1.
// The plan: `cluster` blocks split R into slices of `slice` rows (cluster *
// slice >= R); each block holds 128 x `queries` queries (2 or 4 a thread).
extern "C" int kss_nn1(const float* query, const float* ref, const unsigned char* mask, const int* lane_ref,
                       int L, int Q, int G, int R, int cluster, int slice, int queries, float* d2_out,
                       int* idx_out, cudaStream_t stream) {
  if (L <= 0 || Q <= 0) return 0;
  if (L > 65535 || R <= 0 || G <= 0 || cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) ||
      slice < 1 || static_cast<long long>(slice) * cluster < R || (queries != 2 && queries != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = queries == 4
      ? launch<4>(query, ref, mask, lane_ref, L, Q, G, R, cluster, slice, d2_out, idx_out, stream)
      : launch<2>(query, ref, mask, lane_ref, L, Q, G, R, cluster, slice, d2_out, idx_out, stream);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

extern "C" const char* kss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
