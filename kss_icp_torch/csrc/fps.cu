// fps: batched farthest-point sampling, one thread block or one thread-block
// cluster per cloud.
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
// (max score, lowest index) reduction over the whole cloud and a broadcast of
// the picked point: latency, not bytes or arithmetic. A step's floor is its
// reductions and barriers; above it, its local update, which shrinks with
// the points a block holds. Design:
//   - a cloud is split over a cluster of C blocks (C = 1, 2, 4, 8 or 16, from
//     the wrapper's plan, ops/resample_cuda.py::fps_plan): block rank r holds
//     the contiguous slice [r * slice, (r + 1) * slice), so every block
//     updates 1/C of the cloud a step from its own SM. C = 1 is one block a
//     cloud with no cluster code, the plan for the main path's clouds of up
//     to 8192 points;
//   - the slice stays on the SM: with x, y, z and the score of K points a
//     thread in registers (point l = tid + j * blockDim.x of the slice, K
//     <= 16 at <= 512 threads, slices up to 8192 points) and a copy of x, y,
//     z in shared memory from which the picked point is read; or, for slices
//     of 8193-16384 points, with x, y, z in shared memory (12 B a point, up
//     to 192 KB) and K = 32 scores a thread in registers at 512 threads,
//     point l = tid + j * 512 at a constant offset from the thread's first
//     (a stride of blockDim.x put an address a point in registers, and 16
//     scores at 1024 threads or 32 at a runtime stride spilled). Nothing a
//     step touches device memory;
//   - a step costs a thread, per point, the distance (6 operations), one
//     fminf (an invalid point's -1 stays below any distance, and a slot past
//     the slice holds -inf, so no branch) and a strict '>' against its
//     running best (the first index stays);
//   - an argmax without shuffle chains: a valid score s >= 0 maps to the
//     monotone key bits(s) + 1, an invalid point to 0, so a warp reduces with
//     __reduce_max_sync on the key and __reduce_min_sync on the index among
//     the lanes holding the max. Across a block's warps, one __syncthreads a
//     step: each warp writes its (key, index) to a slot double-buffered by the
//     step's parity and every warp reduces all slots itself;
//   - across the cluster, no cluster barrier a step: lanes r < C of warp 0
//     write the block's (key, index, x, y, z) into slot `rank` of block r's
//     shared memory with st.async, whose bytes complete a transaction on
//     block r's mbarrier for the step; every warp waits on its own block's
//     mbarrier, reduces the C slots to the same (max key, lowest index) and
//     takes the picked point's coordinates from the winning slot by a
//     shuffle. A barrier.cluster arrive/wait a step cost about 1 us (its
//     release waits for the remote stores; PERF.md). Slots and mbarriers are
//     double-buffered by the step's parity: a block writes step s + 2's slots
//     only after its wait for step s + 1, which needs every block's step
//     s + 1 slots, which each block writes after reading step s's. A global
//     index in every slot keeps the first index on ties across blocks;
//   - after the seed pick, valid scores become +inf, so every step is a min.
// Every index fits an int: the largest, 3 * P, is below 2^20; per-cloud
// offsets are size_t. Distances round as two explicit fused multiply-adds
// over a rounded dx*dx (__fmaf_rn and __f*_rn; -fmad=false contracts nothing
// else), so picks equal the plain version's.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kSmemK = 32;  // shared memory: 32 scores x 512 threads = 16384 points
// One lane of a warp reads each block's slot. Whether the card schedules a
// cluster that wide is the card's to say (cudaOccupancyMaxActiveClusters);
// an H100 takes up to 16.
constexpr int kMaxCluster = 32;
constexpr unsigned kSlotBytes = 20;  // key, index, x, y, z
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;

// A block's slots of the cluster exchange, double-buffered by the round's
// parity: slot r holds block r's winner, written by block r with st.async,
// which counts its bytes on the buffer's mbarrier here.
struct ClusterSlots {
  uint4 pick[2][kMaxCluster];  // key, global index, x, y
  float z[2][kMaxCluster];
  unsigned long long bar[2];
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The address of `addr` (this block's shared memory) in block `rank`'s.
__device__ __forceinline__ unsigned map_rank(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_async(unsigned addr, uint4 v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
               :: "r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar) : "memory");
}

__device__ __forceinline__ void st_async(unsigned addr, unsigned v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               :: "r"(addr), "r"(v), "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ float sqdist(float ax, float ay, float az, float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
}

// Valid scores are >= 0 (or +inf before the first update); invalid ones -1,
// and a slot past the slice holds -inf.
__device__ __forceinline__ unsigned score_key(float w) {
  return w >= 0.f ? __float_as_uint(w) + 1u : 0u;
}

// The block's (max key, lowest index) over every thread's (key, idx), in
// every thread. One barrier; `round` picks the slot buffer. Branch-free: every
// lane stores its warp's (uniform) result and loads a slot, and lanes past
// the warps drop theirs by a select (branches here cost ~60 cycles a step).
__device__ __forceinline__ uint2 block_pick(unsigned key, unsigned idx, uint2 (*slot)[kMaxWarps], int round) {
  const int lane = threadIdx.x & 31;
  const int buf = round & 1;
  const unsigned wkey = __reduce_max_sync(kFull, key);
  const unsigned widx = __reduce_min_sync(kFull, key == wkey ? idx : kNone);
  slot[buf][threadIdx.x >> 5] = make_uint2(wkey, widx);
  __syncthreads();
  uint2 v = slot[buf][lane & (kMaxWarps - 1)];
  if (lane >= static_cast<int>(blockDim.x >> 5)) v = make_uint2(0u, kNone);
  const unsigned bkey = __reduce_max_sync(kFull, v.x);
  return make_uint2(bkey, __reduce_min_sync(kFull, v.x == bkey ? v.y : kNone));
}

// The cluster's pick from every block's winner `mine` (global index; kNone
// for a block with no point): lanes r < C of warp 0 write it into slot
// `rank` of block r with st.async, thread 0 arms this round's mbarrier for
// the C slots' bytes, and every warp waits on it and reduces the C slots.
// Returns the index, and the point in px, py, pz.
__device__ __forceinline__ unsigned cluster_pick(uint2 mine, const float* xs, const float* ys, const float* zs,
                                                 int lo, ClusterSlots& slots, int round, int C, int rank, float& px,
                                                 float& py, float& pz) {
  const int lane = threadIdx.x & 31;
  const int buf = round & 1;
  const unsigned bar = smem_u32(&slots.bar[buf]);
  if (threadIdx.x < static_cast<unsigned>(C)) {
    float x = 0.f, y = 0.f, z = 0.f;
    if (mine.y != kNone) {
      const int l = static_cast<int>(mine.y) - lo;
      x = xs[l], y = ys[l], z = zs[l];
    }
    if (threadIdx.x == 0) mbar_expect(bar, kSlotBytes * C);
    const unsigned to = threadIdx.x;
    const unsigned to_bar = map_rank(bar, to);
    st_async(map_rank(smem_u32(&slots.pick[buf][rank]), to),
             make_uint4(mine.x, mine.y, __float_as_uint(x), __float_as_uint(y)), to_bar);
    st_async(map_rank(smem_u32(&slots.z[buf][rank]), to), __float_as_uint(z), to_bar);
  }
  mbar_wait(bar, (round >> 1) & 1);
  uint4 v = slots.pick[buf][lane];  // kMaxCluster = 32: a slot a lane
  const float vz = slots.z[buf][lane];
  if (lane >= C) v = make_uint4(0u, kNone, 0u, 0u);
  const unsigned key = __reduce_max_sync(kFull, v.x);
  const unsigned sel = __reduce_min_sync(kFull, v.x == key ? v.y : kNone);
  const int from = __ffs(__ballot_sync(kFull, v.x == key && v.y == sel)) - 1;
  px = __uint_as_float(__shfl_sync(kFull, v.z, from));
  py = __uint_as_float(__shfl_sync(kFull, v.w, from));
  pz = __shfl_sync(kFull, vz, from);
  return sel;
}

// REG: x, y, z of K points a thread in registers (and a copy in shared
// memory for the pick); else x, y, z in shared memory and K scores a thread
// in registers. CLUSTER: launched as clusters of C blocks, one a cloud.
template <int K, bool REG, bool CLUSTER>
__global__ void __launch_bounds__(kMaxThreads)
fps_kernel(const float* __restrict__ points, const unsigned char* __restrict__ mask,
           const float* __restrict__ centroid, int P, int S, int steps, int slice, int* __restrict__ idx_out) {
  extern __shared__ float smem[];  // xs | ys | zs, K * blockDim.x each: the slice's points
  __shared__ uint2 slot[2][kMaxWarps];
  __shared__ ClusterSlots cslots;
  const cg::cluster_group cluster = cg::this_cluster();
  const int C = CLUSTER ? static_cast<int>(cluster.num_blocks()) : 1;
  const int rank = CLUSTER ? static_cast<int>(cluster.block_rank()) : 0;
  const int b = blockIdx.x / C;
  const int T = REG ? static_cast<int>(blockDim.x) : kMaxThreads;  // a constant stride in shared memory
  const int tid = threadIdx.x;
  const int lo = rank * slice;
  const int n = max(0, min(slice, P - lo));
  const float* pts = points + static_cast<size_t>(b) * P * 3;
  const unsigned char* m = mask + static_cast<size_t>(b) * P;
  int* out = idx_out + static_cast<size_t>(b) * S;
  for (int s = steps + rank * T + tid; s < S; s += C * T) out[s] = 0;
  if (steps <= 0) return;
  const float cx = centroid[b * 3 + 0];
  const float cy = centroid[b * 3 + 1];
  const float cz = centroid[b * 3 + 2];
  const float inf = __int_as_float(0x7f800000);
  float* xs = smem;
  float* ys = smem + K * T;
  float* zs = smem + 2 * K * T;

  float x[REG ? K : 1], y[REG ? K : 1], z[REG ? K : 1], w[K];
  float bw = -inf;  // a strict '>' keeps the first of equal scores
  unsigned bi = kNone;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int l = tid + j * T;
    float px = 0.f, py = 0.f, pz = 0.f;
    w[j] = -inf;
    if (l < n) {
      const int i = lo + l;
      px = pts[3 * i + 0];
      py = pts[3 * i + 1];
      pz = pts[3 * i + 2];
      w[j] = m[i] ? sqdist(px, py, pz, cx, cy, cz) : -1.f;
    }
    xs[l] = px;
    ys[l] = py;
    zs[l] = pz;
    if constexpr (REG) {
      x[j] = px;
      y[j] = py;
      z[j] = pz;
    }
    if (w[j] > bw) {
      bw = w[j];
      bi = lo + l;
    }
    if (w[j] >= 0.f) w[j] = inf;  // the first update replaces the seed score
  }
  if constexpr (CLUSTER) {
    if (tid == 0) {
      mbar_init(smem_u32(&cslots.bar[0]));
      mbar_init(smem_u32(&cslots.bar[1]));
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    cluster.sync();  // every block has started and armed its mbarriers before the first push
  }

  float px, py, pz;
  unsigned sel;
  uint2 mine = block_pick(score_key(bw), bi, slot, 0);
  if constexpr (CLUSTER) {
    sel = cluster_pick(mine, xs, ys, zs, lo, cslots, 0, C, rank, px, py, pz);
  } else {
    sel = mine.y;
    px = xs[sel], py = ys[sel], pz = zs[sel];
  }

  for (int s = 0;; ++s) {
    if (rank == 0 && tid == 0) out[s] = static_cast<int>(sel);
    if (s + 1 >= steps) break;
    bw = -inf;
    bi = kNone;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if constexpr (!REG) {
        if (j * T >= n) break;  // past the slice for the whole block
      }
      const int l = tid + j * T;
      const float d = REG ? sqdist(x[j], y[j], z[j], px, py, pz) : sqdist(xs[l], ys[l], zs[l], px, py, pz);
      w[j] = fminf(w[j], d);
      if (w[j] > bw) {
        bw = w[j];
        bi = lo + l;
      }
    }
    mine = block_pick(score_key(bw), bi, slot, s + 1);
    if constexpr (CLUSTER) {
      sel = cluster_pick(mine, xs, ys, zs, lo, cslots, s + 1, C, rank, px, py, pz);
    } else {
      sel = mine.y;
      px = xs[sel], py = ys[sel], pz = zs[sel];
    }
  }
  if constexpr (CLUSTER) cluster.sync();  // no block leaves while another's stores to it may be in flight
}

// The launch: B clouds, each a cluster of `cluster` blocks (no cluster
// attribute for 1). A cluster launch first asks the card whether it can
// schedule one such cluster at all; if not, the error is returned and
// nothing runs. The kernel's attributes are set once a device, and a
// cluster shape the card took is not asked about again: the occupancy query
// and the attributes cost ~0.25 ms of host time a launch. Every failure also
// clears the runtime's last error, so a later launch's check does not report
// it again.
constexpr int kMaxDevices = 64;

template <int K, bool REG, bool CLUSTER>
cudaError_t launch(const float* points, const unsigned char* mask, const float* centroid, int B, int P, int S,
                   int steps, int cluster, int slice, int threads, int* idx_out, cudaStream_t stream) {
  static bool ready[kMaxDevices];
  static bool schedulable[kMaxDevices][6][kMaxWarps + 1];  // by log2(cluster) and warps
  auto kernel = fps_kernel<K, REG, CLUSTER>;
  const size_t smem = 3 * sizeof(float) * static_cast<size_t>(K) * threads;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * static_cast<unsigned>(cluster), 1, 1);
  cfg.blockDim = dim3(static_cast<unsigned>(threads), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CLUSTER ? 1 : 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev < 0 || dev >= kMaxDevices)) e = cudaErrorInvalidDevice;
  if (e == cudaSuccess && !ready[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(3 * sizeof(float) * K * kMaxThreads));
    if (e == cudaSuccess && CLUSTER)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    ready[dev] = e == cudaSuccess;
  }
  bool* fits = CLUSTER && e == cudaSuccess ? &schedulable[dev][__builtin_ctz(cluster)][threads / 32] : nullptr;
  if (fits && !*fits) {
    int active = 0;
    e = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
    if (e == cudaSuccess && active < 1) e = cudaErrorInvalidClusterSize;
    *fits = e == cudaSuccess;
  }
  if (e == cudaSuccess) e = cudaLaunchKernelEx(&cfg, kernel, points, mask, centroid, P, S, steps, slice, idx_out);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

template <bool CLUSTER>
cudaError_t dispatch(const float* points, const unsigned char* mask, const float* centroid, int B, int P, int S,
                     int steps, int cluster, int slice, int k, int threads, int registers, int* idx_out,
                     cudaStream_t stream) {
#define KSS_FPS_LAUNCH(K_, REG_) \
  launch<K_, REG_, CLUSTER>(points, mask, centroid, B, P, S, steps, cluster, slice, threads, idx_out, stream)
  if (!registers) return k == kSmemK ? KSS_FPS_LAUNCH(kSmemK, false) : cudaErrorInvalidValue;
  switch (k) {
    case 1: return KSS_FPS_LAUNCH(1, true);
    case 2: return KSS_FPS_LAUNCH(2, true);
    case 4: return KSS_FPS_LAUNCH(4, true);
    case 8: return KSS_FPS_LAUNCH(8, true);
    case 16: return KSS_FPS_LAUNCH(16, true);
    default: return cudaErrorInvalidValue;
  }
#undef KSS_FPS_LAUNCH
}

}  // namespace

// points (B, P, 3) float32, mask (B, P) uint8, centroid (B, 3) float32 ->
// idx (B, S) int32, the first `steps` picks and zeros after them. The plan
// (ops/resample_cuda.py::fps_plan): a cluster of `cluster` blocks a cloud
// (a power of two up to 32; 1 for one block), block rank r holding points
// [r * slice, (r + 1) * slice); `k` points a thread in registers (registers
// = 1: k in 1, 2, 4, 8, 16, threads <= 512) or k = 32 scores a thread with
// x, y, z in shared memory (registers = 0, threads = 512); k * threads
// must cover the slice and cluster * slice the cloud.
extern "C" int kss_fps(const float* points, const unsigned char* mask, const float* centroid, int B, int P,
                       int S, int steps, int cluster, int slice, int k, int threads, int registers, int* idx_out,
                       cudaStream_t stream) {
  if (B <= 0 || S <= 0) return 0;
  if (P <= 0 || steps < 0 || steps > S || cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) ||
      slice < 1 || static_cast<long long>(slice) * cluster < P || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || static_cast<long long>(k) * threads < slice || (!registers && threads != kMaxThreads) ||
      static_cast<long long>(B) * cluster > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e =
      cluster > 1 ? dispatch<true>(points, mask, centroid, B, P, S, steps, cluster, slice, k, threads, registers,
                                   idx_out, stream)
                  : dispatch<false>(points, mask, centroid, B, P, S, steps, cluster, slice, k, threads, registers,
                                    idx_out, stream);
  return static_cast<int>(e);
}
