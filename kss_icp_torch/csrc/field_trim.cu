// field_ave, field_trim and field_sq: the coarse search's "ave" rotation field, the overlap
// tier's trimmed field ("trim") and the "max" and "diff" fields, one launch a field, each
// rotation's statistic reduced in the kernel.
//
// "ave" replaces the Pallas TPU kernel kss_icp_tpu/ops/coarse_pallas.py:201 (K1,
// rotation_scores_pallas with method="vpu", body _field_kernel_vpu at :77). The others replace no
// TPU kernel: JAX scores those metrics with XLA (kss_icp_tpu/models/coarse.py:113-131 through
// ops/nn.py:183-198), since its Pallas field does only "ave". Plain PyTorch versions:
// kss_icp_torch/ops/coarse_cuda.py::field_ave_plain, field_trim_plain, field_max_plain,
// field_diff_plain (ops/nn.py::masked_mean_nn_distance, nn_distances / nn_sqdistances of the
// rotated source, then trimmed_masked_mean or sq_error, their sums in float64). A deliberate
// divergence from JAX: "ave" sums in float64 and rounds once, where the TPU kernel adds float32
// partial sums a query tile at a time (within 2 float32 ulps of the field on the rows tried,
// tests/test_torch_field_cull.py), so the kernel's sum in its own order keeps the plain
// version's bits.
//
// For each rotation c and valid source point p, v(c, p) = min over the valid target rows t of
// ((dx*dx + dy*dy) + dz*dz), (dx, dy, dz) = t - R_c s_p, every product and sum rounded on its
// own, R_c s_p as rotate_points rounds it ((r0*x + r1*y) + r2*z); against a target with no
// valid row, the min over every row of that + 1e30 (the plain version's bias). Then per
// rotation:
//   trim  float32(sum of the k smallest sqrt(v), in float64) / float32(k), k the clipped rank
//         ceil(q * n_valid - 1e-3) of ops/nn.py::_trim_count; 1e30 with no valid point;
//   max   the largest v; -1e30 with no valid point;
//   diff  sqrt(max v) - float32(sum of sqrt(v), in float64) / max(n_valid, 1);
//   ave   float32(sum of sqrt(max(v, 0)), in float64) / float32(max(n_valid, 1)); 0 with no valid
//         point, as the plain version's masked mean gives;
//   the probe modes write v or sqrt(v) to a (C, P) buffer in the caller's point order, 0 at a
//   masked point (the tests' and the smoke run's check of the min; the main path never runs
//   them).
//
// What bounds it on an H100: float32 instruction issue. A brute-force scan spends 9
// instructions a (rotation, point, row) pair (3 sub, 3 mul, 2 add, 1 min; -fmad=false keeps
// the plain version's rounding), so it cannot come within 2x of the operations bound: only
// fewer pairs can. The kernel it replaces (the field template's per-point mode) also wrote a
// (C, P, 3) rotated source and a (C, P) buffer to device memory and left each row's sort,
// cumulative sum and gather, or max and mean, to PyTorch.
//
// Design:
//   - one block a rotation, 512 threads. The wrapper (ops/coarse_cuda.py::field_order) sorts
//     both clouds once a call by a Morton code over one box around them, valid rows first (a
//     stable torch.sort of the keys that kss_field_keys, below, writes in one launch: the same
//     keys from PyTorch's elementwise ops cost more device time than the sort). The block
//     stages the sorted valid target rows in shared memory, cuts them into tiles of 16 rows,
//     and records each tile's box (the exact float32 min and max of its rows) and each run of
//     8 tiles' box. A target past the block's share (`cap` rows) is walked in chunks, each
//     with its own boxes; the running mins persist between chunks.
//   - a warp holds 32 consecutive Morton-sorted source points of the block's rotation,
//     rotated in registers from the (C, 3, 3) rotations: a rotation keeps neighbours together.
//     Warps take these groups from a counter in shared memory, so warps whose groups cull
//     more take more of them. The warp scans the tile nearest its points' centroid first, then
//     the runs of 8 tiles outward from it in Morton order, testing each run's box and then each
//     tile's box.
//   - exact culling. A box is skipped when, for every lane with a valid point, its lower bound
//     sum over axes of max(0, lo - q, q - hi)^2 is above the lane's min so far, strictly (a warp
//     vote). The bound is taken with round-down arithmetic (__fsub_rd, __fmul_rd, __fadd_rd):
//     for every row t of the box, |rn(t - q)| >= rd(lo - q) or rd(q - hi) per axis (rounding is
//     monotone and lo <= t <= hi), so each rounded-down square and sum is at most the
//     round-to-nearest one of the row's own distance. A skipped row's value is above the min
//     so far, so it cannot be the min: the min, and every statistic, keeps its bits. A scanned
//     tile's rows are evaluated exactly as the plain version evaluates them; a partial last
//     tile repeats its first row, which leaves the min unchanged. A target with no valid row
//     takes the biased path over every row, unculled.
//   - the row epilogue in the block: the block's P mins stay in shared memory (P < 8192 for
//     "trim", as _sorted_rank requires). Past FIELD_MAX_POINTS source points ("ave", "max",
//     "diff" and the probe modes) they go to a (C, P) scratch in device memory that the wrapper
//     allocates, so every P stays accepted and shared memory holds the target. "trim" finds
//     the k-th smallest sqrt(v) by a radix select on its bits (non-negative floats order as
//     their bits): four 8-bit histogram passes with shared-memory atomics, which count and so
//     do not depend on order. The sum of the values below it, plus (k - their count) times it, is
//     taken in float64 in a fixed order (each thread its strided points, then a shuffle tree,
//     then the warps in order), so repeated runs give the same bits; a float64 sum in any order
//     rounds to the same float32 as the plain version's float64 cumulative sum on every row
//     tried. "ave", "max" and "diff" reduce the max and the float64 sum the same way.
//   - an optional counter adds up the (point, row) pairs each warp scanned and the box tests
//     its lanes with a valid point made, the centroid's search for the nearest tile included
//     (the smoke run's share of pairs scanned and the bound on the work this design needs):
//     a second instantiation of the kernel, so the main path, which passes none, runs no
//     counting code.
//   - no fallback: a launch the card refuses returns its error to the wrapper, which raises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;  // a block: one rotation
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 16;  // rows a box
constexpr int kRunTiles = 8;  // tiles a run's box
constexpr int kRunRows = kTileRows * kRunTiles;
constexpr float kBig = 1e30f;
constexpr unsigned kFull = 0xffffffffu;

enum Stat { kTrim = 0, kMax = 1, kDiff = 2, kProbeDist = 3, kProbeSq = 4, kAve = 5 };

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// The plain version's squared distance, every operation rounded on its own.
__device__ __forceinline__ float sq_dist(float4 t, float qx, float qy, float qz) {
  const float dx = __fsub_rn(t.x, qx);
  const float dy = __fsub_rn(t.y, qy);
  const float dz = __fsub_rn(t.z, qz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// A lower bound of sq_dist(t, q) for every row t in [lo, hi], rounded down at every step.
__device__ __forceinline__ float box_bound(float4 lo, float4 hi, float qx, float qy, float qz) {
  const float ex = fmaxf(fmaxf(__fsub_rd(lo.x, qx), __fsub_rd(qx, hi.x)), 0.f);
  const float ey = fmaxf(fmaxf(__fsub_rd(lo.y, qy), __fsub_rd(qy, hi.y)), 0.f);
  const float ez = fmaxf(fmaxf(__fsub_rd(lo.z, qz), __fsub_rd(qz, hi.z)), 0.f);
  return __fadd_rd(__fadd_rd(__fmul_rd(ex, ex), __fmul_rd(ey, ey)), __fmul_rd(ez, ez));
}

// The min over one tile's 16 rows, two chains; kBiased adds the plain version's 1e30.
template <bool kBiased>
__device__ __forceinline__ float scan_tile(const float4* r, float qx, float qy, float qz, float best) {
  float b1 = inf();
#pragma unroll
  for (int j = 0; j < kTileRows; j += 2) {
    float d0 = sq_dist(r[j], qx, qy, qz);
    float d1 = sq_dist(r[j + 1], qx, qy, qz);
    if (kBiased) {
      d0 = __fadd_rn(d0, kBig);
      d1 = __fadd_rn(d1, kBig);
    }
    best = fminf(best, d0);
    b1 = fminf(b1, d1);
  }
  return fminf(best, b1);
}

// Does any lane with a valid point need the box: is its bound at most the lane's min so far?
__device__ __forceinline__ bool needed(bool valid, float4 lo, float4 hi, float qx, float qy, float qz, float best) {
  return __any_sync(kFull, valid && box_bound(lo, hi, qx, qy, qz) <= best);
}

// ceil(q * n - 1e-3) in float32, clipped to [1, max(n, 1)]: ops/nn.py::_sorted_rank's k.
__device__ __forceinline__ int trim_rank(int n, float q) {
  const int k = static_cast<int>(ceilf(__fsub_rn(__fmul_rn(q, static_cast<float>(n)), 1e-3f)));
  return min(max(k, 1), max(n, 1));
}

// The block's sum of one double a thread, in a fixed order; the result in thread 0.
__device__ __forceinline__ double block_sum(double v, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = 0.0;
  if (warp == 0) {
    v = lane < kWarps ? red[lane] : 0.0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  }
  return v;
}

// The block's max of one float a thread; the result in thread 0.
__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_down_sync(kFull, v, off));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? red[lane] : -inf();
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_down_sync(kFull, v, off));
  }
  return v;
}

// Shared memory of one block: cap rows (16 B), a box a tile and a box a run (32 B each), P mins.
__host__ __device__ inline size_t smem_bytes(int cap, int P) {
  return static_cast<size_t>(cap) * 16 + static_cast<size_t>(cap / kTileRows) * 32 +
         static_cast<size_t>(cap / kRunRows) * 32 + static_cast<size_t>((P + 3) / 4) * 16;
}

// The trim statistic of one rotation's ns mins (overwritten with their roots); thread 0 returns it.
__device__ float trim_stat(float* vals, int ns, float q, unsigned* hist, double* red, unsigned* sel_prefix,
                           int* sel_rank, int* sel_below) {
  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < ns; i += kThreads) vals[i] = sqrtf(fmaxf(vals[i], 0.f));
  const int k = trim_rank(ns, q);
  unsigned prefix = 0;
  int rank = k, below = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {  // the k-th smallest bit pattern, 8 bits a pass
    for (int i = tid; i < 256; i += kThreads) hist[i] = 0;
    __syncthreads();
    const unsigned high = shift == 24 ? 0u : ~0u << (shift + 8);
    for (int i = tid; i < ns; i += kThreads) {
      const unsigned b = __float_as_uint(vals[i]) & 0x7fffffffu;  // -0 is +0
      if ((b & high) == prefix) atomicAdd(&hist[(b >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (tid < 32) {  // lane l holds bins 8l .. 8l + 7
      unsigned h[8], own = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) own += (h[j] = hist[lane * 8 + j]);
      unsigned before = own;  // inclusive scan of the lanes' counts
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned v = __shfl_up_sync(kFull, before, off);
        if (lane >= off) before += v;
      }
      before -= own;
      const unsigned want = static_cast<unsigned>(rank);
      if (before < want && want <= before + own) {  // one lane holds the k-th value's bin
        unsigned cum = before;
        int bin = 0;
        while (cum + h[bin] < want) cum += h[bin++];
        *sel_prefix = prefix | (static_cast<unsigned>(lane * 8 + bin) << shift);
        *sel_rank = rank - static_cast<int>(cum);  // the rank within the bin
        *sel_below = below + static_cast<int>(cum);  // values below the bin
      }
    }
    __syncthreads();
    prefix = *sel_prefix;
    rank = *sel_rank;
    below = *sel_below;
  }
  double sum = 0.0;
  for (int i = tid; i < ns; i += kThreads)
    if ((__float_as_uint(vals[i]) & 0x7fffffffu) < prefix) sum += static_cast<double>(vals[i]);
  sum = block_sum(sum, red);
  sum += static_cast<double>(k - below) * static_cast<double>(__uint_as_float(prefix));
  return __fdiv_rn(__double2float_rn(sum), static_cast<float>(k));
}

// Grid C: a block a rotation (its matrix in shared memory), at most 64 registers a thread, two
// blocks an SM. kCount: add up the pairs scanned and the box tests made (the counter's
// instantiation; the main path's has no counting code). kSmemMins: the mins in shared memory
// (else in `scratch`), known at compile time so their loads and stores address shared memory.
template <bool kCount, bool kSmemMins>
__global__ void __launch_bounds__(kThreads, 2)
field_cull_kernel(const float* __restrict__ source, const unsigned char* __restrict__ smask,
                  const float* __restrict__ target, const unsigned char* __restrict__ tmask,
                  const int64_t* __restrict__ order, const float* __restrict__ rotations, int P, int T, int stat,
                  float q, int cap, float* __restrict__ out, float* __restrict__ scratch,
                  unsigned long long* __restrict__ scanned) {
  extern __shared__ float4 smem[];
  float4* rows = smem;
  float4* tlo = rows + cap;
  float4* thi = tlo + cap / kTileRows;
  float4* rlo = thi + cap / kTileRows;
  float4* rhi = rlo + cap / kRunRows;
  const int c = blockIdx.x;
  float* vals = kSmemMins ? reinterpret_cast<float*>(rhi + cap / kRunRows) : scratch + static_cast<size_t>(c) * P;
  __shared__ float rot[9];
  __shared__ unsigned hist[256];
  __shared__ double red_d[kWarps];
  __shared__ float red_f[kWarps];
  __shared__ int next_group;
  __shared__ unsigned sel_prefix;
  __shared__ int sel_rank, sel_below;

  const int tid = threadIdx.x, lane = tid & 31;
  int ns = 0, m = 0;  // valid source points, valid target rows
  for (int i = 0; i < max(P, T); i += kThreads) {
    ns += __syncthreads_count(i + tid < P && smask[i + tid]);
    m += __syncthreads_count(i + tid < T && tmask[i + tid]);
  }
  const bool biased = m == 0;
  const int rows_n = biased ? T : m;
  if (tid < 9) rot[tid] = rotations[static_cast<size_t>(c) * 9 + tid];
  for (int i = tid; i < ns; i += kThreads) vals[i] = inf();
  const int groups = (ns + 31) / 32;
  unsigned long long pairs = 0, tests = 0;

  for (int base = 0; base < rows_n; base += cap) {
    const int mc = min(cap, rows_n - base);
    const int tiles = (mc + kTileRows - 1) / kTileRows;
    const int runs = (tiles + kRunTiles - 1) / kRunTiles;
    __syncthreads();  // every warp is done with the last chunk
    for (int j = tid; j < tiles * kTileRows; j += kThreads) {
      const int row = base + (j < mc ? j : j / kTileRows * kTileRows);  // a partial tile repeats its first row
      const int t = biased ? row : static_cast<int>(order[P + row]) - P;
      const float* p = target + static_cast<size_t>(t) * 3;
      rows[j] = make_float4(p[0], p[1], p[2], 0.f);
    }
    if (tid == 0) next_group = 0;
    __syncthreads();
    if (!biased) {
      for (int i = tid; i < tiles; i += kThreads) {
        float4 lo = rows[i * kTileRows], hi = lo;
        for (int j = 1; j < kTileRows; ++j) {
          const float4 v = rows[i * kTileRows + j];
          lo = make_float4(fminf(lo.x, v.x), fminf(lo.y, v.y), fminf(lo.z, v.z), 0.f);
          hi = make_float4(fmaxf(hi.x, v.x), fmaxf(hi.y, v.y), fmaxf(hi.z, v.z), 0.f);
        }
        tlo[i] = lo;
        thi[i] = hi;
      }
      __syncthreads();
      for (int i = tid; i < runs; i += kThreads) {
        float4 lo = tlo[i * kRunTiles], hi = thi[i * kRunTiles];
        for (int j = i * kRunTiles + 1; j < min(tiles, (i + 1) * kRunTiles); ++j) {
          lo = make_float4(fminf(lo.x, tlo[j].x), fminf(lo.y, tlo[j].y), fminf(lo.z, tlo[j].z), 0.f);
          hi = make_float4(fmaxf(hi.x, thi[j].x), fmaxf(hi.y, thi[j].y), fmaxf(hi.z, thi[j].z), 0.f);
        }
        rlo[i] = lo;
        rhi[i] = hi;
      }
      __syncthreads();
    }

    for (;;) {  // groups of 32 sorted source points, taken from the counter
      int g = 0;
      if (lane == 0) g = atomicAdd(&next_group, 1);
      g = __shfl_sync(kFull, g, 0);
      if (g >= groups) break;
      const int i = g * 32 + lane;
      const bool valid = i < ns;
      float qx = 0.f, qy = 0.f, qz = 0.f, best = inf();
      if (valid) {
        const float* r = rot;
        const float* p = source + static_cast<size_t>(order[i]) * 3;
        const float x = p[0], y = p[1], z = p[2];
        qx = __fadd_rn(__fadd_rn(__fmul_rn(r[0], x), __fmul_rn(r[1], y)), __fmul_rn(r[2], z));
        qy = __fadd_rn(__fadd_rn(__fmul_rn(r[3], x), __fmul_rn(r[4], y)), __fmul_rn(r[5], z));
        qz = __fadd_rn(__fadd_rn(__fmul_rn(r[6], x), __fmul_rn(r[7], y)), __fmul_rn(r[8], z));
        best = vals[i];
      }
      const int nvalid = __popc(__ballot_sync(kFull, valid));
      int rows_scanned = 0, boxes = 0;
      if (biased) {
        for (int t = 0; t < tiles; ++t) best = scan_tile<true>(rows + t * kTileRows, qx, qy, qz, best);
        rows_scanned = mc;
      } else {
        // The tile nearest the centroid of the warp's points (a heuristic: any order is exact).
        float cx = valid ? qx : 0.f, cy = valid ? qy : 0.f, cz = valid ? qz : 0.f;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          cx += __shfl_xor_sync(kFull, cx, off);
          cy += __shfl_xor_sync(kFull, cy, off);
          cz += __shfl_xor_sync(kFull, cz, off);
        }
        const float inv = 1.f / static_cast<float>(nvalid);
        cx *= inv;
        cy *= inv;
        cz *= inv;
        float bd = inf();
        int first = tiles;
        for (int t = lane; t < tiles; t += 32) {
          const float d = box_bound(tlo[t], thi[t], cx, cy, cz);
          if (d < bd) {
            bd = d;
            first = t;
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float od = __shfl_xor_sync(kFull, bd, off);
          const int ot = __shfl_xor_sync(kFull, first, off);
          if (od < bd || (od == bd && ot < first)) {
            bd = od;
            first = ot;
          }
        }
        if (first >= tiles) first = 0;  // no finite bound (a NaN point): any order is exact
        if (kCount) boxes = 1;
        if (needed(valid, tlo[first], thi[first], qx, qy, qz, best)) {
          best = scan_tile<false>(rows + first * kTileRows, qx, qy, qz, best);
          if (kCount) rows_scanned += min(kTileRows, mc - first * kTileRows);
        }
        const int r0 = first / kRunTiles;
        for (int step = 0; step < 2 * runs; ++step) {  // runs r0, r0 + 1, r0 - 1, r0 + 2, ...
          const int run = (step & 1) ? r0 + (step + 1) / 2 : r0 - step / 2;
          if (run < 0 || run >= runs) continue;
          if (kCount) ++boxes;
          if (!needed(valid, rlo[run], rhi[run], qx, qy, qz, best)) continue;
          const int t_end = min(tiles, (run + 1) * kRunTiles);
          for (int t = run * kRunTiles; t < t_end; ++t) {
            if (t == first) continue;
            if (kCount) ++boxes;
            if (!needed(valid, tlo[t], thi[t], qx, qy, qz, best)) continue;
            best = scan_tile<false>(rows + t * kTileRows, qx, qy, qz, best);
            if (kCount) rows_scanned += min(kTileRows, mc - t * kTileRows);
          }
        }
      }
      if (valid) vals[i] = best;
      if (kCount) {
        pairs += static_cast<unsigned long long>(rows_scanned) * nvalid;
        if (!biased) tests += static_cast<unsigned long long>(boxes) * nvalid + tiles;  // + the centroid's search
      }
    }
  }
  if (kCount && lane == 0) {
    if (pairs != 0) atomicAdd(scanned, pairs);
    if (tests != 0) atomicAdd(scanned + 1, tests);
  }

  __syncthreads();  // every min written

  if (stat == kProbeDist || stat == kProbeSq) {
    for (int i = tid; i < P; i += kThreads) {
      float x = 0.f;
      if (i < ns) x = stat == kProbeSq ? vals[i] : sqrtf(fmaxf(vals[i], 0.f));
      out[static_cast<size_t>(c) * P + order[i]] = x;
    }
  } else if (ns == 0) {
    if (tid == 0) out[c] = stat == kTrim ? kBig : stat == kAve ? 0.f : -kBig;
  } else if (stat == kTrim) {
    const float f = trim_stat(vals, ns, q, hist, red_d, &sel_prefix, &sel_rank, &sel_below);
    if (tid == 0) out[c] = f;
  } else if (stat == kAve) {
    double sum = 0.0;
    for (int i = tid; i < ns; i += kThreads) sum += static_cast<double>(sqrtf(fmaxf(vals[i], 0.f)));
    sum = block_sum(sum, red_d);
    if (tid == 0) out[c] = __fdiv_rn(__double2float_rn(sum), static_cast<float>(ns));
  } else {
    float mx = -inf();
    double sum = 0.0;
    for (int i = tid; i < ns; i += kThreads) {
      mx = fmaxf(mx, vals[i]);
      if (stat == kDiff) sum += static_cast<double>(sqrtf(vals[i]));
    }
    mx = block_max(mx, red_f);
    if (stat == kDiff) sum = block_sum(sum, red_d);
    if (tid == 0)
      out[c] = stat == kMax ? mx : __fsub_rn(sqrtf(mx), __fdiv_rn(__double2float_rn(sum), static_cast<float>(ns)));
  }
}

// Every third bit of a 9-bit cell index.
__device__ __forceinline__ unsigned spread_bits(unsigned v) {
  v = (v | (v << 16)) & 0x030000ffu;
  v = (v | (v << 8)) & 0x0300f00fu;
  v = (v | (v << 4)) & 0x030c30c3u;
  return (v | (v << 2)) & 0x09249249u;
}

// field_order's sort keys in one block: the box around both clouds' rows, then each row's
// key cloud * 2^28 + invalid * 2^27 + its 9-bit-an-axis Morton code (x in the lowest bit),
// the cell index truncated from (p - lo) * (512 / max(hi - lo, 1e-30)), every operation
// rounded as ops/coarse_cuda.py::field_keys_plain's.
__global__ void __launch_bounds__(1024) field_keys_kernel(const float* __restrict__ source,
                                                          const unsigned char* __restrict__ smask,
                                                          const float* __restrict__ target,
                                                          const unsigned char* __restrict__ tmask, int P, int T,
                                                          int* __restrict__ keys) {
  __shared__ float part[2][3][32];
  __shared__ float box[2][3];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float lo[3] = {inf(), inf(), inf()}, hi[3] = {-inf(), -inf(), -inf()};
  for (int i = tid; i < P + T; i += blockDim.x) {
    const float* p = i < P ? source + static_cast<size_t>(i) * 3 : target + static_cast<size_t>(i - P) * 3;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = fminf(lo[a], p[a]);
      hi[a] = fmaxf(hi[a], p[a]);
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo[a] = fminf(lo[a], __shfl_xor_sync(kFull, lo[a], off));
      hi[a] = fmaxf(hi[a], __shfl_xor_sync(kFull, hi[a], off));
    }
    if (lane == 0) {
      part[0][a][warp] = lo[a];
      part[1][a][warp] = hi[a];
    }
  }
  __syncthreads();
  if (warp == 0) {
    const int warps = blockDim.x >> 5;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float l = lane < warps ? part[0][a][lane] : inf(), h = lane < warps ? part[1][a][lane] : -inf();
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        l = fminf(l, __shfl_xor_sync(kFull, l, off));
        h = fmaxf(h, __shfl_xor_sync(kFull, h, off));
      }
      if (lane == 0) {
        box[0][a] = l;
        box[1][a] = __fdiv_rn(512.f, fmaxf(__fsub_rn(h, l), 1e-30f));  // the scale
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < P + T; i += blockDim.x) {
    const bool src = i < P;
    const float* p = src ? source + static_cast<size_t>(i) * 3 : target + static_cast<size_t>(i - P) * 3;
    unsigned code = 0;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int cell = static_cast<int>(__fmul_rn(__fsub_rn(p[a], box[0][a]), box[1][a]));
      code |= spread_bits(static_cast<unsigned>(min(max(cell, 0), 511))) << a;
    }
    const bool valid = src ? smask[i] : tmask[i - P];
    keys[i] = static_cast<int>(code | (valid ? 0u : 1u << 27) | (src ? 0u : 1u << 28));
  }
}

}  // namespace

// source (P, 3), target (T, 3), rotations (C, 3, 3) float32; smask (P,), tmask (T,) uint8; order
// (P + T,) int64: the indices of a stable sort of kss_field_keys' keys (source rows first, each
// cloud's valid rows first); stat 0 trim (q its fraction), 1 max, 2 diff, 3 / 4 the probe
// modes' distances / squared distances, 5 ave; cap: target rows a block stages at once, a multiple of
// 128. out (C,) float32, or (C, P) in the probe modes; scratch: null (the mins in shared
// memory) or (C, P) float32 for the mins (any stat but trim); scanned: null or an optional
// (2,) counter of the (point, row) pairs scanned and the box tests made.
extern "C" int kss_field_cull(const float* source, const unsigned char* smask, const float* target,
                              const unsigned char* tmask, const int64_t* order, const float* rotations, int C, int P,
                              int T, int stat, float q, int cap, float* out, float* scratch,
                              unsigned long long* scanned, cudaStream_t stream) {
  if (C <= 0) return 0;
  if (C > 65535 || P <= 0 || T <= 0 || stat < kTrim || stat > kAve || cap <= 0 || cap % kRunRows != 0 ||
      (stat == kTrim && scratch != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(cap, scratch != nullptr ? 0 : P);
  const bool smem_mins = scratch == nullptr;
  auto kernel = scanned != nullptr ? (smem_mins ? field_cull_kernel<true, true> : field_cull_kernel<true, false>)
                                   : (smem_mins ? field_cull_kernel<false, true> : field_cull_kernel<false, false>);
  if (bytes > 48 * 1024) {  // above 48 KB only by opting in, on the current device
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<C, kThreads, bytes, stream>>>(source, smask, target, tmask, order, rotations, P, T, stat, q, cap, out,
                                         scratch, scanned);
  return static_cast<int>(cudaGetLastError());
}

// The sort keys of field_order: keys (P + T,) int32 from the clouds and masks of kss_field_cull.
extern "C" int kss_field_keys(const float* source, const unsigned char* smask, const float* target,
                              const unsigned char* tmask, int P, int T, int* keys, cudaStream_t stream) {
  if (P <= 0 || T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  field_keys_kernel<<<1, 1024, 0, stream>>>(source, smask, target, tmask, P, T, keys);
  return static_cast<int>(cudaGetLastError());
}
