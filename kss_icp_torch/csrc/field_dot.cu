// field_dot: the "ave" rotation field through the augmented dot product, on the tensor cores.
//
// Replaces the Pallas TPU kernel kss_icp_tpu/ops/coarse_pallas.py:218 (K1-dot,
// rotation_scores_pallas with method="dot", body _field_kernel at :48), the coarse_method="dot"
// field. Plain PyTorch version: kss_icp_torch/ops/coarse_cuda.py::field_dot_plain.
//
// For each rotation c: the mean over the valid source points p of
//   sqrt(max(min_t rel(p, t) + q2_p, 0)),   rel(p, t) = [R_c s_p, 1] . a_t
// with a_t = [-2 t m_t, |t|^2 or 1e30 where masked] and q2_p = (sx*sx + sy*sy) + sz*sz of the
// unrotated source; 0 with no valid source point. The TPU forms rel on its matrix unit with a
// K = 4 product: at precision "default" one bf16 pass, at "high" / "highest" six (HIGHEST).
// Here rel is a tensor-core product with bf16 operands and float32 accumulators:
//   - "default": both operands rounded to bf16 once (__float2bfloat16_rn), one product a
//     coordinate;
//   - "high" / "highest": each float32 operand split into three bf16 parts, hi = rn(x),
//     mid = rn(x - hi), lo = rn(x - hi - mid) (each remainder exact in float32), and the six
//     products hh, hm, mh, hl, mm, lh summed, the TPU's six bf16 passes. hi + mid + lo == x
//     exactly for every float32 x with 2^-110 <= |x| < 2^127 (1e30 included) and for x = 0:
//     below 2^-110 lo is subnormal in bf16 and may be flushed, near the float32 maximum hi
//     rounds to inf. The dropped products (ml, lm, ll) are below 2^-23 |x y|. The column that
//     carries |t|^2 has 1.0 on the source side (hi = 1, mid = lo = 0), so that term comes whole.
// The rotation q = R_c s rounds as rotate_points does, (r0*x + r1*y) + r2*z, each product and
// sum on its own (__fmul_rn, __fadd_rn; the library builds with -fmad=false).
//
// A deliberate divergence from the plain version: the tensor cores add the products in float32
// in their own order, with truncation, so rel is not the plain version's elementwise float32
// expansion bit for bit. The field is held to it at rtol 2e-5 (tests/test_torch_card.py,
// chip_smoke.py phase 3); repeated runs give the same bits, and a suffix-masked cloud its valid
// prefix's bits. Near coincident points (min + q2 ~ 0) the cancellation magnifies the
// accumulation error, as it does the plain version's rounding; the clamp at 0 is the contract's.
// The truncation is biased (each accumulation rounds toward zero, about half an ulp of the
// largest product, ~1 a coordinate): summed in one accumulator the six products moved the
// field 1.2e-4 from the plain version's, past the gate. So at "highest" the head hh, whose
// products have 16 significant bits and add exactly unless their exponents span more than ~8,
// goes to an accumulator of its own, the tail hm + mh + hl + mm + lh (~2^-8 of it, so its
// truncation is ~2^-32 of rel) to another, and head + tail is one float32 add rounded to
// nearest: rel within about an ulp, unbiased (an emulation of the truncation: 5e-6 of the
// plain field at the card tests' shapes).
//
// What bounds it on an H100: each evaluation (rotation, valid source point, valid target row) is
// one tensor-core output (bf16, 989e12 operations a second) and one float32 min on the CUDA
// cores, at "highest" also the head + tail add. The function's bound at "highest" is the cheaper
// route, 48 tensor-core operations and a min against the float32 3 mul + 3 add + 1 min
// (chip_smoke.py's bound); the kernel spends 16 (one m16n8k8 product) or 64 (four) tensor-core
// operations an output, the zero columns of the lane layout included, and its float32 min (and
// add) is the limit: one or two CUDA-core instructions an output, where one m16n8k8 instruction
// makes 128 outputs.
//
// Design:
//   - no operand pass: the kernel rotates the source, splits both operands and adds q2 itself;
//     the wrapper passes the raw clouds, masks and rotations (no (C, P, 3) tensor).
//   - only valid target rows are staged, compacted in order (a block-wide ballot and prefix);
//     a masked row's rel is ~1e30, never the min while one valid row exists, so the result is
//     the plain version's over every row. With no valid row every row is staged (each ~1e30),
//     as the plain version scans them. The staged rows are padded to a tile of 64 with copies of
//     the first, which leave the min unchanged. A block stages the whole target once (the main
//     path's 2048 rows: 96 KB at "highest", 32 KB at "default") with plain loads, since each row
//     is transformed on its way in (the split, and the fragment order below); a longer target is
//     walked in chunks, the running mins kept in a (C, P) scratch between chunks.
//   - an item is 64 source points of one rotation, a warp's four m16 tiles. Blocks are
//     persistent (the plan's grid, at most two an SM): block b holds rotations b, b + grid, ...;
//     its items, the (rotation, 64-point group) pairs over the groups with a valid point, go to
//     its warps in a fixed round robin.
//   - the product: m16n8k8 (mma.sync; the head and the tail's three at "highest", one at
//     "default"), A, the rotated and split source, from registers, B read from a
//     fragment-ordered copy of the staged target (conflict-free 4-byte loads, a word an 8-row
//     tile, each feeding the four m16 tiles). The columns a lane holds are laid out so that lane
//     t of each quad carries coordinate t (x, y, z, and 1 | |t|^2) in every word: each lane
//     rotates and splits one coordinate, and each word holds two bf16 values of that
//     coordinate (`words`). A warpgroup's wgmma took 2-23% longer at every main-path shape
//     (PERF.md §6, PR 16): its bf16 K of 16 doubles the zero columns of this layout, and the
//     compiler serialized its products against the min over the accumulators.
//   - the row min runs in registers over each accumulator tile, then across the quad; per point
//     sqrt(max(min + q2, 0)); per item four partial sums in float64 (a 16-row tile each, in a
//     fixed shuffle order) to a (C, groups, 4) scratch; after a barrier each block adds its
//     rotations' partials in index order in float64 and divides by max(n_valid, 1) once. Empty
//     groups write nothing and add nothing, so a suffix-masked cloud gives its prefix's bits.
//   - no fallback: a launch the card refuses returns its error to the wrapper, which raises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPoints = 64;  // source points an item
constexpr int kTileRows = 64;  // staged target rows are padded to a multiple of it
constexpr int kThreads = 256;  // a block: eight warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroups = 4096;  // 64-point groups a source may have: P <= 2^18
constexpr float kBig = 1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) { return bf16_bits(lo) | (bf16_bits(hi) << 16); }

// x = hi + mid + lo, each a bf16 value rounded to nearest from the remainder (exact in float32).
__device__ __forceinline__ void split3(float x, float& hi, float& mid, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(x));
  const float r = __fsub_rn(x, hi);
  mid = __bfloat162float(__float2bfloat16_rn(r));
  lo = __fsub_rn(r, mid);
}

// The words (two bf16 values, the lower first) of one operand value, word m = 0 .. kSteps - 1.
// At "highest" (kSteps 3) the source side's are (h, 0), (h, m), (l, 0) and the target side's
// (H, 0), (M, H), (L, M): the head product hh is source word 0 by target word 0, the tail
// hm + mh + hl + mm + lh source word 1 by target words 1 and 2 and source word 2 by target
// word 0. At "default" (kSteps 1) (bf16(x), 0) on both sides.
template <int kSteps, bool kSource>
__device__ __forceinline__ void words(float x, uint32_t (&w)[kSteps]) {
  if constexpr (kSteps == 1) {
    w[0] = pack(x, 0.f);
  } else {
    float h, m, l;
    split3(x, h, m, l);
    if constexpr (kSource) {
      w[0] = pack(h, 0.f);
      w[1] = pack(h, m);
      w[2] = pack(l, 0.f);
    } else {
      w[0] = pack(h, 0.f);
      w[1] = pack(m, h);
      w[2] = pack(l, m);
    }
  }
}

// Coordinate t of R s_p as rotate_points rounds it; 1 for t = 3.
__device__ __forceinline__ float rotated(const float* __restrict__ r, float x, float y, float z, int t) {
  if (t == 3) return 1.f;
  return __fadd_rn(__fadd_rn(__fmul_rn(r[3 * t], x), __fmul_rn(r[3 * t + 1], y)), __fmul_rn(r[3 * t + 2], z));
}

// Coordinate t of the augmented target row: -2 t m, then |t|^2 or 1e30 where masked.
__device__ __forceinline__ float augmented(const float* __restrict__ target, bool valid, int row, int t) {
  const float* p = target + static_cast<size_t>(row) * 3;
  if (t < 3) return __fmul_rn(__fmul_rn(-2.f, p[t]), valid ? 1.f : 0.f);
  if (!valid) return kBig;
  return __fadd_rn(__fadd_rn(__fmul_rn(p[0], p[0]), __fmul_rn(p[1], p[1])), __fmul_rn(p[2], p[2]));
}

// One ordered compaction round over the block: each thread's flag; returns the flag's index among
// this round's set flags and sets `total` to their count. Two barriers.
__device__ __forceinline__ int compact_round(bool flag, int* warp_count, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned b = __ballot_sync(kFull, flag);
  if (lane == 0) warp_count[warp] = __popc(b);
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int n = warp_count[w];
    before += w < warp ? n : 0;
    total += n;
  }
  __syncthreads();
  return before + __popc(b & ((1u << lane) - 1u));
}

// Where word m of row n and coordinate t of the staged target lives, in 32-bit words: per 8-row
// tile, lane 4 (n % 8) + t's kSteps words, consecutive (the m16n8k8 B fragment of that lane).
template <int kSteps>
__device__ __forceinline__ int word_at(int n, int t, int m) {
  return ((n >> 3) * 32 + (n & 7) * 4 + t) * kSteps + m;
}

// Stages the target rows whose index among the staged set (the valid rows, or every row on the
// biased path) lies in [base, base + cap) into `b`, padded to kTileRows with the first's words;
// returns the chunk's row count. Ends with a barrier.
template <int kSteps>
__device__ int stage(const float* __restrict__ target, const unsigned char* __restrict__ tmask, int T, bool biased,
                     int base, int cap, uint32_t* b, int* warp_count, int* first_row) {
  const int tid = threadIdx.x;
  int seen = 0;
  for (int r0 = 0; r0 < T; r0 += kThreads) {
    const int r = r0 + tid;
    const bool take = r < T && (biased || tmask[r]);
    int total;
    const int idx = seen + compact_round(take, warp_count, total);
    if (take && idx >= base && idx < base + cap) {
      const int n = idx - base;
      if (n == 0) *first_row = r;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        uint32_t w[kSteps];
        words<kSteps, false>(augmented(target, !biased, r, t), w);
#pragma unroll
        for (int m = 0; m < kSteps; ++m) b[word_at<kSteps>(n, t, m)] = w[m];
      }
    }
    seen += total;
  }
  const int rows = min(cap, seen - base);
  const int padded = (rows + kTileRows - 1) / kTileRows * kTileRows;
  __syncthreads();  // *first_row written
  for (int n = rows + tid; n < padded; n += kThreads) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      uint32_t w[kSteps];
      words<kSteps, false>(augmented(target, !biased, *first_row, t), w);
#pragma unroll
      for (int m = 0; m < kSteps; ++m) b[word_at<kSteps>(n, t, m)] = w[m];
    }
  }
  __syncthreads();
  return rows;
}

// D (16 x 8) = A (16 x 8, bf16) B (8 x 8, bf16), float32 accumulators from zero.
__device__ __forceinline__ void mma_k8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %7, %7, %7};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0), "f"(0.f));
}

// D (16 x 8) += A (16 x 8) B (8 x 8).
__device__ __forceinline__ void mma_k8_acc(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// The running mins of rows g and g + 8 of the warp's four m16 tiles over `rows` staged rows:
// per 8-row tile, the head (and at "highest" the tail, added into it rounded to nearest) of
// each m16 tile; element i of a tile is row g for i < 2, row g + 8 otherwise.
template <int kSteps>
__device__ __forceinline__ void scan(const uint32_t (&a)[4][2][kSteps], const uint32_t* b, int rows,
                                     float (&mn)[4][2]) {
  const int lane = threadIdx.x & 31;
  const uint32_t* p = b + lane * kSteps;
  const int n8 = rows / 8;
#pragma unroll 2
  for (int j = 0; j < n8; ++j, p += 32 * kSteps) {
    uint32_t w[kSteps];
#pragma unroll
    for (int m = 0; m < kSteps; ++m) w[m] = p[m];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      float d[4];
      mma_k8(d, a[mt][0][0], a[mt][1][0], w[0]);
      if constexpr (kSteps == 3) {
        float e[4];
        mma_k8(e, a[mt][0][1], a[mt][1][1], w[1]);
        mma_k8_acc(e, a[mt][0][1], a[mt][1][1], w[2]);
        mma_k8_acc(e, a[mt][0][2], a[mt][1][2], w[0]);
#pragma unroll
        for (int i = 0; i < 4; ++i) d[i] = __fadd_rn(d[i], e[i]);
      }
      mn[mt][0] = fminf(mn[mt][0], fminf(d[0], d[1]));
      mn[mt][1] = fminf(mn[mt][1], fminf(d[2], d[3]));
    }
  }
}

// Point of row g (h = 0) or g + 8 (h = 1) of m16 tile `mt` of group `grp`.
__device__ __forceinline__ int point_of(int grp, int mt, int h) {
  return grp * kPoints + mt * 16 + ((threadIdx.x & 31) >> 2) + 8 * h;
}

// The sum, in float64 and a fixed order, of one m16 tile's values (rows g and g + 8 of each
// quad's lane 0, whose mins are the quad's); the result in every lane.
__device__ __forceinline__ double tile_sum(const float (&mn)[2], const float (&q2)[2], const bool (&valid)[2]) {
  double s = 0.0;
  if ((threadIdx.x & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (valid[h]) s += static_cast<double>(sqrtf(fmaxf(__fadd_rn(mn[h], q2[h]), 0.f)));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  return s;
}

// Grid: the plan's persistent blocks, at most two an SM (128 registers a thread). kSteps: the
// words an operand value takes, 3 at "highest", 1 at "default".
template <int kSteps>
__global__ void __launch_bounds__(kThreads, 2)
field_dot_kernel(const float* __restrict__ source, const unsigned char* __restrict__ smask,
                 const float* __restrict__ target, const unsigned char* __restrict__ tmask,
                 const float* __restrict__ rotations, int C, int P, int T, int cap, float* __restrict__ out,
                 double* __restrict__ partial, float* __restrict__ mins) {
  extern __shared__ uint32_t b[];
  __shared__ int warp_count[kWarps];
  __shared__ int first_row;
  __shared__ unsigned short groups_list[kMaxGroups];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, t = lane & 3;
  const int G = (P + kPoints - 1) / kPoints;

  // The groups of 64 points with a valid point, in order; the valid points; the valid rows.
  int gv = 0, ns = 0, m = 0;
  for (int g0 = 0; g0 < G; g0 += kThreads) {
    const int g = g0 + tid;
    bool any = false;
    if (g < G)
      for (int i = g * kPoints; i < min(P, (g + 1) * kPoints); ++i) any |= smask[i] != 0;
    int total;
    const int idx = gv + compact_round(any, warp_count, total);
    if (any) groups_list[idx] = static_cast<unsigned short>(g);
    gv += total;
  }
  for (int i = 0; i < max(P, T); i += kThreads) {
    ns += __syncthreads_count(i + tid < P && smask[i + tid]);
    m += __syncthreads_count(i + tid < T && tmask[i + tid]);
  }
  const bool biased = m == 0;
  const int rows_n = biased ? T : m;
  const int rot_n = C > static_cast<int>(blockIdx.x) ? (C - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int items = rot_n * gv;
  const int chunks = (rows_n + cap - 1) / cap;

  for (int chunk = 0; chunk < chunks; ++chunk) {
    __syncthreads();  // every warp is done with the last chunk
    const int rows = stage<kSteps>(target, tmask, T, biased, chunk * cap, cap, b, warp_count, &first_row);
    const int padded = (rows + kTileRows - 1) / kTileRows * kTileRows;
    const bool last = chunk == chunks - 1;
    for (int item = warp; item < items; item += kWarps) {
      const int c = blockIdx.x + (item / gv) * gridDim.x;
      const int grp = groups_list[item % gv];
      const float* r = rotations + static_cast<size_t>(c) * 9;
      // This lane's points: rows g and g + 8 of the item's four m16 tiles.
      uint32_t a[4][2][kSteps];
      float mn[4][2], q2[4][2];
      bool valid[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = point_of(grp, mt, h);
          valid[mt][h] = p < P && smask[p];
          float x = 0.f, y = 0.f, z = 0.f;
          if (p < P) {
            x = source[static_cast<size_t>(p) * 3];
            y = source[static_cast<size_t>(p) * 3 + 1];
            z = source[static_cast<size_t>(p) * 3 + 2];
          }
          q2[mt][h] = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
          words<kSteps, true>(rotated(r, x, y, z, t), a[mt][h]);
          mn[mt][h] = chunk > 0 && valid[mt][h] ? mins[static_cast<size_t>(c) * P + p] : inf();
        }
      }
      scan<kSteps>(a, b, padded, mn);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mn[mt][h] = fminf(mn[mt][h], __shfl_xor_sync(kFull, mn[mt][h], 1));
          mn[mt][h] = fminf(mn[mt][h], __shfl_xor_sync(kFull, mn[mt][h], 2));
        }
        if (!last) {
          if (t == 0)
            for (int h = 0; h < 2; ++h)
              if (valid[mt][h]) mins[static_cast<size_t>(c) * P + point_of(grp, mt, h)] = mn[mt][h];
          continue;
        }
        const double s = tile_sum(mn[mt], q2[mt], valid[mt]);
        if (lane == 0) partial[(static_cast<size_t>(c) * G + item % gv) * 4 + mt] = s;
      }
    }
  }
  __syncthreads();  // every partial written

  // Each rotation of the block: its 4 gv partials added in index order (lane-strided, then a
  // fixed shuffle tree), over max(n_valid, 1).
  for (int k = warp; k < rot_n; k += kWarps) {
    const int c = blockIdx.x + k * gridDim.x;
    const double* p = partial + static_cast<size_t>(c) * G * 4;
    double s = 0.0;
    for (int i = lane; i < gv * 4; i += 32) s += p[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
    if (lane == 0) out[c] = __fdiv_rn(__double2float_rn(s), static_cast<float>(max(ns, 1)));
  }
}

template <int kSteps>
int launch(const float* source, const unsigned char* smask, const float* target, const unsigned char* tmask,
           const float* rotations, int C, int P, int T, int blocks, int cap, float* out, double* partial, float* mins,
           cudaStream_t stream) {
  auto kernel = field_dot_kernel<kSteps>;
  const size_t bytes = static_cast<size_t>(cap) * 4 * kSteps * 4;  // 4 coordinates' words a row
  if (bytes > 48 * 1024) {  // above 48 KB only by opting in, on the current device
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, kThreads, bytes, stream>>>(source, smask, target, tmask, rotations, C, P, T, cap, out, partial,
                                              mins);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// source (P, 3), target (T, 3), rotations (C, 3, 3) float32; smask (P,), tmask (T,) uint8;
// bf16 1 at "default" (one bf16 pass), 0 at "high" / "highest" (six); blocks: the persistent
// grid; cap: target rows a block stages at once (a multiple of 64); out (C,) float32; partial
// (C, ceil(P / 64), 4) float64 scratch; mins: null when the target fits one chunk (T <= cap),
// else (C, P) float32 scratch.
extern "C" int kss_field_dot(const float* source, const unsigned char* smask, const float* target,
                             const unsigned char* tmask, const float* rotations, int C, int P, int T, int bf16,
                             int blocks, int cap, float* out, double* partial, float* mins, cudaStream_t stream) {
  if (C <= 0) return 0;
  if (C > 65535 || P <= 0 || T <= 0 || (P + kPoints - 1) / kPoints > kMaxGroups || blocks <= 0 || cap <= 0 ||
      cap % kTileRows != 0 || (mins == nullptr && T > cap))
    return static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? launch<1>(source, smask, target, tmask, rotations, C, P, T, blocks, cap, out, partial, mins, stream)
              : launch<3>(source, smask, target, tmask, rotations, C, P, T, blocks, cap, out, partial, mins, stream);
}
