// icp_update: the whole update of one lockstep ICP step after its nn1 launch, one launch for
// every lane.
//
// Replaces no Pallas TPU kernel: JAX's step (kss_icp_tpu/models/icp.py:191-300, its Kabsch at
// :61-114) is XLA under a vmapped while_loop, one fused program. The port's eager step
// (kss_icp_torch/ops/icp_cuda.py::icp_update_plain, the plain version) runs about a hundred small
// PyTorch launches a step and cuSOLVER's batched SVD, which waits on the device twice a call, so
// the host's work, not the device, set a step's pace.
//
// Per active lane l, with g = lane_ref[l] and the lane's N points:
//   keep   = mask & (d2 <= max_d2) [& (d2 <= threshold[l]) when trimmed];
//   w, cs, ct: the kept count and the centroids of cur and of the gathered target rows
//          target[g, idx]; H = sum (x - cs)(y - ct)^T / w, var = sum |x - cs|^2 / w (Umeyama), each
//          centred as models/icp.py::kabsch centres; mse = sum of the float32 squared distance
//          ((dx*dx + dy*dy) + dz*dz) / max(w, 1). All sums in float64, in a fixed order:
//          per-thread strided partials, a warp-shuffle tree, then the warps in index order, so a
//          lane's bits depend on its own inputs only, not on L;
//   dR, dt, ds: Kabsch / Umeyama from a one-sided cyclic Jacobi SVD of H in float64
//          (svd_rotation below; its float64 PyTorch model is ops/icp_cuda.py::svd3_jacobi);
//   the composition new = ds dR (s R x + t) + dt in float64, rounded once to float32;
//   PCL's gates on float32 dR, dt, ds and mse, as the plain version rounds them (transform,
//          rotation, scale, MSE; relative or absolute; never at iteration 0);
//   the state written in place (rot, trans, scale, corr_mse, iteration, converged, active), then
//          the next cur = s R x + t from the source, as rotate_points rounds it.
// A lane inactive on entry returns at once, so its state and cur keep their bits. Every lane
// still active after its update stores 1 in stop[parity]; block 0 zeroes stop[parity ^ 1], the
// flag the next launch (the other parity) sets. So a step needs no memset, and the host reads
// one int a step.
//
// What bounds it on an H100: the bytes of the lane's points, about 57 a point (mask, d2, idx,
// cur and the gathered target row read; the source read and cur written): 8192 lanes x 512
// points are 239 MB, 0.071 ms at 3.35 TB/s; and the one-thread 3 x 3 solve's
// latency in float64 (a few microseconds), which runs while the SM's other resident blocks
// stream their points. Design: one block a lane (128 threads striding over the points, the
// second pass over them from L1/L2), 8 blocks an SM. Built with -fmad=false (see _build.py) and
// written with explicit round-to-nearest intrinsics where float32 bits must equal the plain
// version's.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSweeps = 16;            // Jacobi sweeps at the most (3 x 3 in float64 stops in 4-6)
constexpr double kJacobiTol = 1e-15;   // rotate a column pair while |a_p . a_q| > tol |a_p| |a_q|
constexpr double kRankTol = 1e-12;     // a second column below tol * sigma_1 is rank deficiency
constexpr float kTinyF = 1.17549435e-38f;  // torch.finfo(torch.float32).tiny

struct Gates {
  float max_d2;     // max_correspondence_distance² in float32
  float trans_eps;  // transformation_epsilon
  float rot_eps;    // rotation_epsilon
  float mse_eps;    // euclidean_fitness_epsilon
  int relative_mse;
  int estimate_scale;
  int max_iterations;
};

// Sums each of K per-thread values over the block in a fixed order; every thread gets the totals.
template <int K>
__device__ __forceinline__ void block_sum(double (&v)[K], double* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) scratch[warp * K + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    double s = scratch[k];
    for (int w = 1; w < kWarps; ++w) s += scratch[w * K + k];
    v[k] = s;
  }
  __syncthreads();  // the scratch is free again
}

__device__ __forceinline__ bool kept(const unsigned char* mask, const float* d2, size_t i, float max_d2,
                                     const float* threshold, int lane) {
  const float d = d2[i];
  return mask[i] && d <= max_d2 && (threshold == nullptr || d <= threshold[lane]);
}

__device__ __forceinline__ void cross(const double a[3], const double b[3], double c[3]) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ double dot3(const double a[3], const double b[3]) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

__device__ __forceinline__ void swap_columns(double m[3][3], int p, int q) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const double x = m[i][p];
    m[i][p] = m[i][q];
    m[i][q] = x;
  }
}

// The proper rotation R = V diag(1, 1, d) U^T of Kabsch (d = det(V U^T)) for H = U S V^T, and
// trace(diag(1, 1, d) S), Umeyama's numerator. One-sided cyclic Jacobi on the columns of A = H V:
// each pair (p, q) is rotated until orthogonal, V accumulating the rotations; then the columns are
// sorted by norm, descending, sigma_j = |a_j|. U is completed from its first two columns, u3 =
// u1 x u2, so a planar (rank-2) H still gives the unique proper rotation, and a rank-1 H takes u2
// orthogonal to u1. With v3' = v1 x v2 (= det(V) v3), R = v1 u1^T + v2 u2^T + v3' u3^T, and
// d sigma_3 = det(V) (a3 . u3). H = 0 gives R = I and 0. ops/icp_cuda.py::svd3_jacobi is this
// function in PyTorch, operation for operation.
__device__ void svd_rotation(const double h[3][3], double r[3][3], double* trace_ds) {
  double a[3][3], v[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      a[i][j] = h[i][j];
      v[i][j] = i == j ? 1.0 : 0.0;
    }
  }
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    bool rotated = false;
#pragma unroll
    for (int pair = 0; pair < 3; ++pair) {
      const int p = pair == 2 ? 1 : 0, q = pair == 0 ? 1 : 2;
      const double alpha = (a[0][p] * a[0][p] + a[1][p] * a[1][p]) + a[2][p] * a[2][p];
      const double beta = (a[0][q] * a[0][q] + a[1][q] * a[1][q]) + a[2][q] * a[2][q];
      const double gamma = (a[0][p] * a[0][q] + a[1][p] * a[1][q]) + a[2][p] * a[2][q];
      if (!(fabs(gamma) > kJacobiTol * sqrt(alpha * beta))) continue;
      const double zeta = (beta - alpha) / (2.0 * gamma);
      const double t = copysign(1.0, zeta) / (fabs(zeta) + sqrt(1.0 + zeta * zeta));
      const double c = 1.0 / sqrt(1.0 + t * t);
      const double s = c * t;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const double ap = a[i][p], aq = a[i][q];
        a[i][p] = c * ap - s * aq;
        a[i][q] = s * ap + c * aq;
        const double vp = v[i][p], vq = v[i][q];
        v[i][p] = c * vp - s * vq;
        v[i][q] = s * vp + c * vq;
      }
      rotated = true;
    }
    if (!rotated) break;
  }
  double sig[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) sig[j] = sqrt((a[0][j] * a[0][j] + a[1][j] * a[1][j]) + a[2][j] * a[2][j]);
  // Descending, a strict compare: equal norms keep their order.
#pragma unroll
  for (int step = 0; step < 3; ++step) {
    const int p = step == 1 ? 1 : 0, q = p + 1;
    if (sig[p] < sig[q]) {
      const double x = sig[p];
      sig[p] = sig[q];
      sig[q] = x;
      swap_columns(a, p, q);
      swap_columns(v, p, q);
    }
  }
  if (!(sig[0] > 0.0)) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) r[i][j] = i == j ? 1.0 : 0.0;
    }
    *trace_ds = 0.0;
    return;
  }
  double u1[3], u2[3], u3[3], a2[3], a3[3], v1[3], v2[3], v3[3], v3p[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    u1[i] = a[i][0] / sig[0];
    a2[i] = a[i][1];
    a3[i] = a[i][2];
    v1[i] = v[i][0];
    v2[i] = v[i][1];
    v3[i] = v[i][2];
  }
  const double proj = dot3(a2, u1);
#pragma unroll
  for (int i = 0; i < 3; ++i) u2[i] = a2[i] - proj * u1[i];
  double n2 = sqrt(dot3(u2, u2));
  if (!(n2 > kRankTol * sig[0])) {  // rank 1: any unit vector orthogonal to u1
    const int k = fabs(u1[0]) <= fabs(u1[1]) ? (fabs(u1[0]) <= fabs(u1[2]) ? 0 : 2)
                                             : (fabs(u1[1]) <= fabs(u1[2]) ? 1 : 2);
    double e[3] = {0.0, 0.0, 0.0};
    e[k] = 1.0;
    cross(u1, e, u2);
    n2 = sqrt(dot3(u2, u2));
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) u2[i] = u2[i] / n2;
  cross(u1, u2, u3);
  cross(v1, v2, v3p);
  const double det_v = dot3(v3p, v3) < 0.0 ? -1.0 : 1.0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) r[i][j] = (v1[i] * u1[j] + v2[i] * u2[j]) + v3p[i] * u3[j];
  }
  *trace_ds = (sig[0] + sig[1]) + det_v * dot3(a3, u3);
}

__global__ void __launch_bounds__(kThreads, 8)
icp_update_kernel(float* __restrict__ cur, const float* __restrict__ d2, const int* __restrict__ idx,
                  const float* __restrict__ source, const unsigned char* __restrict__ mask,
                  const float* __restrict__ target, const int* __restrict__ lane_ref,
                  const float* __restrict__ threshold, float* __restrict__ rot, float* __restrict__ trans,
                  float* __restrict__ scale, float* __restrict__ corr_mse, int* __restrict__ iteration,
                  unsigned char* __restrict__ converged, unsigned char* __restrict__ active,
                  int* __restrict__ stop, int parity, int N, int G, int T, Gates gates) {
  __shared__ double scratch[kWarps * 10];
  __shared__ float next[13];  // the lane's new R (row-major), t, s
  const int l = blockIdx.x, tid = threadIdx.x;
  if (l == 0 && tid == 0) stop[parity ^ 1] = 0;
  if (!active[l]) return;  // uniform over the block
  const int g = lane_ref[l];
  const bool cloud = g >= 0 && g < G;  // a foreign lane_ref: no correspondence (nn1 gave NaN)
  const float* tg = target + static_cast<size_t>(cloud ? g : 0) * T * 3;
  const size_t base = static_cast<size_t>(l) * N;

  // Pass 1: the kept count, both sums of points and the squared distances.
  double s1[8] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int n = tid; n < N; n += kThreads) {
    const size_t i = base + n;
    if (!cloud || !kept(mask, d2, i, gates.max_d2, threshold, l)) continue;
    const int j = idx[i];
    if (j < 0 || j >= T) continue;
    const float x0 = cur[3 * i], x1 = cur[3 * i + 1], x2 = cur[3 * i + 2];
    const float* y = tg + 3 * static_cast<size_t>(j);
    const float y0 = y[0], y1 = y[1], y2 = y[2];
    s1[0] += 1.0;
    s1[1] += x0;
    s1[2] += x1;
    s1[3] += x2;
    s1[4] += y0;
    s1[5] += y1;
    s1[6] += y2;
    const float dx = __fsub_rn(x0, y0), dy = __fsub_rn(x1, y1), dz = __fsub_rn(x2, y2);
    s1[7] += __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  }
  block_sum<8>(s1, scratch);
  const double wsum = s1[0] > static_cast<double>(kTinyF) ? s1[0] : static_cast<double>(kTinyF);
  const double cs[3] = {s1[1] / wsum, s1[2] / wsum, s1[3] / wsum};
  const double ct[3] = {s1[4] / wsum, s1[5] / wsum, s1[6] / wsum};

  // Pass 2: the centred cross-covariance and the source's variance.
  double s2[10] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int n = tid; n < N; n += kThreads) {
    const size_t i = base + n;
    if (!cloud || !kept(mask, d2, i, gates.max_d2, threshold, l)) continue;
    const int j = idx[i];
    if (j < 0 || j >= T) continue;
    const float* y = tg + 3 * static_cast<size_t>(j);
    const double xs[3] = {cur[3 * i] - cs[0], cur[3 * i + 1] - cs[1], cur[3 * i + 2] - cs[2]};
    const double yt[3] = {y[0] - ct[0], y[1] - ct[1], y[2] - ct[2]};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) s2[3 * a + b] += xs[a] * yt[b];
    }
    s2[9] += dot3(xs, xs);
  }
  block_sum<10>(s2, scratch);

  if (tid == 0) {
    double h[3][3], dr[3][3], trace_ds;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) h[a][b] = s2[3 * a + b] / wsum;
    }
    svd_rotation(h, dr, &trace_ds);
    double ds = 1.0;
    if (gates.estimate_scale) {
      const double var = s2[9] / wsum;
      ds = trace_ds / (var > static_cast<double>(kTinyF) ? var : static_cast<double>(kTinyF));
    }
    double dt[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) dt[i] = ct[i] - ds * ((dr[i][0] * cs[0] + dr[i][1] * cs[1]) + dr[i][2] * cs[2]);
    // new = ds dR (s R x + t) + dt, from the lane's float32 state.
    float* rl = rot + 9 * static_cast<size_t>(l);
    float* tl = trans + 3 * static_cast<size_t>(l);
    double r0[3][3], t0[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      t0[i] = tl[i];
#pragma unroll
      for (int j = 0; j < 3; ++j) r0[i][j] = rl[3 * i + j];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        next[3 * i + k] = static_cast<float>((dr[i][0] * r0[0][k] + dr[i][1] * r0[1][k]) + dr[i][2] * r0[2][k]);
      }
      next[9 + i] = static_cast<float>(ds * ((dr[i][0] * t0[0] + dr[i][1] * t0[1]) + dr[i][2] * t0[2]) + dt[i]);
    }
    next[12] = static_cast<float>(ds * static_cast<double>(scale[l]));
    const float new_mse = static_cast<float>(s1[7] / (s1[0] > 1.0 ? s1[0] : 1.0));

    // PCL's gates in float32 on the rounded step, as the plain version takes them.
    const float t32[3] = {static_cast<float>(dt[0]), static_cast<float>(dt[1]), static_cast<float>(dt[2])};
    const float trans_delta2 =
        __fadd_rn(__fadd_rn(__fmul_rn(t32[0], t32[0]), __fmul_rn(t32[1], t32[1])), __fmul_rn(t32[2], t32[2]));
    const float trace = __fadd_rn(__fadd_rn(static_cast<float>(dr[0][0]), static_cast<float>(dr[1][1])),
                                  static_cast<float>(dr[2][2]));
    const float cos_angle = __fdiv_rn(__fsub_rn(trace, 1.0f), 2.0f);
    bool small = trans_delta2 < gates.trans_eps && __fsub_rn(1.0f, cos_angle) < gates.rot_eps;
    if (gates.estimate_scale) {
      const float e = __fsub_rn(static_cast<float>(ds), 1.0f);
      small = small && __fmul_rn(e, e) < gates.trans_eps;
    }
    float mse_delta = fabsf(__fsub_rn(new_mse, corr_mse[l]));
    if (gates.relative_mse) mse_delta = __fdiv_rn(mse_delta, new_mse < kTinyF ? kTinyF : new_mse);
    const bool conv = iteration[l] > 0 && (small || mse_delta < gates.mse_eps);
    const int it = iteration[l] + 1;
#pragma unroll
    for (int k = 0; k < 9; ++k) rl[k] = next[k];
#pragma unroll
    for (int i = 0; i < 3; ++i) tl[i] = next[9 + i];
    scale[l] = next[12];
    corr_mse[l] = new_mse;
    iteration[l] = it;
    converged[l] = conv ? 1 : 0;
    const bool still = it < gates.max_iterations && !conv;
    active[l] = still ? 1 : 0;
    if (still) stop[parity] = 1;
  }
  __syncthreads();

  // The next positions, s R x + t, rounded as kss_icp_torch/core/transforms.py::rotate_points.
  float rr[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) rr[k] = next[k];
  const float t0 = next[9], t1 = next[10], t2 = next[11], s = next[12];
  for (int n = tid; n < N; n += kThreads) {
    const size_t i = base + n;
    const float p0 = source[3 * i], p1 = source[3 * i + 1], p2 = source[3 * i + 2];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float q = __fadd_rn(__fadd_rn(__fmul_rn(rr[3 * a], p0), __fmul_rn(rr[3 * a + 1], p1)),
                                __fmul_rn(rr[3 * a + 2], p2));
      cur[3 * i + a] = __fadd_rn(__fmul_rn(s, q), a == 0 ? t0 : (a == 1 ? t1 : t2));
    }
  }
}

}  // namespace

// cur (L, N, 3) float32, read and written; d2 (L, N) float32 and idx (L, N) int32 from nn1;
// source (L, N, 3) float32; mask (L, N) uint8; target (G, T, 3) float32; lane_ref (L,) int32;
// threshold (L,) float32 or null (untrimmed); rot (L, 3, 3), trans (L, 3), scale (L,), corr_mse
// (L,) float32, iteration (L,) int32, converged and active (L,) uint8, all updated in place;
// stop (2,) int32: stop[parity] is set where a lane stays active, stop[parity ^ 1] zeroed.
extern "C" int kss_icp_update(float* cur, const float* d2, const int* idx, const float* source,
                              const unsigned char* mask, const float* target, const int* lane_ref,
                              const float* threshold, float* rot, float* trans, float* scale, float* corr_mse,
                              int* iteration, unsigned char* converged, unsigned char* active, int* stop, int L,
                              int N, int G, int T, float max_d2, float trans_eps, float rot_eps, float mse_eps,
                              int relative_mse, int estimate_scale, int max_iterations, int parity,
                              cudaStream_t stream) {
  if (L <= 0) return 0;
  if (N < 0 || G <= 0 || T <= 0 || (parity != 0 && parity != 1)) return static_cast<int>(cudaErrorInvalidValue);
  const Gates gates{max_d2, trans_eps, rot_eps, mse_eps, relative_mse, estimate_scale, max_iterations};
  icp_update_kernel<<<L, kThreads, 0, stream>>>(cur, d2, idx, source, mask, target, lane_ref, threshold, rot,
                                                trans, scale, corr_mse, iteration, converged, active, stop,
                                                parity, N, G, T, gates);
  return static_cast<int>(cudaGetLastError());
}
