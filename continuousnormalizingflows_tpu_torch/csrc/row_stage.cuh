// The same dynamics stage as stage.cuh, one row per thread with the row's
// activations in registers: the path for narrow nets (h <= 32), the
// reference-default widths (h = 4 * n_in) of low-dimensional flows.
//
// Why a second path: at h = 24 the tiled block products of stage.cuh spend
// most of their time on block-wide synchronisation and on threads idle in the
// narrow products (N = nz).  Here a thread computes its row's whole stage
// with no synchronisation: each hidden vector (h1, s1, z2, ...) is an array
// of H registers, and every weight row is read from shared memory as float4
// broadcasts (all threads of a warp read the same address), so a product
// issues one 16-byte load per 4 FMAs.  The weights are staged once per block,
// zero-padded to H in every hidden dimension: a multiple of 4 for the
// forward kernels K1, K3, K5 and K6's replay (row_fwd_H), of 8 for the
// backwards (row_H).  Padded units have zero weights in and out, so they add
// exact zeros (fmaf(a, 0, acc) == acc) and a net gives the same bits at
// either H: K3 and K4's trajectory, which share row_rk4_step, compute the
// same states, and K6's walk recomputes K5's stages.
//
// Sums run over the same index in the same order as stage.cuh, so the two
// paths give the same result for the same row.
#pragma once

#include "stage.cuh"

namespace cnf {

constexpr int kRowMaxH = 32;

// H of the backwards for a hidden width h (0: too wide for this path): a
// multiple of 8, for their 8 x 8 dA2 grid (row_stage_bwd.cuh)
__host__ __device__ inline int row_H(int h) {
  return h <= 8 ? 8 : h <= 16 ? 16 : h <= 24 ? 24 : h <= kRowMaxH ? 32 : 0;
}

// H of the forward kernels K1, K3, K5 and K6's replay: h rounded up to the
// float4 of a weight row (h = 12, the FFJORD form's width, takes 12, not 16)
__host__ __device__ inline int row_fwd_H(int h) {
  return h <= kRowMaxH ? (h + 3) / 4 * 4 : 0;
}

__host__ __device__ inline long row_weight_floats(const Dims& d, int H) {
  return (long)d.n_in * H + 2L * H * H + (long)d.n_out * H + 2L * H + d.n_out;
}

// Staged weights, row-major, every hidden dimension padded to H:
// W1t (n_in, H) = A1^T, W2t (H, H) = A2^T, A2 (H, H), A3 (n_out, H).
struct RowWeights {
  const float* W1t;
  const float* W2t;
  const float* A2;
  const float* A3;
  const float* b1;  // (H)
  const float* b2;  // (H)
  const float* b3;  // (n_out)
};

// Stages the weights (from their nn.Linear layout) at p, rounded to bf16 when
// BF16: they are product operands only.  Needs a __syncthreads() after.
template <int H, bool BF16>
__device__ inline RowWeights stage_row_weights(const Weights& g, const Dims& d, float* p) {
  const int n_in = d.n_in, h = d.h, n_out = d.n_out;
  float* W1t = p; p += n_in * H;
  float* W2t = p; p += H * H;
  float* A2 = p;  p += H * H;
  float* A3 = p;  p += n_out * H;
  float* b1 = p;  p += H;
  float* b2 = p;  p += H;
  float* b3 = p;
  for (int idx = threadIdx.x; idx < n_in * H; idx += blockDim.x) {
    const int i = idx / H, j = idx - i * H;
    W1t[idx] = j < h ? rnd<BF16>(__ldg(g.A1 + j * n_in + i)) : 0.0f;
  }
  for (int idx = threadIdx.x; idx < H * H; idx += blockDim.x) {
    const int a = idx / H, b = idx - a * H;
    const bool in = a < h && b < h;
    W2t[idx] = in ? rnd<BF16>(__ldg(g.A2 + b * h + a)) : 0.0f;
    A2[idx] = in ? rnd<BF16>(__ldg(g.A2 + a * h + b)) : 0.0f;
  }
  for (int idx = threadIdx.x; idx < n_out * H; idx += blockDim.x) {
    const int o = idx / H, k = idx - o * H;
    A3[idx] = k < h ? rnd<BF16>(__ldg(g.A3 + o * h + k)) : 0.0f;
  }
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    b1[j] = j < h ? __ldg(g.b1 + j) : 0.0f;
    b2[j] = j < h ? __ldg(g.b2 + j) : 0.0f;
  }
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) b3[o] = __ldg(g.b3 + o);
  return RowWeights{W1t, W2t, A2, A3, b1, b2, b3};
}

// acc[4q..4q+3] += a * row[q]  for a row of H weights
template <int H>
__device__ __forceinline__ void axpy_row(float a, const float* row, float (&acc)[H]) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int q = 0; q < H / 4; ++q) {
    const float4 v = r4[q];
    acc[4 * q + 0] = fmaf(a, v.x, acc[4 * q + 0]);
    acc[4 * q + 1] = fmaf(a, v.y, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(a, v.z, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(a, v.w, acc[4 * q + 3]);
  }
}

// sum_k v[k] * row[k], in order of k: one chain of H FMAs.  Units padded
// with zeros add exact zeros at its end, so the dot does not depend on H.
template <int H>
__device__ __forceinline__ float dot_row(const float (&v)[H], const float* row) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  float acc = 0.0f;
#pragma unroll
  for (int q = 0; q < H / 4; ++q) {
    const float4 w = r4[q];
    acc = fmaf(v[4 * q + 0], w.x, acc);
    acc = fmaf(v[4 * q + 1], w.y, acc);
    acc = fmaf(v[4 * q + 2], w.z, acc);
    acc = fmaf(v[4 * q + 3], w.w, acc);
  }
  return acc;
}

// One stage for one row: reads x (n_in) and eps (nz); writes y (n_out) and,
// when e is not null, e_z (nz); returns div, |y|, |e_z|.  Pointers may be to
// global or shared memory.
template <int H, bool BF16>
__device__ __forceinline__ void row_stage(const RowWeights& w, const Dims& d, const float* x,
                                          const float* eps, float* y, float* e, float& div,
                                          float& ry, float& re) {
  float s1[H], t[H], u[H];
  // layer 1: t = z1 -> s1, h1
#pragma unroll
  for (int j = 0; j < H; ++j) t[j] = 0.0f;
  for (int i = 0; i < d.n_in; ++i) axpy_row<H>(rnd<BF16>(x[i]), w.W1t + i * H, t);
#pragma unroll
  for (int j = 0; j < H; ++j) {
    float sp;
    gates(t[j] + w.b1[j], s1[j], sp);
    t[j] = rnd<BF16>(sp);
  }
  // layer 2: u = z2 -> u = s2, t = h2
#pragma unroll
  for (int j = 0; j < H; ++j) u[j] = 0.0f;
#pragma unroll
  for (int j = 0; j < H; ++j) axpy_row<H>(t[j], w.W2t + j * H, u);
#pragma unroll
  for (int k = 0; k < H; ++k) {
    float sp;
    gates(u[k] + w.b2[k], u[k], sp);
    t[k] = rnd<BF16>(sp);
  }
  // layer 3: y = A3 h2 + b3
  float yy = 0.0f;
  for (int o = 0; o < d.n_out; ++o) {
    const float yo = dot_row<H>(t, w.A3 + o * H) + w.b3[o];
    y[o] = yo;
    yy = fmaf(yo, yo, yy);
  }
  // d2 = (A3^T eps) * s2, into t
#pragma unroll
  for (int k = 0; k < H; ++k) t[k] = 0.0f;
  for (int o = 0; o < d.nz; ++o) axpy_row<H>(rnd<BF16>(eps[o]), w.A3 + o * H, t);
#pragma unroll
  for (int k = 0; k < H; ++k) t[k] = rnd<BF16>(t[k] * u[k]);
  // d1 = (A2^T d2) * s1, into u
#pragma unroll
  for (int j = 0; j < H; ++j) u[j] = 0.0f;
#pragma unroll
  for (int k = 0; k < H; ++k) axpy_row<H>(t[k], w.A2 + k * H, u);
#pragma unroll
  for (int j = 0; j < H; ++j) u[j] = rnd<BF16>(u[j] * s1[j]);
  // e_z = (A1^T d1)[:nz], and the reductions
  float dv = 0.0f, ee = 0.0f;
  for (int i = 0; i < d.nz; ++i) {
    const float ei = dot_row<H>(u, w.W1t + i * H);
    if (e != nullptr) e[i] = ei;
    dv = fmaf(ei, eps[i], dv);
    ee = fmaf(ei, ei, ee);
  }
  div = dv;
  ry = sqrtf(yy + 1e-20f);
  re = sqrtf(ee + 1e-20f);
}

// One RK4 step of one row from time t: u <- u + dt/6 (k1 + 2 k2 + 2 k3 + k4)
// over the first ncols state columns of U (sd: the whole state
// [z, dlogp, E, n]; nz: the z columns, the only ones a stage reads).  X is
// the net input with ys in place, ACC scratch of ncols floats.  The step of
// K3's row path, and of the trajectory K4's row path walks back.
template <int H, bool BF16>
__device__ __forceinline__ void row_rk4_step(const RowWeights& w, const Dims& d, float* X,
                                             const float* eps, float* Y, float* U, float* ACC,
                                             int ncols, int t_col, float t, float dt) {
  const int nz = d.nz;
  const float half = 0.5f * dt;
  for (int c = 0; c < nz; ++c) X[c] = U[c];
  if (t_col >= 0) X[t_col] = t;
  // stages at (t, u), (t + dt/2, u + dt/2 k1), (t + dt/2, u + dt/2 k2), (t + dt, u + dt k3)
  for (int st = 0; st < 4; ++st) {
    float dv, ry, re;
    row_stage<H, BF16>(w, d, X, eps, Y, nullptr, dv, ry, re);
    const float step = st == 2 ? dt : half;
    for (int c = 0; c < ncols; ++c) {
      const float k = c < nz ? Y[c] : c == nz ? -dv : c == nz + 1 ? ry : re;
      if (st == 3) {
        U[c] = U[c] + (dt / 6.0f) * (ACC[c] + k);
      } else {
        ACC[c] = st == 0 ? k : ACC[c] + 2.0f * k;
        if (c < nz) X[c] = U[c] + step * k;
      }
    }
    if (st < 3 && t_col >= 0) X[t_col] = t + step;
  }
}

// Launch shape of a kernel: the row path (H > 0, `rows` threads per block,
// one row each) or the tiled path (H == 0, `rows` rows per block).
struct Choice {
  int H;
  int rows;
  int smem_bytes;
  bool staged;
};

// sd: state width of the whole-solve kernel (its per-row state lives in
// shared memory), 0 for the single-stage kernel.
inline Choice choose(const Dims& d, int sd) {
  const int H = row_fwd_H(d.h);
  const long wf = H ? row_weight_floats(d, H) : 0;
  if (H && 4 * wf <= kStageWeightsBytes) {
    const long per_thread = sd ? odd(2 * sd + d.n_in + d.n_out + d.nz) : 0;
    long threads = kThreads;
    if (per_thread) threads = ((kBlockBudgetBytes / 4 - wf) / per_thread) / 32 * 32;
    if (threads > kThreads) threads = kThreads;
    if (threads >= 32) return Choice{H, (int)threads, (int)(4 * (wf + threads * per_thread)), true};
  }
  const Plan p = make_plan(d, 2 * sd);
  return Choice{0, p.rows, p.smem_bytes, p.staged};
}

}  // namespace cnf
