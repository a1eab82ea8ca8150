// The backward of one dynamics stage (stage.cuh) with one row per thread:
// the path for narrow nets of the per-stage backward (fused_dynamics_bwd.cu,
// K2: h <= 24), the whole-solve RK4 backward (fused_solve_bwd.cu, K4: h <= 32)
// and the walk of the adaptive solve's backward (fused_adaptive_bwd.cu, K6:
// h <= 32), beside the tiled stage_bwd.cuh that the three take at wider nets.
//
// The chain is the one written at the top of stage_bwd.cuh, with the same
// sums in the same order, so for one row the two paths do the same
// arithmetic.  What differs is where the values live:
//   * the accumulators of a product (H floats) are in registers, and every
//     weight row is read from shared memory as float4 broadcasts
//     (row_stage.cuh: the same staged weights, no new copy);
//   * the forward intermediates the chain reads again (s1, s2, u1, u2) and
//     the vectors of the weight-gradient outer products (x, z1_t, d1, ebar_t,
//     h1, z2_t, d2, u1bar, h2, ybar_t, eps, u2bar) are kept in shared
//     memory as columns laid out [unit][row] with a row stride of
//     kRowBwdThreads + 4: a thread's own accesses fall on distinct banks,
//     and the float4 reads of the weight-gradient pass (4 rows of one unit)
//     from 8 threads of distinct units fall on distinct bank groups;
//   * u2 = A3^T eps does not depend on the stage input (eps is fixed for a
//     whole solve), so the caller computes it once per row (row_keep_u2).
// These columns take ~1.5 KB a row at h = 24, so an SM holds two blocks of
// 64 rows: 4 warps, one a scheduler.  Nothing hides a stall, which sets the
// shape of the code below (see the notes at load_col and dots).
//
// Weight gradients: after each stage's backward the block synchronises and
// its threads sum each entry of the parameter vector over the block's rows
// in row order (row_accumulate_wgrads, dA2 in register tiles) into the
// block's own row of partial sums, which stage_bwd.cuh's reduce_partials
// adds in order of block.  No atomics: the same inputs give the same bits on
// every run.
//
// precision: BF16 rounds both operands of every product, the weight-gradient
// outer products included, at the places row_stage.cuh and stage_bwd.cuh
// round them.
#pragma once

#include "row_stage.cuh"
#include "stage_bwd.cuh"

namespace cnf {

constexpr int kRowBwdThreads = 64;               // rows (threads) of a block
constexpr int kRowLd = kRowBwdThreads + 4;       // row stride of the column buffers
constexpr int kTrajThreads = 128;                // the trajectory kernel's block
constexpr long kRowBwdSmemBytes = 227L * 1024;

// Column buffers of a block, element (unit, row) at [unit * kRowLd + row].
struct RowCols {
  float* S1;   // (H) sigmoid(z1)
  float* S2;   // (H) sigmoid(z2)
  float* H1;   // (H) softplus(z1), bf16-rounded when BF16
  float* H2;   // (H) softplus(z2), likewise
  float* U1;   // (H) u1 = A2^T d2, then z1_b, then z1_t
  float* D1;   // (H) d1
  float* D2;   // (H) d2
  float* U2;   // (H) u2 = A3^T eps, fixed for the solve
  float* Z2;   // (H) z2_t
  float* G1;   // (H) u1bar
  float* G2;   // (H) u2bar
  float* X;    // (n_in)  the stage input
  float* EPS;  // (nz)    the probe
  float* EB;   // (nz)    ebar_t
  float* YB;   // (n_out) ybar, then ybar_t
  float* ONE;  // (1) ones: a bias gradient is a sum against it
  float* ZERO; // (1) zeros: the absent second term of a gradient entry

  // the same buffers offset to row r
  __device__ RowCols at(int r) const {
    return RowCols{S1 + r, S2 + r, H1 + r, H2 + r, U1 + r, D1 + r, D2 + r, U2 + r,
                   Z2 + r, G1 + r, G2 + r, X + r,  EPS + r, EB + r, YB + r, ONE + r, ZERO + r};
  }
};

__host__ __device__ inline int row_bwd_units(const Dims& d, int H) {
  return 11 * H + d.n_in + 2 * d.nz + d.n_out + 2;
}

__host__ __device__ inline long round4(long n) { return (n + 3) & ~3L; }

// Launch plan of a kernel on the row path: H > 0 and the block's
// shared-memory bytes when the widths take it (h <= 32, the staged weights
// within kStageWeightsBytes, the block within 227 KB), else H = 0 (tiled
// path).  A block holds the staged weights, its P weight-gradient sums, the
// column buffers and, per thread, own_ld floats of the caller's own state.
struct RowBwdPlan {
  int H;
  int smem_bytes;
};

inline RowBwdPlan row_bwd_plan(const Dims& d, int own_ld) {
  const int H = row_H(d.h);
  if (H == 0) return RowBwdPlan{0, 0};
  const long wf = row_weight_floats(d, H);
  if (4 * wf > kStageWeightsBytes) return RowBwdPlan{0, 0};
  const long floats = round4(wf) + round4(param_count(d)) + (long)row_bwd_units(d, H) * kRowLd +
                      (long)kRowBwdThreads * own_ld;
  if (4 * floats > kRowBwdSmemBytes) return RowBwdPlan{0, 0};
  return RowBwdPlan{H, (int)(4 * floats)};
}

// Blocks of a launch whose blocks take 64-row tiles in turn: a block for
// every tile, at most as many as the card holds at once, so the weights are
// staged, and a row of partial sums written, once a block and not once a
// tile.  An SM holds what its 228 KB of shared memory allow (a block takes
// 1 KB beyond its own), at most 4: 4 blocks of 64 threads fit its registers
// whatever a thread takes.
inline int row_bwd_grid(int B, int smem_bytes) {
  const long tiles = ((long)B + kRowBwdThreads - 1) / kRowBwdThreads;
  long per_sm = 228L * 1024 / (smem_bytes + 1024);
  per_sm = per_sm < 1 ? 1 : per_sm > 4 ? 4 : per_sm;
  return (int)(tiles < kSMs * per_sm ? tiles : kSMs * per_sm);
}

// Carves the column buffers for widths d from p (16-byte aligned); returns
// the next free float.  Plain pointer arithmetic from the shared array, so
// the compiler keeps every access a shared-memory one.
__device__ __forceinline__ float* carve_row_cols(float* p, int H, const Dims& d, RowCols& c) {
  const int n = H * kRowLd;
  c.S1 = p;
  c.S2 = p + n;
  c.H1 = p + 2 * n;
  c.H2 = p + 3 * n;
  c.U1 = p + 4 * n;
  c.D1 = p + 5 * n;
  c.D2 = p + 6 * n;
  c.U2 = p + 7 * n;
  c.Z2 = p + 8 * n;
  c.G1 = p + 9 * n;
  c.G2 = p + 10 * n;
  p += 11 * n;
  c.X = p;   p += d.n_in * kRowLd;
  c.EPS = p; p += d.nz * kRowLd;
  c.EB = p;  p += d.nz * kRowLd;
  c.YB = p;  p += d.n_out * kRowLd;
  c.ONE = p; p += kRowLd;
  c.ZERO = p; p += kRowLd;
  return p;
}

// u2 = A3^T eps for one row (c: this row's columns), as row_stage sums it.
template <int H, bool BF16>
__device__ __forceinline__ void row_keep_u2(const RowWeights& w, const Dims& d, const RowCols& c) {
  float u2[H];
#pragma unroll
  for (int k = 0; k < H; ++k) u2[k] = 0.0f;
  for (int o = 0; o < d.nz; ++o) axpy_row<H>(rnd<BF16>(c.EPS[o * kRowLd]), w.A3 + o * H, u2);
#pragma unroll
  for (int k = 0; k < H; ++k) c.U2[k * kRowLd] = u2[k];
}

// Loads one H-vector of this row's columns (unit j at v[j * kRowLd]) into
// registers, before the loop that stores: the columns and the weights share
// one shared-memory array, so the compiler does not move a load above a
// store.
//
// The four H x H products of the keep and the backward run as loops over
// the operand's units (unrolled by 4 only), the operand read from its
// column: fully unrolled, each is ~720 instructions, and a stage's keep,
// backward and weight-gradient pass then outgrow the instruction cache,
// which the few warps an SM (shared memory allows 4) cannot hide.
//
// With so few warps, dependent chains show in full: the dots (y, e_z,
// epsbar, xbar) run two at a time (dots below), and the weight-gradient
// entries four at a time, each sum still in its own order.
template <int H>
__device__ __forceinline__ void load_col(const float* v, float (&r)[H]) {
#pragma unroll
  for (int j = 0; j < H; ++j) r[j] = v[j * kRowLd];
}

template <int H>
__device__ __forceinline__ void load_row(const float* v, float (&r)[H]) {
#pragma unroll
  for (int j = 0; j < H; ++j) r[j] = v[j];
}

// f(o, v . rows[o]) for o in [0, n), in order of o: the dots two at a time
// (independent chains), each summed in order of k as dot_row sums it.
template <int H, class F>
__device__ __forceinline__ void dots(const float (&v)[H], const float* rows, int n, F f) {
  int o = 0;
  for (; o + 1 < n; o += 2) {
    const float4* r0 = reinterpret_cast<const float4*>(rows + o * H);
    const float4* r1 = reinterpret_cast<const float4*>(rows + (o + 1) * H);
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
    for (int q = 0; q < H / 4; ++q) {
      const float4 w0 = r0[q], w1 = r1[q];
      a0 = fmaf(v[4 * q + 0], w0.x, a0);
      a1 = fmaf(v[4 * q + 0], w1.x, a1);
      a0 = fmaf(v[4 * q + 1], w0.y, a0);
      a1 = fmaf(v[4 * q + 1], w1.y, a1);
      a0 = fmaf(v[4 * q + 2], w0.z, a0);
      a1 = fmaf(v[4 * q + 2], w1.z, a1);
      a0 = fmaf(v[4 * q + 3], w0.w, a0);
      a1 = fmaf(v[4 * q + 3], w1.w, a1);
    }
    f(o, a0);
    f(o + 1, a1);
  }
  if (o < n) f(o, dot_row<H>(v, rows + o * H));
}

// row_stage for one row, keeping what the backward reads: reads the stage
// input X, EPS and U2 of this row's columns c; writes S1, H1, S2, H2, U1, D1,
// D2 there, y (n_out) and e_z (nz) to the thread's own y and e, and returns
// div, |y|, |e_z|.  The same sums in the same order as row_stage.
template <int H, bool BF16>
__device__ __forceinline__ void row_stage_keep(const RowWeights& w, const Dims& d,
                                               const RowCols& c, float* y, float* e, float& div,
                                               float& ry, float& re) {
  float s1[H], t[H], u[H];
  // layer 1: t = z1 -> s1, h1
#pragma unroll
  for (int j = 0; j < H; ++j) t[j] = 0.0f;
  for (int i = 0; i < d.n_in; ++i) axpy_row<H>(rnd<BF16>(c.X[i * kRowLd]), w.W1t + i * H, t);
  load_row<H>(w.b1, u);
#pragma unroll
  for (int j = 0; j < H; ++j) {
    float sp;
    gates(t[j] + u[j], s1[j], sp);
    t[j] = rnd<BF16>(sp);
    c.S1[j * kRowLd] = s1[j];
    c.H1[j * kRowLd] = t[j];
  }
  // layer 2: u = z2 -> u = s2, t = h2
#pragma unroll
  for (int k = 0; k < H; ++k) u[k] = 0.0f;
#pragma unroll 4
  for (int j = 0; j < H; ++j) axpy_row<H>(c.H1[j * kRowLd], w.W2t + j * H, u);
  load_row<H>(w.b2, t);
#pragma unroll
  for (int k = 0; k < H; ++k) {
    float sp;
    gates(u[k] + t[k], u[k], sp);
    t[k] = rnd<BF16>(sp);
    c.S2[k * kRowLd] = u[k];
    c.H2[k * kRowLd] = t[k];
  }
  // layer 3: y = A3 h2 + b3
  float yy = 0.0f;
  dots<H>(t, w.A3, d.n_out, [&](int o, float dot) {
    const float yo = dot + w.b3[o];
    y[o] = yo;
    yy = fmaf(yo, yo, yy);
  });
  // d2 = u2 * s2, into t
  load_col<H>(c.U2, t);
#pragma unroll
  for (int k = 0; k < H; ++k) {
    t[k] = rnd<BF16>(t[k] * u[k]);
    c.D2[k * kRowLd] = t[k];
  }
  // u1 = A2^T d2 and d1 = u1 * s1, into u
#pragma unroll
  for (int j = 0; j < H; ++j) u[j] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < H; ++k) axpy_row<H>(c.D2[k * kRowLd], w.A2 + k * H, u);
#pragma unroll
  for (int j = 0; j < H; ++j) {
    c.U1[j * kRowLd] = u[j];
    u[j] = rnd<BF16>(u[j] * s1[j]);
    c.D1[j * kRowLd] = u[j];
  }
  // e_z = (A1^T d1)[:nz], and the reductions
  float dv = 0.0f, ee = 0.0f;
  dots<H>(u, w.W1t, d.nz, [&](int i, float ei) {
    e[i] = ei;
    dv = fmaf(ei, c.EPS[i * kRowLd], dv);
    ee = fmaf(ei, ei, ee);
  });
  div = dv;
  ry = sqrtf(yy + 1e-20f);
  re = sqrtf(ee + 1e-20f);
}

// The backward of the stage whose row_stage_keep just ran, for one row.
// Reads ybar from YB, the cotangents divbar, rzbar, rjbar and, with EBAR,
// ebar from EB (K2: e_z is an output of the stage; without it ebar = 0, as in
// a solve step, whose output holds no e_z: K4, K6); writes ybar_t (YB),
// ebar_t (EB), u1bar (G1), u2bar (G2), z1_t (U1) and z2_t (Z2), the first
// nxb entries of xbar to xb (nz in a solve, n_in for K2), and adds epsbar to
// epsb.
template <int H, bool BF16, bool EBAR = false>
__device__ __forceinline__ void row_stage_bwd(const RowWeights& w, const Dims& d,
                                              const RowCols& c, const float* y, const float* e,
                                              float ry, float re, float divbar, float rzbar,
                                              float rjbar, int nxb, float* xb, float* epsb) {
  const int nz = d.nz;
  // merge the cotangents of |y|, |e_z| and div into those of y and e_z
  for (int o = 0; o < d.n_out; ++o) c.YB[o * kRowLd] += rzbar * y[o] / ry;
  for (int i = 0; i < nz; ++i) {
    if constexpr (EBAR)
      c.EB[i * kRowLd] = c.EB[i * kRowLd] + divbar * c.EPS[i * kRowLd] + rjbar * e[i] / re;
    else
      c.EB[i * kRowLd] = divbar * c.EPS[i * kRowLd] + rjbar * e[i] / re;
  }

  float a[H], g[H], s[H], v[H];
  // probe-VJP path: d1bar = ebar_t A1[:, :nz]^T (the first nz rows of W1t)
#pragma unroll
  for (int j = 0; j < H; ++j) a[j] = 0.0f;
  for (int i = 0; i < nz; ++i) axpy_row<H>(rnd<BF16>(c.EB[i * kRowLd]), w.W1t + i * H, a);
  load_col<H>(c.S1, s);
  load_col<H>(c.U1, v);
#pragma unroll
  for (int j = 0; j < H; ++j) {
    g[j] = a[j] * s[j];
    c.G1[j * kRowLd] = g[j];
    c.U1[j * kRowLd] = a[j] * v[j] * s[j] * (1.0f - s[j]);  // z1_b
    g[j] = rnd<BF16>(g[j]);
  }
  // d2bar = u1bar A2^T; u2bar, and z2_b kept in v
#pragma unroll
  for (int k = 0; k < H; ++k) a[k] = 0.0f;
#pragma unroll 4
  for (int j = 0; j < H; ++j) axpy_row<H>(rnd<BF16>(c.G1[j * kRowLd]), w.W2t + j * H, a);
  load_col<H>(c.S2, s);
  load_col<H>(c.U2, v);
#pragma unroll
  for (int k = 0; k < H; ++k) {
    g[k] = a[k] * s[k];
    c.G2[k * kRowLd] = g[k];
    v[k] = a[k] * v[k] * s[k] * (1.0f - s[k]);
    g[k] = rnd<BF16>(g[k]);
  }
  // epsbar = divbar e_z + u2bar A3^T
  dots<H>(g, w.A3, nz, [&](int n, float dot) {
    const float eb = divbar * e[n] + dot;
    epsb[n] += eb;
  });
  // forward path: z2_t = (ybar_t A3) * s2 + z2_b
#pragma unroll
  for (int k = 0; k < H; ++k) a[k] = 0.0f;
  for (int o = 0; o < d.n_out; ++o) axpy_row<H>(rnd<BF16>(c.YB[o * kRowLd]), w.A3 + o * H, a);
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float z = a[k] * s[k] + v[k];
    c.Z2[k * kRowLd] = z;
    g[k] = rnd<BF16>(z);
  }
  // z1_t = (z2_t A2) * s1 + z1_b
#pragma unroll
  for (int j = 0; j < H; ++j) a[j] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < H; ++k) axpy_row<H>(rnd<BF16>(c.Z2[k * kRowLd]), w.A2 + k * H, a);
  load_col<H>(c.S1, s);
  load_col<H>(c.U1, v);
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float z = a[j] * s[j] + v[j];
    c.U1[j * kRowLd] = z;
    g[j] = rnd<BF16>(z);
  }
  // xbar[:nxb] = z1_t A1
  dots<H>(g, w.W1t, nxb, [&](int n, float dot) { xb[n] = dot; });
}

// The dub of state column c of a solve stage's output du = [y, -div, |y|,
// |e_z|]: ybar into this row's YB column, the rest into (divbar, rzbar,
// rjbar).
__device__ __forceinline__ void set_row_cotangent(const RowCols& my, int c, int nz, float dub,
                                                  float (&ct)[3]) {
  if (c < nz) my.YB[c * kRowLd] = dub;
  else if (c == nz) ct[0] = -dub;
  else ct[c - nz] = dub;  // nz + 1 -> |y|, nz + 2 -> |e_z|
}

// Adds the weight-gradient terms of the stage just taken back, summed over
// the block's rows [0, R4) in row order, to acc (P floats: this block's row
// of partial sums, layout of cnf_fused_dynamics_bwd).  c: the block's column
// buffers; rows past the last valid one hold zeros.  Every thread of the
// block must call it, after a __syncthreads().
//
// dA2 (2 h^2 of the ~2 h^2 + 2 h (n_in + nz + n_out) FMAs a row) is summed
// in register tiles: the 64 threads form an 8 x 8 grid, and thread
// (tk, tj) owns the (H/8)^2 entries (k, j) = (tk + 8 kk, tj + 8 jj), so each
// float4 of 4 rows it reads feeds H/8 entries (units 8 apart fall on
// distinct bank groups).  Every other entry is handled by one thread.
template <int H, bool BF16>
__device__ void row_accumulate_wgrads(const Dims& d, const RowCols& c, int R4, float* acc) {
  static_assert(kRowBwdThreads == 64, "the dA2 tiles take an 8 x 8 grid of threads");
  constexpr int T = H / 8;
  const int h = d.h, n_in = d.n_in, n_out = d.n_out, nz = d.nz;
  const long oB1 = (long)h * n_in, oA2 = oB1 + h, oB2 = oA2 + (long)h * h, oA3 = oB2 + h;
  const long oB3 = oA3 + (long)n_out * h, P = oB3 + n_out;
  {  // dA2[k, j] = sum_r z2_t[k] h1[j] + d2[k] u1bar[j]
    const int tk = threadIdx.x / 8, tj = threadIdx.x % 8;
    float s1[T][T], s2[T][T];
#pragma unroll
    for (int a = 0; a < T; ++a)
#pragma unroll
      for (int b = 0; b < T; ++b) s1[a][b] = s2[a][b] = 0.0f;
    for (int r = 0; r < R4; r += 4) {
      float z[T][4], dd[T][4], hh[T][4], gg[T][4];
#pragma unroll
      for (int a = 0; a < T; ++a) {
        const float4 z4 = *reinterpret_cast<const float4*>(c.Z2 + (tk + 8 * a) * kRowLd + r);
        const float4 d4 = *reinterpret_cast<const float4*>(c.D2 + (tk + 8 * a) * kRowLd + r);
        const float4 h4 = *reinterpret_cast<const float4*>(c.H1 + (tj + 8 * a) * kRowLd + r);
        const float4 g4 = *reinterpret_cast<const float4*>(c.G1 + (tj + 8 * a) * kRowLd + r);
        const float zs[4] = {z4.x, z4.y, z4.z, z4.w}, ds[4] = {d4.x, d4.y, d4.z, d4.w};
        const float hs[4] = {h4.x, h4.y, h4.z, h4.w}, gs[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          z[a][i] = rnd<BF16>(zs[i]);
          dd[a][i] = rnd<BF16>(ds[i]);
          hh[a][i] = rnd<BF16>(hs[i]);
          gg[a][i] = rnd<BF16>(gs[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int a = 0; a < T; ++a)
#pragma unroll
          for (int b = 0; b < T; ++b) {
            s1[a][b] = fmaf(z[a][i], hh[b][i], s1[a][b]);
            s2[a][b] = fmaf(dd[a][i], gg[b][i], s2[a][b]);
          }
    }
#pragma unroll
    for (int a = 0; a < T; ++a)
#pragma unroll
      for (int b = 0; b < T; ++b) {
        const int k = tk + 8 * a, j = tj + 8 * b;
        if (k < h && j < h) acc[oA2 + (long)k * h + j] += s1[a][b] + s2[a][b];
      }
  }
  // the rest (the entries before dA2, then those after it): a thread's
  // entries q, q + 64, ... four at a time, each as two terms, term m the sum
  // over the rows of a[m] * b[m] (operands rounded, but for a bias sum)
  const long rest = P - (long)h * h;
  for (long q0 = threadIdx.x; q0 < rest; q0 += 4L * blockDim.x) {
    const float* a[8];
    const float* b[8];
    bool rd[8];
    long pe[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long q = q0 + (long)e * blockDim.x;
      const long p = q < oA2 ? q : q + (long)h * h;
      const float *a1 = c.ZERO, *b1 = c.ZERO, *a2 = c.ZERO, *b2 = c.ZERO;
      bool r1 = true;
      pe[e] = q < rest ? p : -1;
      if (q >= rest) {
      } else if (p < oB1) {  // dA1[j, i] = sum_r z1_t[j] x[i] + d1[j] ebar_t[i]
        const int j = (int)(p / n_in), i = (int)(p - (long)j * n_in);
        a1 = c.U1 + j * kRowLd;
        b1 = c.X + i * kRowLd;
        if (i < nz) {
          a2 = c.D1 + j * kRowLd;
          b2 = c.EB + i * kRowLd;
        }
      } else if (p < oA2) {  // db1[j] = sum_r z1_t[j]
        a1 = c.U1 + (p - oB1) * kRowLd;
        b1 = c.ONE;
        r1 = false;
      } else if (p < oA3) {  // db2[k] = sum_r z2_t[k]
        a1 = c.Z2 + (p - oB2) * kRowLd;
        b1 = c.ONE;
        r1 = false;
      } else if (p < oB3) {  // dA3[o, k] = sum_r ybar_t[o] h2[k] + eps[o] u2bar[k]
        const long q3 = p - oA3;
        const int o = (int)(q3 / h), k = (int)(q3 - (long)o * h);
        a1 = c.YB + o * kRowLd;
        b1 = c.H2 + k * kRowLd;
        a2 = c.EPS + o * kRowLd;
        b2 = c.G2 + k * kRowLd;
      } else {  // db3[o] = sum_r ybar_t[o]
        a1 = c.YB + (p - oB3) * kRowLd;
        b1 = c.ONE;
        r1 = false;
      }
      a[2 * e] = a1;
      b[2 * e] = b1;
      rd[2 * e] = r1;
      a[2 * e + 1] = a2;
      b[2 * e + 1] = b2;
      rd[2 * e + 1] = true;
    }
    float sm[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) sm[m] = 0.0f;
    for (int r = 0; r < R4; r += 4) {
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const float4 x4 = *reinterpret_cast<const float4*>(a[m] + r);
        const float4 y4 = *reinterpret_cast<const float4*>(b[m] + r);
        const float xs[4] = {x4.x, x4.y, x4.z, x4.w}, ys[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          sm[m] = fmaf(rd[m] ? rnd<BF16>(xs[i]) : xs[i], rd[m] ? rnd<BF16>(ys[i]) : ys[i], sm[m]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (pe[e] >= 0) acc[pe[e]] += sm[2 * e] + sm[2 * e + 1];
  }
}

}  // namespace cnf
