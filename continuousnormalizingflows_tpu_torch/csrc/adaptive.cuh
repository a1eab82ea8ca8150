// The adaptive Dormand-Prince 5(4) solve of one control group of rows,
// shared by K5 (fused_adaptive.cu) and the replay of K6
// (fused_adaptive_bwd.cu).
//
// One block owns one group.  Each trial step runs the six new stages of the
// group's rows (FSAL: the seventh of an accepted step is the next first),
// then every row sums its squared scaled errors over the state columns into
// red[row], thread 0 adds red in order of row (no atomics: a fixed order),
// takes the controller's decision and broadcasts it through the shared
// Ctl.  The decision is the JAX kernel's (pallas_adaptive.py _controller,
// _adaptive_fwd_kernel): RMS ratio, step factor safety * ratio^(-1/5) as
// exp/log clipped to [min_factor, max_factor], accept at ratio <= 1, a
// non-finite ratio is a reject at the smallest factor, give up when that
// happens below 1e-6 of the span, done when t lands on t1.
//
// K6 must take the forward's accept decisions exactly, or its gradient is
// of another solution.  So both kernels call these functions with the same
// launch geometry, and the trial-step arithmetic is written out with
// explicit fmaf / __fmul_rn / __fadd_rn, so no contraction choice of the
// compiler can differ between the two kernels.
//
// Two paths, as for K3: one row per thread with the row's state in shared
// memory for h <= 32 (solve_rows: blockDim.x == group, h padded to a
// multiple of 4 as in K1 and K3, four 128-row groups an SM), one tile of rows at
// a time through stage.cuh for wider nets (solve_tiled: the rows' state,
// 9 x state_dim floats each, in a device-memory scratch, because 128 rows of
// a wide state do not fit in shared memory beside the stage buffers).  For
// 32 < h <= 128 the kernels take the cluster path of cluster_adaptive.cuh
// where its plan fits: the group's rows split over a thread-block cluster.
#pragma once

#include "row_stage_bwd.cuh"

namespace cnf {

constexpr int kCtlFloats = 12;  // shared floats reserved for a Ctl
constexpr int kMaxGroup = 128;  // rows of a control group, at most
constexpr long kSmemMax = 227L * 1024;
// Resident blocks an SM that the row kernels (K5's and K6's replay) are
// compiled for: 4 x 128 threads leave a thread 128 registers, and 4 x 52 KB
// of shared memory at the flagship fit an SM, so the 512 groups of a
// 65,536-row batch run in one wave on 132 SMs.
constexpr int kRowGroupsPerSM = 4;

// The dynamic shared memory of a row kernel, and the SM's largest shared
// memory carveout, so that kRowGroupsPerSM blocks fit beside each other.
template <typename K>
cudaError_t set_row_smem(K kernel, int bytes) {
  const cudaError_t err = set_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// Dormand-Prince 5(4) in float32, each constant rounded from its double
// value, as the JAX package's Python floats are.  Constant memory: the
// stage index is the same in every thread, so each read is a broadcast.
static __constant__ float kDpA[5][5] = {  // row i: stage i + 1, columns j <= i
    {(float)(1.0 / 5), 0.0f, 0.0f, 0.0f, 0.0f},
    {(float)(3.0 / 40), (float)(9.0 / 40), 0.0f, 0.0f, 0.0f},
    {(float)(44.0 / 45), (float)(-56.0 / 15), (float)(32.0 / 9), 0.0f, 0.0f},
    {(float)(19372.0 / 6561), (float)(-25360.0 / 2187), (float)(64448.0 / 6561),
     (float)(-212.0 / 729), 0.0f},
    {(float)(9017.0 / 3168), (float)(-355.0 / 33), (float)(46732.0 / 5247), (float)(49.0 / 176),
     (float)(-5103.0 / 18656)}};
static __constant__ float kDpB[6] = {(float)(35.0 / 384), 0.0f, (float)(500.0 / 1113),
                                     (float)(125.0 / 192), (float)(-2187.0 / 6784),
                                     (float)(11.0 / 84)};
static __constant__ float kDpBerr[7] = {  // b - b_hat; 6: the FSAL stage
    (float)(35.0 / 384 - 5179.0 / 57600),        0.0f,
    (float)(500.0 / 1113 - 7571.0 / 16695),      (float)(125.0 / 192 - 393.0 / 640),
    (float)(-2187.0 / 6784 - -92097.0 / 339200), (float)(11.0 / 84 - 187.0 / 2100),
    (float)(0.0 - 1.0 / 40)};
static __constant__ float kDpC[6] = {0.0f, (float)(1.0 / 5), (float)(3.0 / 10), (float)(4.0 / 5),
                                     (float)(8.0 / 9), 1.0f};

// Solver settings (SolverConfig through _scfg_tuple).
struct Solver {
  float rtol, atol, dt0f, safety, min_f, max_f;
  int max_steps;
};

// The group's controller, in shared memory; thread 0 writes it between two
// barriers, every thread reads it outside them.
struct Ctl {
  float t, dt, dtc;
  int steps, nacc, nfe, done, fail, accept;
};

// Where the accepted steps are recorded (traj == nullptr: nowhere): K6's
// replay on the row and tiled paths, K5 on the cluster path under autograd.
struct Nodes {
  float* traj;  // (max_nodes, nz, B): z of u at the start of each accepted step; on the
                // cluster path (max_nodes, 6, nz, B): z of its six stage inputs
  float* tdt;   // (groups, max_nodes, 2): its t and dt
  int max_nodes;
};

__device__ __forceinline__ bool running(const Ctl& c, const Solver& s) {
  return !(c.done || c.fail) && c.steps < s.max_steps;
}

// Thread 0: the state before the first trial step (nfe 1: the first k1).
__device__ inline void ctl_start(Ctl& c, float t0, float span, const Solver& s) {
  c.t = t0;
  c.dt = __fmul_rn(span, s.dt0f);
  c.dtc = 0.0f;
  c.steps = c.nacc = c.done = c.fail = c.accept = 0;
  c.nfe = 1;
}

// Thread 0, at the start of a trial step: the step clamped to land on t1.
__device__ __forceinline__ void ctl_clamp(Ctl& c, float t1, float span) {
  const float dir = span > 0.0f ? 1.0f : (span < 0.0f ? -1.0f : 0.0f);
  c.dtc = dir * fminf(fabsf(c.dt), fabsf(__fadd_rn(t1, -c.t)));
}

// Thread 0: the decision of a trial step from the group's sum of squared
// scaled errors over `count` elements; records an accepted step's t and dt
// as group grp's.
__device__ inline void ctl_decide(Ctl& c, float sum, int count, const Solver& s, float t1,
                                  float span, const Nodes& nodes, long grp) {
  const float ratio = sqrtf(sum / (float)count);
  const bool finite = isfinite(ratio);
  const float r = fmaxf(finite ? ratio : 1.0f, 1e-10f);
  const float factor = fminf(fmaxf(__fmul_rn(s.safety, expf(__fmul_rn(-0.2f, logf(r)))),
                                   s.min_f), s.max_f);
  const bool accept = finite && ratio <= 1.0f;
  if (accept && nodes.traj != nullptr) {
    const int idx = min(c.nacc, nodes.max_nodes - 1);
    float* rec = nodes.tdt + (grp * nodes.max_nodes + idx) * 2;
    rec[0] = c.t;
    rec[1] = c.dtc;
  }
  float t_new = accept ? __fadd_rn(c.t, c.dtc) : c.t;
  // a landing that rounds past t1 lands on t1 (ops/ode.py _land): past it,
  // the done test never holds and each next step moves away from t1
  const float dir = span > 0.0f ? 1.0f : (span < 0.0f ? -1.0f : 0.0f);
  if (dir * __fadd_rn(t1, -t_new) < 0.0f) t_new = t1;
  c.done = accept && fabsf(__fadd_rn(t1, -t_new)) <= __fmul_rn(1e-12f, fmaxf(fabsf(t1), 1.0f));
  c.fail = !finite && fabsf(c.dtc) <= __fmul_rn(1e-6f, fabsf(span));
  c.dt = __fmul_rn(c.dtc, finite ? factor : s.min_f);
  c.t = t_new;
  c.accept = accept;
  c.nacc += accept;
  c.steps += 1;
  c.nfe += 6;
}

// Stage input of stage i (1..5) for one column: u + sum_j (dt a_ij) k_j,
// k_j at k[j * ks].
__device__ __forceinline__ float stage_input(int i, float u, const float* k, int ks, float dtc) {
  float v = u;
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    if (j >= i) break;
    const float a = kDpA[i - 1][j];
    if (a != 0.0f) v = fmaf(__fmul_rn(dtc, a), k[j * ks], v);
  }
  return v;
}

// u5 = u + sum_j (dt b_j) k_j for one column.
__device__ __forceinline__ float step_solution(float u, const float* k, int ks, float dtc) {
  float v = u;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const float b = kDpB[j];
    if (b != 0.0f) v = fmaf(__fmul_rn(dtc, b), k[j * ks], v);
  }
  return v;
}

// (err / (atol + rtol max(|u|, |u5|)))^2 for one column, err from k_0..k_6.
__device__ __forceinline__ float scaled_err_sq(float u, float u5, const float* k, int ks,
                                               float dtc, const Solver& s) {
  float e = __fmul_rn(__fmul_rn(dtc, kDpBerr[0]), k[0]);
#pragma unroll
  for (int j = 1; j < 7; ++j) {
    const float be = kDpBerr[j];
    if (be != 0.0f) e = fmaf(__fmul_rn(dtc, be), k[j * ks], e);
  }
  const float r = __fdiv_rn(e, fmaf(s.rtol, fmaxf(fabsf(u), fabsf(u5)), s.atol));
  return __fmul_rn(r, r);
}

// Thread 0: the group's sum in order of row, then the decision.
__device__ __forceinline__ void group_decide(Ctl& c, const float* red, int rows, int sd,
                                             const Solver& s, float t1, float span,
                                             const Nodes& nodes) {
  float sum = 0.0f;
  for (int r = 0; r < rows; ++r) sum = __fadd_rn(sum, red[r]);
  ctl_decide(c, sum, rows * sd, s, t1, span, nodes, blockIdx.x);
}

// ---------------------------------------------------------------------------
// the row path: one row per thread
// ---------------------------------------------------------------------------

// A thread's shared row: U (sd), K (7 x sd: k_0..k_6), U5 (sd), X (n_in),
// Y (n_out), EPS (nz); odd stride.
__host__ __device__ inline int adaptive_row_floats(const Dims& d, int sd) {
  return odd(9 * sd + d.n_in + d.n_out + d.nz);
}

// One stage of the row at time t from X (z columns set by the caller):
// k = [y, -div, |y|, |e_z|].
template <int H>
__device__ __forceinline__ void row_eval(const RowWeights& w, const Dims& d, float* X,
                                         const float* EPS, float* Y, float* k, int t_col,
                                         float t) {
  if (t_col >= 0) X[t_col] = t;
  float dv, ry, re;
  row_stage<H, false>(w, d, X, EPS, Y, nullptr, dv, ry, re);
  for (int c = 0; c < d.nz; ++c) k[c] = Y[c];
  k[d.nz] = -dv;
  k[d.nz + 1] = ry;
  k[d.nz + 2] = re;
}

// The group's solve, thread r owning row r (blockDim.x == group).  The
// thread's row holds u0 in U, eps in EPS and the conditions in X on entry;
// on return U holds the state at exit and c the counts.  Row `grow` of the
// batch (B rows) is this thread's, for the node buffer.
//
// Every evaluation goes through the one row_eval call below, so the code
// holds one copy of the stage, as K3's row kernel does (three inlined
// copies, a body of ~13k instructions, made K5 1.11x slower at h = 24 on an
// H100): evaluation i = 0 is k_0 at (t0, u0), i = 1..5 the trial
// step's stage inputs, i = 6 the FSAL stage at u5.  Two barriers a decision
// (i = 0: the start, i = 6: a trial step): thread 0 writes c only between
// them, and every thread reads c only after the second and before it next
// reaches the first.
template <int H>
__device__ void solve_rows(const RowWeights& w, const Dims& d, float* row, int sd, int t_col,
                           float t0, float t1, const Solver& s, Ctl& c, float* red,
                           const Nodes& nodes, long grow, long B) {
  const int nz = d.nz;
  float* U = row;
  float* K = U + sd;
  float* U5 = K + 7 * sd;
  float* X = U5 + sd;
  float* Y = X + d.n_in;
  const float* EPS = Y + d.n_out;
  const float span = __fadd_rn(t1, -t0);
  float t = t0, dtc = 0.0f;
  int i = 0;
#pragma unroll 1
  for (;;) {
    float te = t0;
    if (i == 0) {
      for (int col = 0; col < nz; ++col) X[col] = U[col];
    } else if (i < 6) {
      for (int col = 0; col < nz; ++col) X[col] = stage_input(i, U[col], K + col, sd, dtc);
      te = __fadd_rn(t, __fmul_rn(kDpC[i], dtc));
    } else {
      for (int col = 0; col < sd; ++col) {
        U5[col] = step_solution(U[col], K + col, sd, dtc);
        if (col < nz) X[col] = U5[col];
      }
      te = __fadd_rn(t, dtc);
    }
    row_eval<H>(w, d, X, EPS, Y, K + i * sd, t_col, te);
    if (i > 0 && i < 6) {
      ++i;
      continue;
    }
    if (i == 6) {
      float sum = 0.0f;
      for (int col = 0; col < sd; ++col)
        sum = __fadd_rn(sum, scaled_err_sq(U[col], U5[col], K + col, sd, dtc, s));
      red[threadIdx.x] = sum;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      if (i == 0) ctl_start(c, t0, span, s);
      else group_decide(c, red, blockDim.x, sd, s, t1, span, nodes);
      ctl_clamp(c, t1, span);
    }
    __syncthreads();
    if (i == 6 && c.accept) {
      if (nodes.traj != nullptr) {
        const long idx = min(c.nacc - 1, nodes.max_nodes - 1);
        for (int col = 0; col < nz; ++col) nodes.traj[(idx * nz + col) * B + grow] = U[col];
      }
      for (int col = 0; col < sd; ++col) {
        U[col] = U5[col];
        K[col] = K[6 * sd + col];
      }
    }
    if (!running(c, s)) break;
    t = c.t;
    dtc = c.dtc;
    i = 1;
  }
}

// ---------------------------------------------------------------------------
// the tiled path: tiles of rows through stage.cuh, state in device memory
// ---------------------------------------------------------------------------

// Floats of a row's state in the scratch: U, k_0..k_6, U5 (sd each).
constexpr int kStateVecs = 9;

__device__ __forceinline__ float stage_du(const StageBufs& s, int r, int col, int nz) {
  if (col < nz) return s.Y[r * s.ldy + col];
  if (col == nz) return -s.ST[r * 3 + 0];
  return s.ST[r * 3 + (col - nz)];  // nz + 1 -> |y|, nz + 2 -> |e_z|
}

// Stage i (0: at u, 1..5: the stage inputs, 6: at u5) of the group's rows,
// `rows` at a time, into k_i of the state S (the group's first row).
__device__ inline void tile_eval(const Dims& d, const Weights& w, const StageBufs& s, int rows, int g,
                          float* S, const float* eps, const float* ys, int sd, int nc,
                          int t_col, int i, float t, float dtc) {
  const int nz = d.nz, ldx = s.ldx, ldz = s.ldz, ss = kStateVecs * sd;
  const int ys_off = nz + (t_col >= 0 ? 1 : 0);
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int r0 = 0; r0 < g; r0 += rows) {
    const int R = min(rows, g - r0);
    for (int idx = tid; idx < R * nz; idx += nt) {
      const int r = idx / nz, col = idx - r * nz;
      const float* Sr = S + (long)(r0 + r) * ss;
      float v = Sr[col];                                    // i == 0: u
      if (i == 6) v = Sr[8 * sd + col];                     // u5
      else if (i > 0) v = stage_input(i, v, Sr + sd + col, sd, dtc);
      s.X[r * ldx + col] = v;
      s.EPS[r * ldz + col] = eps[(long)(r0 + r) * nz + col];
    }
    for (int idx = tid; idx < R * nc; idx += nt) {
      const int r = idx / nc, j = idx - r * nc;
      s.X[r * ldx + ys_off + j] = ys[(long)(r0 + r) * nc + j];
    }
    if (t_col >= 0)
      for (int r = tid; r < R; r += nt) s.X[r * ldx + t_col] = t;
    __syncthreads();
    stage_fwd<false>(d, w, s, R);
    for (int idx = tid; idx < R * sd; idx += nt) {
      const int r = idx / sd, col = idx - r * sd;
      S[(long)(r0 + r) * ss + (1 + i) * sd + col] = stage_du(s, r, col, nz);
    }
    __syncthreads();
  }
}

// The group's solve through tiles of `rows` rows.  S: the group's state
// (g rows of 9 x sd floats) with u0 in U on entry and the state at exit on
// return; eps and ys point at the group's first row.  red: g floats.
__device__ inline void solve_tiled(const Dims& d, const Weights& w, const StageBufs& s, int rows, int g,
                            float* S, const float* eps, const float* ys, int sd, int nc,
                            int t_col, float t0, float t1, const Solver& sv, Ctl& c, float* red,
                            const Nodes& nodes, long row0, long B) {
  const int nz = d.nz, ss = kStateVecs * sd;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float span = __fadd_rn(t1, -t0);
  tile_eval(d, w, s, rows, g, S, eps, ys, sd, nc, t_col, 0, t0, 0.0f);
  if (tid == 0) {
    ctl_start(c, t0, span, sv);
    ctl_clamp(c, t1, span);
  }
  __syncthreads();
  while (running(c, sv)) {
    const float t = c.t, dtc = c.dtc;
    for (int i = 1; i < 6; ++i)
      tile_eval(d, w, s, rows, g, S, eps, ys, sd, nc, t_col, i,
                __fadd_rn(t, __fmul_rn(kDpC[i], dtc)), dtc);
    for (int idx = tid; idx < g * sd; idx += nt) {
      const int r = idx / sd, col = idx - r * sd;
      float* Sr = S + (long)r * ss;
      Sr[8 * sd + col] = step_solution(Sr[col], Sr + sd + col, sd, dtc);
    }
    __syncthreads();
    tile_eval(d, w, s, rows, g, S, eps, ys, sd, nc, t_col, 6, __fadd_rn(t, dtc), dtc);
    for (int r = tid; r < g; r += nt) {
      const float* Sr = S + (long)r * ss;
      float sum = 0.0f;
      for (int col = 0; col < sd; ++col)
        sum = __fadd_rn(sum, scaled_err_sq(Sr[col], Sr[8 * sd + col], Sr + sd + col, sd, dtc, sv));
      red[r] = sum;
    }
    __syncthreads();
    if (tid == 0) {
      group_decide(c, red, g, sd, sv, t1, span, nodes);
      ctl_clamp(c, t1, span);
    }
    __syncthreads();
    if (c.accept) {
      const long idx = min(c.nacc - 1, nodes.max_nodes - 1);
      for (int e = tid; e < g * sd; e += nt) {
        const int r = e / sd, col = e - r * sd;
        float* Sr = S + (long)r * ss;
        if (nodes.traj != nullptr && col < nz) nodes.traj[(idx * nz + col) * B + row0 + r] = Sr[col];
        Sr[col] = Sr[8 * sd + col];
        Sr[sd + col] = Sr[7 * sd + col];
      }
    }
    __syncthreads();
  }
}

// Per-row floats of K6's tiled walk beyond the stage backward's buffers: the
// state cotangent a (sd), and the z columns of the 6 stage inputs, the 5
// stage outputs that build them, the 6 input cotangents and epsbar.
__host__ __device__ inline int adaptive_bwd_extra(int sd, int nz) {
  return odd(sd) + 18 * odd(nz);
}

// Floats of a thread's own row in K6's walk on the row path: the row_stage
// input X (n_in), eps, y and e_z of the stage being taken back, the node's z,
// the 5 stage outputs k_0..k_4 that build the stage inputs, the 6 input
// cotangents vbar_0..vbar_5, epsbar (nz each), and the state cotangent a (sd).
__host__ __device__ inline int adaptive_walk_row_ld(const Dims& d, int sd) {
  return odd(d.n_in + d.n_out + 15 * d.nz + sd);
}

// Launch plan of K5 and K6 for a group of g rows.  With its walk on the row
// path K6 is two kernels, the replay with K5's block shape and shared memory,
// then the walk; with the tiled walk it is one, whose blocks hold the larger
// of the two's shared memory.
struct AdaptivePlan {
  int H;            // > 0: the row path (blockDim g, h padded to a multiple of 4),
                    // 0: the tiled path (blockDim kThreads)
  int rows;         // tiled path: rows of a stage tile
  int smem_fwd;     // bytes of the forward, and of K6's replay (0: does not fit)
  bool staged;      // tiled path and K6's tiled walk: weights in shared memory
  int walk_H;       // K6's walk: > 0 the row path (blocks of bwd_rows threads, one row
                    // each, never across two groups), 0 the tiled path (a block a group)
  int bwd_rows;     // K6's walk: rows of a block (row path) or of a tile (0: does not fit)
  int walk_blocks;  // K6's walk: blocks a group (the partial sums have a row a block)
  bool acc_smem;    // K6's tiled walk: weight-gradient partial sums in shared memory
  int smem_bwd;     // bytes of K6's walk kernel (tiled: of the replay and the walk)
};

inline AdaptivePlan adaptive_plan(const Dims& d, int sd, int g) {
  AdaptivePlan pl{};
  const long wf = weight_floats(d);
  pl.staged = 4 * wf <= kStageWeightsBytes;
  const int H = row_fwd_H(d.h);
  const long wr = H ? row_weight_floats(d, H) : 0;
  const long row_bytes = 4 * (wr + kCtlFloats + g + (long)g * adaptive_row_floats(d, sd));
  if (H && 4 * wr <= kStageWeightsBytes && row_bytes <= kSmemMax) {
    pl.H = H;
    pl.rows = g;
    pl.smem_fwd = (int)row_bytes;
  } else {
    const long fixed = (pl.staged ? wf : 0) + kCtlFloats + g;
    const long per_row = stage_floats_per_row(d);
    long rows = (kBlockBudgetBytes / 4 - fixed) / per_row;
    rows = rows > g ? g : (rows < 1 ? 1 : rows);
    const long bytes = 4 * (fixed + rows * per_row);
    pl.rows = (int)rows;
    pl.smem_fwd = bytes <= kSmemMax ? (int)bytes : 0;
  }
  const long P = param_count(d);
  pl.acc_smem = P <= kAccSmemFloats;
  const RowBwdPlan rp = row_bwd_plan(d, adaptive_walk_row_ld(d, sd));
  if (rp.H) {
    pl.walk_H = rp.H;
    pl.bwd_rows = kRowBwdThreads;
    pl.walk_blocks = (g + kRowBwdThreads - 1) / kRowBwdThreads;
    pl.smem_bwd = rp.smem_bytes;
    return pl;
  }
  const long fixed2 = (pl.staged ? wf : 0) + (pl.acc_smem ? P : 0);
  const long per_row2 = bwd_floats_per_row(d) + adaptive_bwd_extra(sd, d.nz);
  long rows2 = (kBlockBudgetBytes / 4 - fixed2) / per_row2;
  rows2 = rows2 > g ? g : (rows2 < 1 ? 1 : rows2);
  const long bytes2 = 4 * (fixed2 + rows2 * per_row2);
  pl.bwd_rows = bytes2 <= kSmemMax ? (int)rows2 : 0;
  pl.walk_blocks = 1;
  pl.smem_bwd = pl.bwd_rows ? (int)(bytes2 > pl.smem_fwd ? bytes2 : pl.smem_fwd) : 0;
  return pl;
}

}  // namespace cnf
