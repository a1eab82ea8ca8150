// K6 on Hopper: the exact discrete backward of the adaptive solve (K5) --
// cotangents of u1 with respect to u0, eps and the six weights.
//
// Replaces continuousnormalizingflows_tpu/ops/pallas_adaptive.py
// _adaptive_bwd_kernel (custom-VJP rule _fused_adaptive_bwd).  Two phases:
//   1. the accepted steps, one record a control group of rows.  On the row
//      and tiled paths K6 replays K5's solve with the same device functions
//      and the same block shape (adaptive.cuh), recording each accepted
//      step's u (z columns) in a device-memory node buffer of max_nodes x nz
//      x B floats (stored [node][column][row], so a warp's stores and the
//      row walk's loads are contiguous), and its t and dt per group.  On the
//      cluster path K5 itself writes the record under autograd: the six
//      stage inputs of each accepted step (max_nodes x 6 x nz x B floats,
//      cluster_adaptive.cuh), so K6 solves nothing again.  The TPU kept the
//      nodes in VMEM and capped them at 64; device memory holds what
//      max_nodes asks;
//   2. the walk over the accepted steps, last first.  For step n, the stage
//      inputs v_0..v_5: on the row and tiled paths recomputed from the node
//      (five stage forwards for k_0..k_4), on the cluster path read from the
//      record.  Then the six stage VJPs in reverse, each after recomputing
//      its stage with every intermediate kept, through the dopri5 chain rule
//        kbar_i = dt b_i a + sum_{m > i} dt a_mi vbar_m,   a <- a + sum_i vbar_i.
//      epsbar and the weight gradients accumulate over stages and steps; the
//      weight gradients go into the block's row of a (walk grid, P) buffer of
//      partial sums, added in order of block by a last kernel: the same
//      inputs give the same bits.
// Three paths of the walk, chosen from the widths (adaptive_plan):
//   * h <= 32, two kernels.  The replay (adaptive_replay) also writes each
//     group's accepted-step count and whether it finished; the walk
//     (walk_rows) runs one row per thread in blocks of 64 rows that never
//     straddle two groups (a 72-row group is a 64-row block and an 8-row
//     one), each reading its group's count, times and flag, the stages
//     through row_stage.cuh and row_stage_bwd.cuh, as K4's walk.  With its
//     own grid and shared memory the walk pays neither for the replay's
//     block shape (one block a 128-row group) nor for a group cut into tiles
//     that do not divide it.
//   * wider nets (32 < h <= 128), the walk alone (adaptive_bwd_cluster) on
//     K5's record: a thread-block cluster a group (cluster_adaptive.cuh),
//     each CTA its share of the rows, the weight gradient held in the
//     cluster's shared memory, a share a CTA, across stages and steps and
//     written once.
//   * where the cluster plan does not fit, one kernel (adaptive_bwd): the
//     block that replayed a group walks it, tiles of rows through stage.cuh
//     and stage_bwd.cuh.  Split in two like the row path it was slower (12.3
//     -> 16.8 ms at h = 33, B = 65,536 on an H100; PERF.md section 6), so it
//     stays whole.
// A group that accepted more steps than max_nodes, or did not finish,
// NaN-poisons its rows of u0bar and epsbar and the partial sums of its walk
// blocks, as the TPU kernel does.  Each group's accepted-step count is
// returned, so a caller can check that the replay took K5's steps.
//
// What bounds it on an H100: per accepted step 6 stage forwards with every
// intermediate kept and 6 stage backwards (the row and tiled paths 5 stage
// forwards more), against 2 x nz floats of node traffic per row (6 x nz on
// the cluster path): FMA and shared-memory issue inside the SM, as for K4.
//
// C interface for ctypes: returns a cudaError_t (0 on success).

#include "cluster_adaptive.cuh"

namespace {

using cnf::Ctl;
using cnf::Nodes;
using cnf::Solver;

// The tiled walk over the group's `walk` accepted steps, tiles of `rows`
// rows.  p: the shared memory after the staged weights and acc.  Pointers
// eps, ys, gbar, u0bar, epsbar at the group's first row.
__device__ void walk_back(const cnf::Dims& d, const cnf::Weights& w, float* p, int rows, int g,
                          long row0, const float* eps, const float* ys, const float* gbar,
                          float* u0bar, float* epsbar, const Nodes& nodes, int walk, float* acc,
                          int sd, int nc, int t_col, long B, float poison) {
  cnf::BwdBufs b;
  p = cnf::carve_bwd(p, rows, d, b);
  const cnf::StageBufs& s = b.f;
  const int nz = d.nz, ldx = s.ldx, ldy = s.ldy, ldz = s.ldz, lds = cnf::odd(sd);
  const int ys_off = nz + (t_col >= 0 ? 1 : 0);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int vz = rows * ldz;  // floats of one z-column buffer
  float* A = p;                   // (rows, lds) state cotangent a
  float* V = A + rows * lds;      // v_0..v_5 (z columns): the stage inputs
  float* KZ = V + 6 * vz;         // k_0..k_4 (z columns)
  float* VB = KZ + 5 * vz;        // vbar_0..vbar_5
  float* EPSB = VB + 6 * vz;      // epsbar
  const float* tdt = nodes.tdt + (long)blockIdx.x * nodes.max_nodes * 2;

  for (int r0 = 0; r0 < g; r0 += rows) {
    const int R = min(rows, g - r0);
    for (int idx = tid; idx < R * nz; idx += nt) {
      const int r = idx / nz, c = idx - r * nz;
      s.EPS[r * ldz + c] = eps[(long)r0 * nz + idx];
      EPSB[r * ldz + c] = 0.0f;
    }
    for (int idx = tid; idx < R * sd; idx += nt) {
      const int r = idx / sd, c = idx - r * sd;
      A[r * lds + c] = gbar[(long)r0 * sd + idx];
    }
    for (int idx = tid; idx < R * nc; idx += nt) {
      const int r = idx / nc, j = idx - r * nc;
      s.X[r * ldx + ys_off + j] = ys[(long)r0 * nc + idx];
    }
    __syncthreads();

    for (int n = walk - 1; n >= 0; --n) {
      const float t = tdt[2 * n], dt = tdt[2 * n + 1];
      for (int idx = tid; idx < R * nz; idx += nt) {
        const int r = idx / nz, c = idx - r * nz;
        V[r * ldz + c] = nodes.traj[((long)n * nz + c) * B + row0 + r0 + r];
      }
      __syncthreads();
      // the stage inputs v_1..v_5, from k_0..k_4
      for (int i = 0; i < 5; ++i) {
        for (int idx = tid; idx < R * nz; idx += nt) {
          const int r = idx / nz, c = idx - r * nz;
          s.X[r * ldx + c] = V[i * vz + r * ldz + c];
        }
        if (t_col >= 0)
          for (int r = tid; r < R; r += nt)
            s.X[r * ldx + t_col] = __fadd_rn(t, __fmul_rn(cnf::kDpC[i], dt));
        __syncthreads();
        cnf::stage_fwd<false>(d, w, s, R);
        for (int idx = tid; idx < R * nz; idx += nt) {
          const int r = idx / nz, c = idx - r * nz;
          KZ[i * vz + r * ldz + c] = s.Y[r * ldy + c];
          float v = V[r * ldz + c];
          for (int j = 0; j <= i; ++j) {
            const float a = cnf::kDpA[i][j];
            if (a != 0.0f) v = fmaf(__fmul_rn(dt, a), KZ[j * vz + r * ldz + c], v);
          }
          V[(i + 1) * vz + r * ldz + c] = v;
        }
        __syncthreads();
      }
      // the six stages backward, last first
      for (int i = 5; i >= 0; --i) {
        for (int idx = tid; idx < R * nz; idx += nt) {
          const int r = idx / nz, c = idx - r * nz;
          s.X[r * ldx + c] = V[i * vz + r * ldz + c];
        }
        if (t_col >= 0)
          for (int r = tid; r < R; r += nt)
            s.X[r * ldx + t_col] = __fadd_rn(t, __fmul_rn(cnf::kDpC[i], dt));
        const float bi = cnf::kDpB[i];
        for (int idx = tid; idx < R * sd; idx += nt) {
          const int r = idx / sd, c = idx - r * sd;
          float kbar = bi != 0.0f ? __fmul_rn(__fmul_rn(dt, bi), A[r * lds + c]) : 0.0f;
          if (c < nz)
            for (int m = i + 1; m < 6; ++m) {
              const float a = cnf::kDpA[m - 1][i];
              if (a != 0.0f) kbar = fmaf(__fmul_rn(dt, a), VB[m * vz + r * ldz + c], kbar);
            }
          cnf::set_cotangent(b, r, c, nz, kbar);
        }
        __syncthreads();
        cnf::stage_fwd_keep<false>(d, w, b, R);
        cnf::stage_bwd<false>(d, w, b, R, nz, acc);
        for (int idx = tid; idx < R * nz; idx += nt) {
          const int r = idx / nz, c = idx - r * nz;
          VB[i * vz + r * ldz + c] = b.XB[r * ldx + c];
          EPSB[r * ldz + c] += b.EPB[r * ldz + c];
        }
        __syncthreads();
      }
      for (int idx = tid; idx < R * nz; idx += nt) {
        const int r = idx / nz, c = idx - r * nz;
        float a = A[r * lds + c];
        for (int i = 0; i < 6; ++i) a = __fadd_rn(a, VB[i * vz + r * ldz + c]);
        A[r * lds + c] = a;
      }
      __syncthreads();
    }

    for (int idx = tid; idx < R * sd; idx += nt) {
      const int r = idx / sd, c = idx - r * sd;
      u0bar[(long)r0 * sd + idx] = A[r * lds + c] * poison;
    }
    for (int idx = tid; idx < R * nz; idx += nt) {
      const int r = idx / nz, c = idx - r * nz;
      epsbar[(long)r0 * nz + idx] = EPSB[r * ldz + c] * poison;
    }
    __syncthreads();  // the next tile overwrites the buffers
  }
}

// The replay of the block's group.  H > 0: on the row path (blockDim.x ==
// g), H == 0: on the tiled path (blockDim.x == kThreads), as K5 runs it.
// Every thread returns with the group's accepted-step count and whether it
// finished.
template <int H>
__device__ __forceinline__ void replay_group(const float* u0, const float* eps, const float* ys,
                                             const cnf::Weights& gw, const cnf::Dims& d,
                                             const cnf::AdaptivePlan& pl, float t0, float t1,
                                             float* S, const Nodes& nodes, int B, int sd, int nc,
                                             int t_col, int g, const Solver& sv, float* smem,
                                             int& nacc, int& done) {
  const long row0 = (long)blockIdx.x * g;
  const int nz = d.nz;
  if constexpr (H > 0) {
    const cnf::RowWeights w = cnf::stage_row_weights<H, false>(gw, d, smem);
    float* p = smem + cnf::row_weight_floats(d, H);
    Ctl& c = *reinterpret_cast<Ctl*>(p);
    p += cnf::kCtlFloats;
    float* red = p;
    p += blockDim.x;
    float* row = p + threadIdx.x * cnf::adaptive_row_floats(d, sd);
    float* X = row + 9 * sd;
    float* EPS = X + d.n_in + d.n_out;
    const long r = row0 + threadIdx.x;
    const int ys_off = nz + (t_col >= 0 ? 1 : 0);
    for (int col = 0; col < sd; ++col) row[col] = u0[r * sd + col];
    for (int col = 0; col < nz; ++col) EPS[col] = eps[r * nz + col];
    for (int j = 0; j < nc; ++j) X[ys_off + j] = ys[r * nc + j];
    __syncthreads();
    cnf::solve_rows<H>(w, d, row, sd, t_col, t0, t1, sv, c, red, nodes, r, B);
    nacc = c.nacc;
    done = c.done;
  } else {
    float* p = smem;
    const cnf::Weights w = cnf::stage_weights(gw, d, pl.staged, p);
    cnf::StageBufs sb;
    p = cnf::carve_stage(p, pl.rows, d, sb);
    Ctl& c = *reinterpret_cast<Ctl*>(p);
    p += cnf::kCtlFloats;
    float* red = p;
    const int ss = cnf::kStateVecs * sd;
    float* Sg = S + row0 * ss;
    for (int idx = threadIdx.x; idx < g * sd; idx += blockDim.x) {
      const int r = idx / sd, col = idx - r * sd;
      Sg[(long)r * ss + col] = u0[row0 * sd + idx];
    }
    __syncthreads();
    cnf::solve_tiled(d, w, sb, pl.rows, g, Sg, eps + row0 * nz,
                     ys == nullptr ? ys : ys + row0 * nc, sd, nc, t_col, t0, t1, sv, c, red,
                     nodes, row0, B);
    nacc = c.nacc;
    done = c.done;
  }
}

// The tiled walk's kernel: the replay, then the walk, in one block a group
// (the shared memory is the larger of the two's).
template <int H>
__global__ void __launch_bounds__(cnf::kThreads)
adaptive_bwd(const float* __restrict__ u0, const float* __restrict__ eps,
             const float* __restrict__ ys, cnf::Weights gw, cnf::Dims d, cnf::AdaptivePlan pl,
             const float* __restrict__ t0p, const float* __restrict__ t1p,
             const float* __restrict__ gbar, float* __restrict__ u0bar,
             float* __restrict__ epsbar, float* __restrict__ S, Nodes nodes,
             float* __restrict__ partial, int* __restrict__ nacc_out, int B, int sd, int nc,
             int t_col, int g, long P, Solver sv) {
  extern __shared__ __align__(16) float smem[];
  const long row0 = (long)blockIdx.x * g;
  const int nz = d.nz;
  int nacc, done;
  replay_group<H>(u0, eps, ys, gw, d, pl, *t0p, *t1p, S, nodes, B, sd, nc, t_col, g, sv, smem,
                  nacc, done);
  __syncthreads();  // every thread holds the counts: the shared memory is reused

  const bool ok = done && nacc <= nodes.max_nodes;
  const float poison = ok ? 1.0f : __int_as_float(0x7fc00000);
  float* p = smem;
  const cnf::Weights w = cnf::stage_weights(gw, d, pl.staged, p);
  float* acc = partial + (long)blockIdx.x * P;
  if (pl.acc_smem) {
    acc = p;
    p += P;
  }
  // each entry of acc is zeroed, summed and written by the same thread
  for (long q = threadIdx.x; q < P; q += blockDim.x) acc[q] = 0.0f;
  walk_back(d, w, p, pl.bwd_rows, g, row0, eps + row0 * nz, ys == nullptr ? ys : ys + row0 * nc,
            gbar + row0 * sd, u0bar + row0 * sd, epsbar + row0 * nz, nodes,
            min(nacc, nodes.max_nodes), acc, sd, nc, t_col, B, poison);
  for (long q = threadIdx.x; q < P; q += blockDim.x)
    partial[(long)blockIdx.x * P + q] = ok ? acc[q] : acc[q] * poison;
  if (threadIdx.x == 0) nacc_out[blockIdx.x] = nacc;
}

// The row walk's first kernel: the replay alone.  Writes the group's
// accepted-step count and whether it finished.
template <int H>
__device__ __forceinline__ void replay_only(const float* u0, const float* eps, const float* ys,
                                            const cnf::Weights& gw, const cnf::Dims& d,
                                            const cnf::AdaptivePlan& pl, const float* t0p,
                                            const float* t1p, float* S, const Nodes& nodes,
                                            int* nacc_out, int* done_out, int B, int sd, int nc,
                                            int t_col, int g, const Solver& sv) {
  extern __shared__ __align__(16) float smem[];
  int nacc, done;
  replay_group<H>(u0, eps, ys, gw, d, pl, *t0p, *t1p, S, nodes, B, sd, nc, t_col, g, sv, smem,
                  nacc, done);
  if (threadIdx.x == 0) {
    nacc_out[blockIdx.x] = nacc;
    done_out[blockIdx.x] = done;
  }
}

// On the row path, with K5's block, shared memory and launch bounds.
template <int H>
__global__ void __launch_bounds__(cnf::kMaxGroup, cnf::kRowGroupsPerSM)
adaptive_replay(const float* __restrict__ u0, const float* __restrict__ eps,
                const float* __restrict__ ys, cnf::Weights gw, cnf::Dims d, cnf::AdaptivePlan pl,
                const float* __restrict__ t0p, const float* __restrict__ t1p,
                float* __restrict__ S, Nodes nodes, int* __restrict__ nacc_out,
                int* __restrict__ done_out, int B, int sd, int nc, int t_col, int g, Solver sv) {
  replay_only<H>(u0, eps, ys, gw, d, pl, t0p, t1p, S, nodes, nacc_out, done_out, B, sd, nc,
                 t_col, g, sv);
}

// On the tiled path, as K5 runs it: nets whose rows do not fit K5's row path
// but whose walk fits the row walk.
__global__ void __launch_bounds__(cnf::kThreads)
adaptive_replay_tiled(const float* __restrict__ u0, const float* __restrict__ eps,
                      const float* __restrict__ ys, cnf::Weights gw, cnf::Dims d,
                      cnf::AdaptivePlan pl, const float* __restrict__ t0p,
                      const float* __restrict__ t1p, float* __restrict__ S, Nodes nodes,
                      int* __restrict__ nacc_out, int* __restrict__ done_out, int B, int sd,
                      int nc, int t_col, int g, Solver sv) {
  replay_only<0>(u0, eps, ys, gw, d, pl, t0p, t1p, S, nodes, nacc_out, done_out, B, sd, nc,
                 t_col, g, sv);
}

// The walk on the row path: one row per thread, kRowBwdThreads rows a block,
// `bpg` blocks a group.  Shared memory: the staged weights, the block's P
// weight-gradient sums, the column buffers of row_stage_bwd.cuh, then each
// thread's own row (adaptive_walk_row_ld, odd stride): X, EPS, Y (the
// row_stage input and the kept stage's output), E (e_z), UZ (the node's z),
// KZ (k_0..k_4), VB (vbar_0..vbar_5), EPSB (epsbar), A (the state cotangent).
template <int H>
__global__ void __launch_bounds__(cnf::kRowBwdThreads)
walk_rows(const float* __restrict__ eps, const float* __restrict__ ys, cnf::Weights gw,
          cnf::Dims d, const float* __restrict__ gbar, float* __restrict__ u0bar,
          float* __restrict__ epsbar, Nodes nodes, float* __restrict__ partial,
          const int* __restrict__ nacc_in, const int* __restrict__ done_in, int B, int sd,
          int nc, int t_col, int g, int bpg) {
  extern __shared__ __align__(16) float smem[];
  const cnf::RowWeights w = cnf::stage_row_weights<H, false>(gw, d, smem);
  const long P = cnf::param_count(d);
  float* acc = smem + cnf::round4(cnf::row_weight_floats(d, H));
  float* cols = acc + cnf::round4(P);
  cnf::RowCols c;
  float* own = cnf::carve_row_cols(cols, H, d, c);
  const int nz = d.nz, n_in = d.n_in;
  const int tid = threadIdx.x, nt = blockDim.x;
  float* X = own + tid * cnf::adaptive_walk_row_ld(d, sd);
  float* EPS = X + n_in;
  float* Y = EPS + nz;
  float* E = Y + d.n_out;
  float* UZ = E + nz;
  float* KZ = UZ + nz;
  float* VB = KZ + 5 * nz;
  float* EPSB = VB + 6 * nz;
  float* A = EPSB + nz;
  // rows past the block's keep zero columns: they add nothing to the sums
  const long one = c.ONE - cols;
  for (long idx = tid; idx < (long)(own - cols); idx += nt)
    cols[idx] = idx >= one && idx < one + cnf::kRowLd ? 1.0f : 0.0f;
  // each entry of acc is zeroed, summed and written by the same thread
  for (long q = tid; q < P; q += nt) acc[q] = 0.0f;
  __syncthreads();

  const int group = blockIdx.x / bpg, sub = blockIdx.x - group * bpg;
  const long row0 = (long)group * g + (long)sub * nt;
  const int R = g - sub * nt < nt ? g - sub * nt : nt;  // the group's last block
  const int R4 = (R + 3) & ~3;
  const bool active = tid < R;
  const long row = row0 + tid;
  const int nacc = nacc_in[group];
  const bool ok = done_in[group] && nacc <= nodes.max_nodes;
  const float poison = ok ? 1.0f : __int_as_float(0x7fc00000);
  const int walk = min(nacc, nodes.max_nodes);
  const float* tdt = nodes.tdt + (long)group * nodes.max_nodes * 2;
  const cnf::RowCols my = c.at(tid);
  const int ys_off = nz + (t_col >= 0 ? 1 : 0);
  constexpr int ld = cnf::kRowLd;
  if (active) {
    for (int k = 0; k < nz; ++k) {
      const float e = eps[row * nz + k];
      EPS[k] = e;
      my.EPS[k * ld] = e;
      EPSB[k] = 0.0f;
    }
    for (int k = 0; k < sd; ++k) A[k] = gbar[row * sd + k];
    for (int j = 0; j < nc; ++j) {
      const float y = ys[row * nc + j];
      X[ys_off + j] = y;
      my.X[(ys_off + j) * ld] = y;
    }
    cnf::row_keep_u2<H, false>(w, d, my);
  }

  for (int n = walk - 1; n >= 0; --n) {
    const float t = tdt[2 * n], dt = tdt[2 * n + 1];
    if (active) {
      for (int k = 0; k < nz; ++k) UZ[k] = nodes.traj[((long)n * nz + k) * B + row];
      // k_0..k_4 again: they build the stage inputs v_1..v_5; rolled, as the
      // stages below: one copy of the stage code stays in the instruction cache
#pragma unroll 1
      for (int i = 0; i < 5; ++i) {
        for (int k = 0; k < nz; ++k) X[k] = cnf::stage_input(i, UZ[k], KZ + k, nz, dt);
        if (t_col >= 0) X[t_col] = __fadd_rn(t, __fmul_rn(cnf::kDpC[i], dt));
        float dv, ry, re;
        cnf::row_stage<H, false>(w, d, X, EPS, KZ + i * nz, nullptr, dv, ry, re);
      }
    }
    // the six stages backward, last first
#pragma unroll 1
    for (int i = 5; i >= 0; --i) {
      if (active) {
        for (int k = 0; k < nz; ++k) my.X[k * ld] = cnf::stage_input(i, UZ[k], KZ + k, nz, dt);
        if (t_col >= 0) my.X[t_col * ld] = __fadd_rn(t, __fmul_rn(cnf::kDpC[i], dt));
        const float bi = cnf::kDpB[i];
        float ct[3];  // divbar, rzbar, rjbar of the stage
        for (int k = 0; k < sd; ++k) {
          float kbar = bi != 0.0f ? __fmul_rn(__fmul_rn(dt, bi), A[k]) : 0.0f;
          if (k < nz)
            for (int m = i + 1; m < 6; ++m) {
              const float a = cnf::kDpA[m - 1][i];
              if (a != 0.0f) kbar = fmaf(__fmul_rn(dt, a), VB[m * nz + k], kbar);
            }
          cnf::set_row_cotangent(my, k, nz, kbar, ct);
        }
        float dv, ry, re;
        cnf::row_stage_keep<H, false>(w, d, my, Y, E, dv, ry, re);
        cnf::row_stage_bwd<H, false>(w, d, my, Y, E, ry, re, ct[0], ct[1], ct[2], nz,
                                     VB + i * nz, EPSB);
      }
      __syncthreads();
      cnf::row_accumulate_wgrads<H, false>(d, c, R4, acc);
      __syncthreads();
    }
    if (active)
      for (int k = 0; k < nz; ++k) {
        float a = A[k];
        for (int i = 0; i < 6; ++i) a = __fadd_rn(a, VB[i * nz + k]);
        A[k] = a;
      }
  }

  if (active) {
    for (int k = 0; k < sd; ++k) u0bar[row * sd + k] = A[k] * poison;
    for (int k = 0; k < nz; ++k) epsbar[row * nz + k] = EPSB[k] * poison;
  }
  for (long q = tid; q < P; q += nt)
    partial[(long)blockIdx.x * P + q] = ok ? acc[q] : acc[q] * poison;
}

// The cluster path's walk: K5's record of the group (cluster_adaptive.cuh)
// walked back on a cluster of K5's shape, each CTA its rows, the weight
// gradient summed into each CTA's share over the cluster's rows and written
// once to the group's row of `partial`.  With Res the walk holds the weight
// image in shared memory, else it reads the device-memory weights.
template <bool Res>
__global__ void __launch_bounds__(cnf::kClusterThreads, 1)
adaptive_bwd_cluster(const float* __restrict__ eps, const float* __restrict__ ys, cnf::Weights gw,
                     const float* __restrict__ image, cnf::Dims d, cnf::ClusterPlan cp,
                     const float* __restrict__ gbar, float* __restrict__ u0bar,
                     float* __restrict__ epsbar, Nodes nodes, const int* __restrict__ nacc_in,
                     const int* __restrict__ done_in, float* __restrict__ partial, int B, int sd,
                     int nc, int t_col, int g, long P) {
  extern __shared__ __align__(16) float smem[];
  const int C = cp.cluster, rank = (int)cnf::cg::this_cluster().block_rank(), R = cp.rows;
  const long grp = blockIdx.x / C, row0 = grp * g + (long)rank * R;
  const int nz = d.nz;
  float* p = smem;
  const cnf::CWeights w = cnf::cluster_weights<Res>(gw, image, d, p);
  const int nacc = nacc_in[grp];
  const bool ok = done_in[grp] && nacc <= nodes.max_nodes;
  const float poison = ok ? 1.0f : __int_as_float(0x7fc00000);
  const cnf::GradShare share = cnf::carve_share(p, d, C, rank);
  for (int q = threadIdx.x; q < cp.share; q += blockDim.x) p[q] = 0.0f;
  cnf::cl_walk<Res>(d, w, p + cp.share, cp.walk_rows, R, row0, grp, eps + row0 * nz,
                    ys == nullptr ? ys : ys + row0 * nc, gbar + row0 * sd, u0bar + row0 * sd,
                    epsbar + row0 * nz, nodes, min(nacc, nodes.max_nodes), share, sd, nc, t_col,
                    B, poison);
  cnf::write_share(d, share, partial + grp * P, ok, poison);
  cnf::cg::this_cluster().sync();  // no CTA leaves while a peer may reach its shared memory
}

cudaError_t launch(const float* u0, const float* eps, const float* ys, const cnf::Weights& w,
                   const float* image, const cnf::Dims& d, const float* t0, const float* t1,
                   const float* gbar, float* u0bar, float* epsbar, float* S, const Nodes& nodes,
                   float* partial, float* grads, int* nacc, int* done, int B, int sd, int nc,
                   int t_col, int g, int path, const Solver& s, cudaStream_t stream) {
  const cnf::AdaptivePlan pl = cnf::adaptive_plan(d, sd, g);
  if (pl.smem_fwd == 0 || pl.smem_bwd == 0) return cudaErrorInvalidValue;
  const int groups = B / g, grid = groups * pl.walk_blocks;
  const long P = cnf::param_count(d);
  const int threads = pl.H > 0 ? g : cnf::kThreads;  // K5's block shape
  cudaError_t err;
  if (pl.H == 0 && pl.walk_H == 0) {
    const cnf::ClusterPlan cp = cnf::cluster_plan(d, sd, g, B, path);
    if (cp.cluster) {
      if ((cp.res_bwd && image == nullptr) || nodes.traj == nullptr || done == nullptr)
        return cudaErrorInvalidValue;
      const auto kernel = cp.res_bwd ? adaptive_bwd_cluster<true> : adaptive_bwd_cluster<false>;
      err = cnf::launch_cluster(kernel, groups * cp.cluster, cp.cluster, cp.smem_bwd, stream, eps,
                                ys, w, image, d, cp, gbar, u0bar, epsbar, nodes, nacc, done,
                                partial, B, sd, nc, t_col, g, P);
      if (err != cudaSuccess) return err;
      return cnf::launch_reduce(partial, groups, P, grads, stream);
    }
  }
  if (path >= 1) return cudaErrorInvalidValue;  // the cluster path was asked for and does not fit
  if (pl.walk_H == 0) {
    // H = 0 (the tiled replay), 4, 8, ..., 32 (row_fwd_H)
    decltype(&adaptive_bwd<0>) const kernels[] = {
        adaptive_bwd<0>,  adaptive_bwd<4>,  adaptive_bwd<8>,  adaptive_bwd<12>, adaptive_bwd<16>,
        adaptive_bwd<20>, adaptive_bwd<24>, adaptive_bwd<28>, adaptive_bwd<32>};
    const auto kernel = kernels[pl.H / 4];
    err = cnf::set_smem(kernel, pl.smem_bwd);
    if (err != cudaSuccess) return err;
    kernel<<<groups, threads, pl.smem_bwd, stream>>>(u0, eps, ys, w, d, pl, t0, t1, gbar, u0bar,
                                                     epsbar, S, nodes, partial, nacc, B, sd, nc,
                                                     t_col, g, P, s);
  } else {
    // H = 0 (the tiled replay), 4, 8, ..., 32 (row_fwd_H)
    decltype(&adaptive_replay_tiled) const replays[] = {
        adaptive_replay_tiled, adaptive_replay<4>,  adaptive_replay<8>,
        adaptive_replay<12>,   adaptive_replay<16>, adaptive_replay<20>,
        adaptive_replay<24>,   adaptive_replay<28>, adaptive_replay<32>};
    const auto replay = replays[pl.H / 4];
    err = pl.H ? cnf::set_row_smem(replay, pl.smem_fwd) : cnf::set_smem(replay, pl.smem_fwd);
    if (err != cudaSuccess) return err;
    replay<<<groups, threads, pl.smem_fwd, stream>>>(u0, eps, ys, w, d, pl, t0, t1, S, nodes,
                                                     nacc, done, B, sd, nc, t_col, g, s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    auto walk = walk_rows<32>;
    if (pl.walk_H == 8) walk = walk_rows<8>;
    if (pl.walk_H == 16) walk = walk_rows<16>;
    if (pl.walk_H == 24) walk = walk_rows<24>;
    err = cnf::set_smem(walk, pl.smem_bwd);
    if (err != cudaSuccess) return err;
    walk<<<grid, cnf::kRowBwdThreads, pl.smem_bwd, stream>>>(
        eps, ys, w, d, gbar, u0bar, epsbar, nodes, partial, nacc, done, B, sd, nc, t_col, g,
        pl.walk_blocks);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return cnf::launch_reduce(partial, grid, P, grads, stream);
}

}  // namespace

// Weights, image and path as for cnf_fused_adaptive_fwd.  gbar: the
// cotangent of u1 (B, sd).  S: scratch of B x 9 x sd floats (the tiled
// replay); traj: max_nodes x nz x B floats; tdt: (B / group) x max_nodes x 2
// floats; partial: (B / group) x walk_blocks x P floats (cnf_adaptive_plan),
// (B / group) x P on the cluster path; grads receives the P weight gradients
// in the layout of cnf_fused_dynamics_bwd; nacc and done: (B / group) ints
// each, every group's accepted steps in the replay and whether it finished
// (done is the row walk's own scratch, read only where the walk is a kernel
// apart from the replay: walk_H > 0).  On the cluster path K6 only walks:
// traj, tdt, nacc and done are then K5's record (cnf_fused_adaptive_fwd with
// rec: traj max_nodes x 6 x nz x B floats), read and not written, and u0,
// t0, t1 and S are not read.
extern "C" int cnf_fused_adaptive_bwd(const float* u0, const float* eps, const float* ys,
                                      const float* A1, const float* b1, const float* A2,
                                      const float* b2, const float* A3, const float* b3,
                                      const float* W1t, const float* W2t, const float* W3t,
                                      const float* image, const float* t0, const float* t1,
                                      const float* gbar, float* u0bar, float* epsbar, float* S,
                                      float* traj, float* tdt, float* partial, float* grads,
                                      int* nacc, int* done, int B, int sd, int n_in, int h,
                                      int n_out, int nz, int nc, int t_col, int group, int path,
                                      int max_nodes, int max_steps,
                                      float rtol, float atol, float dt0f, float safety,
                                      float min_f, float max_f, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (group <= 0 || group > cnf::kMaxGroup || B % group != 0 || max_nodes < 1)
    return cudaErrorInvalidValue;
  const cnf::Weights w{W1t, W2t, W3t, A1, A2, A3, b1, b2, b3};
  const cnf::Dims d{n_in, h, n_out, nz};
  const Solver s{rtol, atol, dt0f, safety, min_f, max_f, max_steps};
  return launch(u0, eps, ys, w, image, d, t0, t1, gbar, u0bar, epsbar, S,
                Nodes{traj, tdt, max_nodes}, partial, grads, nacc, done, B, sd, nc, t_col, group,
                path, s, static_cast<cudaStream_t>(stream));
}
