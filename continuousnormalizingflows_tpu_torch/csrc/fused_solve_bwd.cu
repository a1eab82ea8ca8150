// K4 on Hopper: the exact discrete backward of the whole fixed-step RK4
// solve (K3) -- cotangents of u1 with respect to u0, eps and the six weights.
//
// Replaces continuousnormalizingflows_tpu/ops/pallas_solve.py
// _solve_bwd_kernel (custom-VJP rule _fused_solve_bwd).  Per row:
//   1. recompute the step trajectory u_0 .. u_{steps-1} (z columns only: the
//      accumulator columns never enter a stage) into a device scratch buffer
//      of steps x B x nz floats.  The TPU kept it in VMEM; a block's shared
//      memory cannot hold 32 steps of its rows next to the stage buffers,
//      and the buffer is written and read once per step;
//   2. walk the steps backward.  For step n, recompute k1..k3 to get the
//      stage inputs v1, v2, v3, then take the four stage VJPs in reverse,
//      each after recomputing its stage with every intermediate kept,
//      through the RK4 chain rule:
//        k4b = dt/6 a;             v3b = vjp(t + dt,   v3; k4b)
//        k3b = dt/3 a + dt v3b;    v2b = vjp(t + dt/2, v2; k3b)
//        k2b = dt/3 a + dt/2 v2b;  v1b = vjp(t + dt/2, v1; k2b)
//        k1b = dt/6 a + dt/2 v1b;  u0b = vjp(t,        u;  k1b)
//        a <- a + v3b + v2b + v1b + u0b
//      epsbar and the weight gradients accumulate over stages, steps and
//      rows; the weight gradients go into the block's own row of a
//      (grid, P) buffer of partial sums, reduced in a fixed order by a second
//      kernel (stage_bwd.cuh), so the gradients are the same bits on every
//      run.
// The cotangent of the conditions ys is not computed (the JAX kernel returns
// zeros for it too), nor that of t0 and t1.
//
// What bounds it on an H100: FMA issue.  At the flagship (6 -> 24 -> 24 -> 5,
// B = 65,536, 32 steps) the function needs 4 stage forwards (1,656 FMA a row)
// and 4 stage backwards (3,341: six products and the weight-gradient outer
// products) a step, less the terms of eps, which is fixed over the solve: u2
// = A3^T eps, and the backward's u2bar A3^T and eps^T u2bar, are needed once
// a row.  That is 78.2 GFLOP, 1.17 ms at the fp32 peak of 67 TFLOP/s, against
// ~3 MB of device traffic.  As designed, with the trajectory and the k1..k3
// recompute, the row path does 11 stage forwards (4 of them on the row's
// kept u2) and 4 backwards a step: 130.5 GFLOP, 1.95 ms at that peak.
//
// Three paths, chosen from the widths (solve_bwd_shape below):
//   * h <= 32, one row per thread: a trajectory kernel (solve_traj_rows)
//     runs K3's row stage and stores u_n as [step][col][row], so a warp's
//     stores and the walk's loads are contiguous; the walk back
//     (fused_solve_rk4_bwd_rows) recomputes k1..k3 with the same row_stage,
//     keeps each stage's intermediates in per-row shared-memory columns
//     (row_stage_keep), takes its backward with the accumulators in
//     registers (row_stage_bwd) and, after one block synchronisation, sums
//     the weight-gradient terms of the block's 64 rows (row_accumulate_wgrads).
//     The tiled design this replaces at these widths kept ~21 of 256 threads
//     busy in the products with N = nz, synchronised its block ~10 times a
//     stage and summed the weight gradients serially over 66-row tiles.
//   * 32 < h < kSolveWideMinH, tiles of rows per block: the products of
//     stage.cuh and stage_bwd.cuh (fused_solve_rk4_bwd_kernel), every buffer
//     in shared memory;
//   * h >= kSolveWideMinH, the wide path (wide_solve.cuh): the trajectory and
//     the walk back as a chain of dense products over the whole batch, bf16
//     on the tensor cores, the weight gradients as products of depth 2B
//     accumulated stage by stage in a fixed order; its header has the design.
//
// C interface for ctypes: returns a cudaError_t (0 on success).

#include <climits>

#include "row_stage_bwd.cuh"
#include "wide_solve.cuh"

namespace {

template <bool BF16>
__global__ void __launch_bounds__(cnf::kThreads)
fused_solve_rk4_bwd_kernel(const float* __restrict__ u0, const float* __restrict__ eps,
                           const float* __restrict__ ys, cnf::Weights gw, cnf::Dims d,
                           bool staged, bool acc_smem, const float* __restrict__ t0p,
                           const float* __restrict__ dtp, const float* __restrict__ gbar,
                           float* __restrict__ u0bar, float* __restrict__ epsbar,
                           float* __restrict__ traj, float* __restrict__ partial, int B, int sd,
                           int nc, int t_col, int steps, int rows, long P) {
  extern __shared__ __align__(16) float smem[];
  float* p = smem;
  const cnf::Weights w = cnf::stage_weights(gw, d, staged, p);
  float* acc = partial + (long)blockIdx.x * P;
  if (acc_smem) {
    acc = p;
    p += P;
  }
  cnf::BwdBufs b;
  p = cnf::carve_bwd(p, rows, d, b);
  const cnf::StageBufs& s = b.f;
  const int nz = d.nz, ldx = s.ldx, ldy = s.ldy, ldz = s.ldz, lds = cnf::odd(sd);
  float* A = p;   p += rows * lds;  // state cotangent a
  float* AN = p;  p += rows * lds;  // a + v3b + v2b + v1b + u0b
  float* UZ = p;  p += rows * ldz;  // z of u_n
  float* V1 = p;  p += rows * ldz;  // z of u_n + dt/2 k1 (the forward pass: the RK4 sum)
  float* V2 = p;  p += rows * ldz;  // z of u_n + dt/2 k2
  float* V3 = p;  p += rows * ldz;  // z of u_n + dt k3
  float* EPSB = p;                  // epsbar

  const int tid = threadIdx.x, nt = blockDim.x;
  const int ys_off = nz + (t_col >= 0 ? 1 : 0);
  const float t0 = *t0p, dt = *dtp;
  const float half = 0.5f * dt;
  // each entry of acc is zeroed, summed and written by the same thread
  for (long q = tid; q < P; q += nt) acc[q] = 0.0f;

  for (long row0 = (long)blockIdx.x * rows; row0 < B; row0 += (long)gridDim.x * rows) {
    const int R = (long)B - row0 < rows ? (int)((long)B - row0) : rows;  // ragged last tile
    for (int idx = tid; idx < R * nz; idx += nt) {
      const int r = idx / nz, c = idx - r * nz;
      s.EPS[r * ldz + c] = eps[row0 * nz + idx];
      EPSB[r * ldz + c] = 0.0f;
    }
    for (int idx = tid; idx < R * sd; idx += nt) {
      const int r = idx / sd, c = idx - r * sd;
      A[r * lds + c] = gbar[row0 * sd + idx];
      if (c < nz) UZ[r * ldz + c] = u0[row0 * sd + idx];
    }
    for (int idx = tid; idx < R * nc; idx += nt) {
      const int r = idx / nc, j = idx - r * nc;
      s.X[r * ldx + ys_off + j] = ys[row0 * nc + idx];
    }
    __syncthreads();

    // ---- 1. the step trajectory, as K3 computes it ----
    for (int i = 0; i < steps; ++i) {
      const float t = t0 + (float)i * dt;
      for (int idx = tid; idx < R * nz; idx += nt) {
        const int r = idx / nz, c = idx - r * nz;
        const float u = UZ[r * ldz + c];
        traj[((long)i * B + row0 + r) * nz + c] = u;
        s.X[r * ldx + c] = u;
      }
      if (t_col >= 0)
        for (int r = tid; r < R; r += nt) s.X[r * ldx + t_col] = t;
      __syncthreads();
      cnf::stage_fwd<BF16>(d, w, s, R);
      for (int idx = tid; idx < R * nz; idx += nt) {  // k2 at (t + dt/2, u + dt/2 k1)
        const int r = idx / nz, c = idx - r * nz;
        const float k = s.Y[r * ldy + c];
        V1[r * ldz + c] = k;
        s.X[r * ldx + c] = UZ[r * ldz + c] + half * k;
      }
      if (t_col >= 0)
        for (int r = tid; r < R; r += nt) s.X[r * ldx + t_col] = t + half;
      __syncthreads();
      cnf::stage_fwd<BF16>(d, w, s, R);
      for (int idx = tid; idx < R * nz; idx += nt) {  // k3 at (t + dt/2, u + dt/2 k2)
        const int r = idx / nz, c = idx - r * nz;
        const float k = s.Y[r * ldy + c];
        V1[r * ldz + c] = V1[r * ldz + c] + 2.0f * k;
        s.X[r * ldx + c] = UZ[r * ldz + c] + half * k;
      }
      __syncthreads();
      cnf::stage_fwd<BF16>(d, w, s, R);
      for (int idx = tid; idx < R * nz; idx += nt) {  // k4 at (t + dt, u + dt k3)
        const int r = idx / nz, c = idx - r * nz;
        const float k = s.Y[r * ldy + c];
        V1[r * ldz + c] = V1[r * ldz + c] + 2.0f * k;
        s.X[r * ldx + c] = UZ[r * ldz + c] + dt * k;
      }
      if (t_col >= 0)
        for (int r = tid; r < R; r += nt) s.X[r * ldx + t_col] = t + dt;
      __syncthreads();
      cnf::stage_fwd<BF16>(d, w, s, R);
      for (int idx = tid; idx < R * nz; idx += nt) {
        const int r = idx / nz, c = idx - r * nz;
        UZ[r * ldz + c] = UZ[r * ldz + c] + (dt / 6.0f) * (V1[r * ldz + c] + s.Y[r * ldy + c]);
      }
      __syncthreads();
    }

    // ---- 2. the steps backward, through the RK4 chain rule ----
    for (int n = steps - 1; n >= 0; --n) {
      const float t = t0 + (float)n * dt;
      for (int idx = tid; idx < R * nz; idx += nt) {
        const int r = idx / nz, c = idx - r * nz;
        const float u = traj[((long)n * B + row0 + r) * nz + c];
        UZ[r * ldz + c] = u;
        s.X[r * ldx + c] = u;
      }
      if (t_col >= 0)
        for (int r = tid; r < R; r += nt) s.X[r * ldx + t_col] = t;
      __syncthreads();
      cnf::stage_fwd<BF16>(d, w, s, R);
      for (int idx = tid; idx < R * nz; idx += nt) {  // v1 = u + dt/2 k1
        const int r = idx / nz, c = idx - r * nz;
        const float v = UZ[r * ldz + c] + half * s.Y[r * ldy + c];
        V1[r * ldz + c] = v;
        s.X[r * ldx + c] = v;
      }
      if (t_col >= 0)
        for (int r = tid; r < R; r += nt) s.X[r * ldx + t_col] = t + half;
      __syncthreads();
      cnf::stage_fwd<BF16>(d, w, s, R);
      for (int idx = tid; idx < R * nz; idx += nt) {  // v2 = u + dt/2 k2
        const int r = idx / nz, c = idx - r * nz;
        const float v = UZ[r * ldz + c] + half * s.Y[r * ldy + c];
        V2[r * ldz + c] = v;
        s.X[r * ldx + c] = v;
      }
      __syncthreads();
      cnf::stage_fwd<BF16>(d, w, s, R);
      for (int idx = tid; idx < R * nz; idx += nt) {  // v3 = u + dt k3
        const int r = idx / nz, c = idx - r * nz;
        const float v = UZ[r * ldz + c] + dt * s.Y[r * ldy + c];
        V3[r * ldz + c] = v;
        s.X[r * ldx + c] = v;
      }
      if (t_col >= 0)
        for (int r = tid; r < R; r += nt) s.X[r * ldx + t_col] = t + dt;
      for (int idx = tid; idx < R * sd; idx += nt) {  // k4b = dt/6 a
        const int r = idx / sd, c = idx - r * sd;
        const float a = A[r * lds + c];
        AN[r * lds + c] = a;
        cnf::set_cotangent(b, r, c, nz, (dt / 6.0f) * a);
      }
      __syncthreads();

      // stage 4 at (t + dt, v3), then 3 at (t + dt/2, v2), 2 at (t + dt/2, v1), 1 at (t, u)
      for (int st = 3; st >= 0; --st) {
        cnf::stage_fwd_keep<BF16>(d, w, b, R);
        cnf::stage_bwd<BF16>(d, w, b, R, nz, acc);
        // the stage's input cotangent vb = xbar[:nz]: a_new += vb, and the
        // cotangent and input of the stage before it (k3b, k2b, k1b)
        const float ca = st == 1 ? dt / 6.0f : dt / 3.0f;  // a's weight in it
        const float cv = st == 3 ? dt : half;              // vb's weight in it
        const float* vnext = st == 3 ? V2 : st == 2 ? V1 : UZ;
        for (int idx = tid; idx < R * sd; idx += nt) {
          const int r = idx / sd, c = idx - r * sd;
          const float a = A[r * lds + c];
          if (c < nz) {
            const float vb = b.XB[r * ldx + c];
            AN[r * lds + c] = AN[r * lds + c] + vb;
            EPSB[r * ldz + c] += b.EPB[r * ldz + c];
            if (st > 0) {
              cnf::set_cotangent(b, r, c, nz, ca * a + cv * vb);
              s.X[r * ldx + c] = vnext[r * ldz + c];
            }
          } else if (st > 0) {
            cnf::set_cotangent(b, r, c, nz, ca * a);  // vb is 0 past the z columns
          }
        }
        if (st == 1 && t_col >= 0)
          for (int r = tid; r < R; r += nt) s.X[r * ldx + t_col] = t;
        else if (st == 3 && t_col >= 0)
          for (int r = tid; r < R; r += nt) s.X[r * ldx + t_col] = t + half;
        __syncthreads();
      }
      for (int idx = tid; idx < R * sd; idx += nt) {
        const int r = idx / sd, c = idx - r * sd;
        A[r * lds + c] = AN[r * lds + c];
      }
      __syncthreads();
    }

    for (int idx = tid; idx < R * sd; idx += nt) {
      const int r = idx / sd, c = idx - r * sd;
      u0bar[row0 * sd + idx] = A[r * lds + c];
    }
    for (int idx = tid; idx < R * nz; idx += nt) {
      const int r = idx / nz, c = idx - r * nz;
      epsbar[row0 * nz + idx] = EPSB[r * ldz + c];
    }
    __syncthreads();  // the next tile overwrites the buffers
  }
  if (acc_smem)
    for (long q = tid; q < P; q += nt) partial[(long)blockIdx.x * P + q] = acc[q];
}

// ---- the row path (h <= 32) ----

// The step trajectory of the z columns, one row per thread, as K3's row path
// computes it: traj[(i * nz + c) * B + row] = z_c of u_i.
template <int H, bool BF16>
__global__ void __launch_bounds__(cnf::kTrajThreads)
solve_traj_rows(const float* __restrict__ u0, const float* __restrict__ eps,
                const float* __restrict__ ys, cnf::Weights gw, cnf::Dims d,
                const float* __restrict__ t0p, const float* __restrict__ dtp,
                float* __restrict__ traj, int B, int sd, int nc, int t_col, int steps) {
  extern __shared__ __align__(16) float smem[];
  const cnf::RowWeights w = cnf::stage_row_weights<H, BF16>(gw, d, smem);
  const int nz = d.nz;
  float* X = smem + cnf::row_weight_floats(d, H) + threadIdx.x * cnf::odd(d.n_in + d.n_out + 3 * nz);
  float* Y = X + d.n_in;
  float* EPS = Y + d.n_out;
  float* UZ = EPS + nz;
  float* ACC = UZ + nz;
  __syncthreads();
  const long row = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;

  const int ys_off = nz + (t_col >= 0 ? 1 : 0);
  const float t0 = *t0p, dt = *dtp;
  for (int c = 0; c < nz; ++c) UZ[c] = u0[row * sd + c];
  for (int c = 0; c < nz; ++c) EPS[c] = eps[row * nz + c];
  for (int j = 0; j < nc; ++j) X[ys_off + j] = ys[row * nc + j];

  for (int i = 0; i < steps; ++i) {
    for (int c = 0; c < nz; ++c) traj[((long)i * nz + c) * B + row] = UZ[c];
    cnf::row_rk4_step<H, BF16>(w, d, X, EPS, Y, UZ, ACC, nz, t_col, t0 + (float)i * dt, dt);
  }
}

// Floats of a thread's own row in the walk back: the row_stage input, its
// output, e_z, the RK4 stage inputs, the cotangents.
__host__ __device__ inline int solve_row_ld(const cnf::Dims& d, int sd) {
  return cnf::odd(d.n_in + d.n_out + 8 * d.nz + 2 * sd);
}

// The walk back, one row per thread (kRowBwdThreads rows a block).  Shared
// memory: the staged weights, the block's P weight-gradient sums, the column
// buffers of row_stage_bwd.cuh, then each thread's own row (odd stride) of
// its state: X, EPS, Y (the row_stage input and output), E (e_z), UZ, V1,
// V2, V3 (the z of the four stage inputs), EPSB (epsbar), XB (xbar), A, AN
// (the state cotangent and its update).
template <int H, bool BF16>
__global__ void __launch_bounds__(cnf::kRowBwdThreads)
fused_solve_rk4_bwd_rows(const float* __restrict__ eps, const float* __restrict__ ys,
                         cnf::Weights gw, cnf::Dims d, const float* __restrict__ t0p,
                         const float* __restrict__ dtp, const float* __restrict__ gbar,
                         const float* __restrict__ traj, float* __restrict__ u0bar,
                         float* __restrict__ epsbar, float* __restrict__ partial, int B, int sd,
                         int nc, int t_col, int steps) {
  extern __shared__ __align__(16) float smem[];
  const cnf::RowWeights w = cnf::stage_row_weights<H, BF16>(gw, d, smem);
  const long P = cnf::param_count(d);
  float* acc = smem + cnf::round4(cnf::row_weight_floats(d, H));
  float* cols = acc + cnf::round4(P);
  cnf::RowCols c;
  float* own = cnf::carve_row_cols(cols, H, d, c);
  const int nz = d.nz, n_in = d.n_in;
  const int tid = threadIdx.x, nt = blockDim.x;
  float* X = own + tid * solve_row_ld(d, sd);
  float* EPS = X + n_in;
  float* Y = EPS + nz;
  float* E = Y + d.n_out;
  float* UZ = E + nz;
  float* V1 = UZ + nz;
  float* V2 = V1 + nz;
  float* V3 = V2 + nz;
  float* EPSB = V3 + nz;
  float* XB = EPSB + nz;
  float* A = XB + nz;
  float* AN = A + sd;
  // rows past the batch keep zero columns: they add nothing to the sums
  const long one = c.ONE - cols;
  for (long idx = tid; idx < (long)(own - cols); idx += nt)
    cols[idx] = idx >= one && idx < one + cnf::kRowLd ? 1.0f : 0.0f;
  // each entry of acc is zeroed, summed and written by the same thread
  for (long q = tid; q < P; q += nt) acc[q] = 0.0f;
  __syncthreads();

  const long row0 = (long)blockIdx.x * nt;
  const int R = (long)B - row0 < nt ? (int)((long)B - row0) : nt;  // ragged last block
  const int R4 = (R + 3) & ~3;
  const bool active = tid < R;
  const long row = row0 + tid;
  const cnf::RowCols my = c.at(tid);
  const int ys_off = nz + (t_col >= 0 ? 1 : 0);
  const float t0 = *t0p, dt = *dtp;
  const float half = 0.5f * dt;
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
    cnf::row_keep_u2<H, BF16>(w, d, my);
  }

  for (int n = steps - 1; n >= 0; --n) {
    const float t = t0 + (float)n * dt;
    float ct[3];  // divbar, rzbar, rjbar of the stage being taken back
    if (active) {
      // k1..k3 again: the stage inputs v1 = u + dt/2 k1, v2 = u + dt/2 k2, v3 = u + dt k3
      for (int k = 0; k < nz; ++k) {
        const float u = traj[((long)n * nz + k) * B + row];
        UZ[k] = u;
        X[k] = u;
      }
#pragma unroll 1
      for (int st = 0; st < 3; ++st) {
        if (t_col >= 0) X[t_col] = st == 0 ? t : t + half;
        float dv, ry, re;
        cnf::row_stage<H, BF16>(w, d, X, EPS, Y, nullptr, dv, ry, re);
        const float step = st == 2 ? dt : half;
        float* vst = st == 0 ? V1 : st == 1 ? V2 : V3;
        for (int k = 0; k < nz; ++k) {
          const float v = UZ[k] + step * Y[k];
          vst[k] = v;
          X[k] = v;
        }
      }
      // stage 4 at (t + dt, v3), with k4b = dt/6 a
      for (int k = 0; k < nz; ++k) my.X[k * ld] = V3[k];
      if (t_col >= 0) my.X[t_col * ld] = t + dt;
      for (int k = 0; k < sd; ++k) {
        AN[k] = A[k];
        cnf::set_row_cotangent(my, k, nz, (dt / 6.0f) * A[k], ct);
      }
    }

    // stage 4 at (t + dt, v3), then 3 at (t + dt/2, v2), 2 at (t + dt/2, v1), 1 at (t, u);
    // rolled, as the recompute above: one copy of the stage code stays in the
    // instruction cache
#pragma unroll 1
    for (int st = 3; st >= 0; --st) {
      if (active) {
        float dv, ry, re;
        cnf::row_stage_keep<H, BF16>(w, d, my, Y, E, dv, ry, re);
        cnf::row_stage_bwd<H, BF16>(w, d, my, Y, E, ry, re, ct[0], ct[1], ct[2], nz, XB, EPSB);
        for (int k = 0; k < nz; ++k) AN[k] = AN[k] + XB[k];  // a_new += vb = xbar[:nz]
      }
      __syncthreads();
      cnf::row_accumulate_wgrads<H, BF16>(d, c, R4, acc);
      __syncthreads();
      if (active && st > 0) {
        // the cotangent and input of the stage before it (k3b, k2b, k1b)
        const float ca = st == 1 ? dt / 6.0f : dt / 3.0f;  // a's weight in it
        const float cv = st == 3 ? dt : half;              // vb's weight in it
        const float* vnext = st == 3 ? V2 : st == 2 ? V1 : UZ;
        for (int k = 0; k < sd; ++k) {
          if (k < nz) {
            cnf::set_row_cotangent(my, k, nz, ca * A[k] + cv * XB[k], ct);
            my.X[k * ld] = vnext[k];
          } else {
            cnf::set_row_cotangent(my, k, nz, ca * A[k], ct);  // vb is 0 past the z columns
          }
        }
        if (st == 1 && t_col >= 0) my.X[t_col * ld] = t;
        else if (st == 3 && t_col >= 0) my.X[t_col * ld] = t + half;
      }
    }
    if (active)
      for (int k = 0; k < sd; ++k) A[k] = AN[k];
  }

  if (active) {
    for (int k = 0; k < sd; ++k) u0bar[row * sd + k] = A[k];
    for (int k = 0; k < nz; ++k) epsbar[row * nz + k] = EPSB[k];
  }
  for (long q = tid; q < P; q += nt) partial[(long)blockIdx.x * P + q] = acc[q];
}

template <int H, bool BF16>
cudaError_t launch_rows(const float* u0, const float* eps, const float* ys, const cnf::Weights& w,
                        const cnf::Dims& d, int grid, int smem_bytes, const float* t0,
                        const float* dt, const float* gbar, float* u0bar, float* epsbar,
                        float* traj, float* partial, float* grads, int B, int sd, int nc,
                        int t_col, int steps, cudaStream_t stream) {
  const int traj_smem = (int)(4 * (cnf::row_weight_floats(d, H) +
                                   (long)cnf::kTrajThreads * cnf::odd(d.n_in + d.n_out + 3 * d.nz)));
  cudaError_t err = cudaFuncSetAttribute(solve_traj_rows<H, BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, traj_smem);
  if (err != cudaSuccess) return err;
  solve_traj_rows<H, BF16><<<(B + cnf::kTrajThreads - 1) / cnf::kTrajThreads, cnf::kTrajThreads,
                             traj_smem, stream>>>(u0, eps, ys, w, d, t0, dt, traj, B, sd, nc,
                                                  t_col, steps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fused_solve_rk4_bwd_rows<H, BF16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  fused_solve_rk4_bwd_rows<H, BF16><<<grid, cnf::kRowBwdThreads, smem_bytes, stream>>>(
      eps, ys, w, d, t0, dt, gbar, traj, u0bar, epsbar, partial, B, sd, nc, t_col, steps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return cnf::launch_reduce(partial, grid, cnf::param_count(d), grads, stream);
}

// ---- plan and dispatch ----

// K4's launch shape for these widths and batch: the row path (H > 0;
// pl.rows threads a block, one row each, the weights staged), the wide path
// (wide; pl.rows the rows of a bf16 output tile, grid the slices of the
// batch in its weight-gradient products when more than one, the larger of
// the two precisions' counts) or the tiled path (H ==
// 0; pl.rows rows a tile, 0 when one row does not fit).  The launch and
// cnf_solve_bwd_plan both read it, so grid is the row count of the caller's
// partial-sum buffer.
struct SolveBwdShape {
  int H;
  int grid;
  cnf::BwdPlan pl;
  bool wide;
};

SolveBwdShape solve_bwd_shape(const cnf::Dims& d, int sd, int B) {
  const cnf::RowBwdPlan rp = cnf::row_bwd_plan(d, solve_row_ld(d, sd));
  if (rp.H)
    return SolveBwdShape{rp.H, (B + cnf::kRowBwdThreads - 1) / cnf::kRowBwdThreads,
                         cnf::BwdPlan{true, false, cnf::kRowBwdThreads, rp.smem_bytes,
                                      cnf::param_count(d)},
                         false};
  if (d.h >= cnf::wide::kSolveWideMinH) {
    const int slices = cnf::wide::wgrad_rows(d, B);
    return SolveBwdShape{0, slices > 1 ? slices : 0,
                         cnf::BwdPlan{false, false, cnf::wide::kBM, 0, cnf::param_count(d)},
                         true};
  }
  const cnf::BwdPlan pl = cnf::make_bwd_plan(d, cnf::solve_bwd_extra(sd, d.nz));
  return SolveBwdShape{0, pl.rows ? cnf::bwd_grid(B, pl.rows) : 0, pl, false};
}

template <bool BF16>
cudaError_t launch(const float* u0, const float* eps, const float* ys, const cnf::Weights& w,
                   const cnf::Dims& d, const float* t0, const float* dt, const float* gbar,
                   float* u0bar, float* epsbar, float* traj, float* partial, float* scratch,
                   float* grads, int B, int sd, int nc, int t_col, int steps,
                   cudaStream_t stream) {
  const SolveBwdShape shape = solve_bwd_shape(d, sd, B);
  const cnf::BwdPlan& pl = shape.pl;
  if (shape.wide)
    return cnf::wide::solve_bwd<BF16>(u0, eps, ys, w, d, t0, dt, gbar, u0bar, epsbar, traj,
                                      partial, scratch, grads, B, nc, t_col, steps, stream);
  if (shape.H) {
    auto rows = launch_rows<32, BF16>;
    if (shape.H == 8) rows = launch_rows<8, BF16>;
    if (shape.H == 16) rows = launch_rows<16, BF16>;
    if (shape.H == 24) rows = launch_rows<24, BF16>;
    return rows(u0, eps, ys, w, d, shape.grid, pl.smem_bytes, t0, dt, gbar, u0bar, epsbar, traj,
                partial, grads, B, sd, nc, t_col, steps, stream);
  }
  if (pl.rows == 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fused_solve_rk4_bwd_kernel<BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         pl.smem_bytes);
  if (err != cudaSuccess) return err;
  fused_solve_rk4_bwd_kernel<BF16><<<shape.grid, cnf::kThreads, pl.smem_bytes, stream>>>(
      u0, eps, ys, w, d, pl.staged, pl.acc_smem, t0, dt, gbar, u0bar, epsbar, traj, partial, B,
      sd, nc, t_col, steps, pl.rows, pl.P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return cnf::launch_reduce(partial, shape.grid, pl.P, grads, stream);
}

}  // namespace

// K4's launch plan for these widths and batch (sd: the state width): returns
// rows per tile (the row path: threads a block, one row each; the wide path:
// rows of an output tile; 0: the widths do not fit) and sets info[0] =
// weights staged in shared memory, info[1] = grid (rows of the partial-sum
// buffer, 0: none), info[2] = P, the parameter count, info[3] = H of the row
// path (0: another path), info[4] = the wide path's scratch floats at this
// batch (0: another path; a scratch past 2^31 floats does not fit).
extern "C" int cnf_solve_bwd_plan(int n_in, int h, int n_out, int nz, int sd, int B, int* info) {
  const cnf::Dims d{n_in, h, n_out, nz};
  const SolveBwdShape shape = solve_bwd_shape(d, sd, B);
  const long scratch = shape.wide ? cnf::wide::solve_bwd_scratch_floats(d, B) : 0;
  info[0] = shape.pl.staged ? 1 : 0;
  info[1] = shape.grid;
  info[2] = (int)shape.pl.P;
  info[3] = shape.H;
  info[4] = scratch > INT_MAX ? 0 : (int)scratch;
  return scratch > INT_MAX ? 0 : shape.pl.rows;
}

// Weights as for cnf_fused_solve_rk4_fwd; W*t are read only by the tiled
// path when it does not stage the weights (cnf_solve_bwd_plan's info[0] ==
// 0 and info[4] == 0).  gbar: the cotangent of u1 (B, sd).  traj: scratch of
// steps x B x nz floats; partial: grid x P floats and scratch info[4]
// (cnf_solve_bwd_plan); grads receives the P weight gradients in the layout
// of cnf_fused_dynamics_bwd.
extern "C" int cnf_fused_solve_rk4_bwd(const float* u0, const float* eps, const float* ys,
                                       const float* A1, const float* b1, const float* A2,
                                       const float* b2, const float* A3, const float* b3,
                                       const float* W1t, const float* W2t, const float* W3t,
                                       const float* t0, const float* dt, const float* gbar,
                                       float* u0bar, float* epsbar, float* traj, float* partial,
                                       float* scratch, float* grads, int B, int sd, int n_in,
                                       int h, int n_out, int nz, int nc, int t_col, int steps,
                                       int bf16, void* stream) {
  if (B <= 0) return cudaSuccess;
  const cnf::Weights w{W1t, W2t, W3t, A1, A2, A3, b1, b2, b3};
  const cnf::Dims d{n_in, h, n_out, nz};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<true>(u0, eps, ys, w, d, t0, dt, gbar, u0bar, epsbar, traj, partial,
                             scratch, grads, B, sd, nc, t_col, steps, st)
              : launch<false>(u0, eps, ys, w, d, t0, dt, gbar, u0bar, epsbar, traj, partial,
                              scratch, grads, B, sd, nc, t_col, steps, st);
}
