// K6 on Hopper: the exact discrete backward of the adaptive solve (K5) --
// cotangents of u1 with respect to u0, eps and the six weights, one block
// per control group of rows.
//
// Replaces continuousnormalizingflows_tpu/ops/pallas_adaptive.py
// _adaptive_bwd_kernel (custom-VJP rule _fused_adaptive_bwd).  Per group:
//   1. replay K5's solve with the same device functions and the same block
//      shape (adaptive.cuh), recording each accepted step's u (z columns) in
//      a device-memory node buffer of max_nodes x B x nz floats, and its t
//      and dt per group.  The TPU kept the nodes in VMEM and capped them at
//      64; device memory holds what max_nodes asks (168 MB at B = 65,536,
//      nz = 5 and 128 nodes);
//   2. walk the accepted steps backward, a tile of rows at a time.  For step
//      n, recompute the stage inputs v_0..v_5 from the node, then take the
//      six stage VJPs in reverse (stage_bwd.cuh), each after recomputing its
//      stage with every intermediate kept, through the dopri5 chain rule
//        kbar_i = dt b_i a + sum_{m > i} dt a_mi vbar_m,   a <- a + sum_i vbar_i.
//      epsbar and the weight gradients accumulate over stages, steps and the
//      group's tiles; the weight gradients go into the group's row of a
//      (groups, P) buffer of partial sums, added in order of group by a
//      second kernel: the same inputs give the same bits.
// A group that accepted more steps than max_nodes, or did not finish,
// NaN-poisons its rows of u0bar and epsbar and its weight-gradient partial
// sums, as the TPU kernel does.  Each group's accepted-step count is written
// out, so a caller can check that the replay took K5's steps.
//
// What bounds it on an H100: per accepted step 5 + 6 stage forwards and 6
// stage backwards on the tiled path of stage.cuh (the walk is never on the
// row path), against 2 x nz floats of node traffic per row: FMA and
// shared-memory issue inside the SM, as for K4.
//
// C interface for ctypes: returns a cudaError_t (0 on success).

#include "adaptive.cuh"

namespace {

using cnf::Ctl;
using cnf::Nodes;
using cnf::Solver;

// The cotangent dub of column c of a stage output du = [y, -div, |y|, |e_z|]
// as the stage backward reads it; ebar = 0 (e_z is not an output of a step).
__device__ __forceinline__ void set_cotangent(const cnf::BwdBufs& b, int r, int c, int nz,
                                              float dub) {
  if (c < nz) {
    b.YB[r * b.f.ldy + c] = dub;
    b.EB[r * b.f.ldz + c] = 0.0f;
  } else if (c == nz) {
    b.CT[r * 3 + 0] = -dub;
  } else {
    b.CT[r * 3 + (c - nz)] = dub;  // nz + 1 -> |y|, nz + 2 -> |e_z|
  }
}

// Phase 2: the walk over the group's `walk` accepted steps, tiles of `rows`
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
        V[r * ldz + c] = nodes.traj[((long)n * B + row0 + r0 + r) * nz + c];
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
          set_cotangent(b, r, c, nz, kbar);
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

// H > 0: the replay on the row path (blockDim.x == g), H == 0: on the tiled
// path (blockDim.x == kThreads), as K5 runs it.  Then the walk.
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
  const float* eps_g = eps + row0 * nz;
  const float* ys_g = ys == nullptr ? ys : ys + row0 * nc;
  int nacc, done;

  // ---- 1. the replay, recording the accepted steps ----
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
    cnf::solve_rows<H>(w, d, row, sd, t_col, *t0p, *t1p, sv, c, red, nodes, r, B);
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
    cnf::solve_tiled(d, w, sb, pl.rows, g, Sg, eps_g, ys_g, sd, nc, t_col, *t0p, *t1p, sv, c,
                     red, nodes, row0, B);
    nacc = c.nacc;
    done = c.done;
  }
  __syncthreads();  // every thread holds the counts: the shared memory is reused

  // ---- 2. the walk ----
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
  walk_back(d, w, p, pl.bwd_rows, g, row0, eps_g, ys_g, gbar + row0 * sd, u0bar + row0 * sd,
            epsbar + row0 * nz, nodes, min(nacc, nodes.max_nodes), acc, sd, nc, t_col, B,
            poison);
  for (long q = threadIdx.x; q < P; q += blockDim.x)
    partial[(long)blockIdx.x * P + q] = ok ? acc[q] : acc[q] * poison;
  if (threadIdx.x == 0) nacc_out[blockIdx.x] = nacc;
}

cudaError_t launch(const float* u0, const float* eps, const float* ys, const cnf::Weights& w,
                   const cnf::Dims& d, const float* t0, const float* t1, const float* gbar,
                   float* u0bar, float* epsbar, float* S, const Nodes& nodes, float* partial,
                   float* grads, int* nacc, int B, int sd, int nc, int t_col, int g,
                   const Solver& s, cudaStream_t stream) {
  const cnf::AdaptivePlan pl = cnf::adaptive_plan(d, sd, g);
  if (pl.smem_fwd == 0 || pl.smem_bwd == 0) return cudaErrorInvalidValue;
  const int grid = B / g;
  const long P = cnf::param_count(d);
  auto kernel = adaptive_bwd<0>;
  if (pl.H == 8) kernel = adaptive_bwd<8>;
  if (pl.H == 16) kernel = adaptive_bwd<16>;
  if (pl.H == 24) kernel = adaptive_bwd<24>;
  if (pl.H == 32) kernel = adaptive_bwd<32>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem_bwd);
  if (err != cudaSuccess) return err;
  const int threads = pl.H > 0 ? g : cnf::kThreads;  // K5's block shape
  kernel<<<grid, threads, pl.smem_bwd, stream>>>(
      u0, eps, ys, w, d, pl, t0, t1, gbar, u0bar, epsbar, S, nodes, partial, nacc, B, sd, nc,
      t_col, g, P, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return cnf::launch_reduce(partial, grid, P, grads, stream);
}

}  // namespace

// Weights as for cnf_fused_adaptive_fwd.  gbar: the cotangent of u1 (B, sd).
// S: scratch of B x 9 x sd floats (the tiled replay); traj: max_nodes x B x
// nz floats; tdt: (B / group) x max_nodes x 2 floats; partial: (B / group) x
// P floats; grads receives the P weight gradients in the layout of
// cnf_fused_dynamics_bwd; nacc: (B / group) ints, each group's accepted
// steps in the replay.
extern "C" int cnf_fused_adaptive_bwd(const float* u0, const float* eps, const float* ys,
                                      const float* A1, const float* b1, const float* A2,
                                      const float* b2, const float* A3, const float* b3,
                                      const float* W1t, const float* W2t, const float* W3t,
                                      const float* t0, const float* t1, const float* gbar,
                                      float* u0bar, float* epsbar, float* S, float* traj,
                                      float* tdt, float* partial, float* grads, int* nacc, int B,
                                      int sd, int n_in, int h, int n_out, int nz, int nc,
                                      int t_col, int group, int max_nodes, int max_steps,
                                      float rtol, float atol, float dt0f, float safety,
                                      float min_f, float max_f, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (group <= 0 || group > cnf::kMaxGroup || B % group != 0 || max_nodes < 1)
    return cudaErrorInvalidValue;
  const cnf::Weights w{W1t, W2t, W3t, A1, A2, A3, b1, b2, b3};
  const cnf::Dims d{n_in, h, n_out, nz};
  const Solver s{rtol, atol, dt0f, safety, min_f, max_f, max_steps};
  return launch(u0, eps, ys, w, d, t0, t1, gbar, u0bar, epsbar, S, Nodes{traj, tdt, max_nodes},
                partial, grads, nacc, B, sd, nc, t_col, group, s,
                static_cast<cudaStream_t>(stream));
}
