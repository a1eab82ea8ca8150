// K4 on Hopper: the exact discrete backward of the whole fixed-step RK4
// solve (K3) -- cotangents of u1 with respect to u0, eps and the six weights.
//
// Replaces continuousnormalizingflows_tpu/ops/pallas_solve.py
// _solve_bwd_kernel (custom-VJP rule _fused_solve_bwd).  Per tile of rows:
//   1. recompute the step trajectory u_0 .. u_{steps-1} (z columns only: the
//      accumulator columns never enter a stage) into a device scratch buffer
//      of steps x B x nz floats.  The TPU kept it in VMEM; a block's shared
//      memory cannot hold 32 steps of a 100-row tile next to the stage
//      buffers, and the buffer is written and read once per step;
//   2. walk the steps backward.  For step n, recompute k1..k3 to get the
//      stage inputs v1, v2, v3, then take the four stage VJPs in reverse
//      (stage_bwd.cuh), each after recomputing its stage with every
//      intermediate kept, through the RK4 chain rule:
//        k4b = dt/6 a;             v3b = vjp(t + dt,   v3; k4b)
//        k3b = dt/3 a + dt v3b;    v2b = vjp(t + dt/2, v2; k3b)
//        k2b = dt/3 a + dt/2 v2b;  v1b = vjp(t + dt/2, v1; k2b)
//        k1b = dt/6 a + dt/2 v1b;  u0b = vjp(t,        u;  k1b)
//        a <- a + v3b + v2b + v1b + u0b
//      epsbar and the weight gradients accumulate over stages, steps and
//      tiles; the weight gradients go into the block's own row of a
//      (grid, P) buffer of partial sums, reduced in a fixed order by a second
//      kernel (stage_bwd.cuh), so the gradients are the same bits on every
//      run.
// The cotangent of the conditions ys is not computed (the JAX kernel returns
// zeros for it too), nor that of t0 and t1.
//
// What bounds it on an H100: per step it runs 7 stage forwards and 4 stage
// backwards (~5x the products of a K3 step) against 2 x nz floats of
// trajectory traffic per row, so FMA and shared-memory issue inside the SM,
// as for K3.  This first version takes the tiled path of stage.cuh at every
// width: simple and right first.
//
// C interface for ctypes: returns a cudaError_t (0 on success).

#include "stage_bwd.cuh"

namespace {

// The cotangent dub of column c of the stage output du = [y, -div, |y|, |e_z|]
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
        set_cotangent(b, r, c, nz, (dt / 6.0f) * a);
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
              set_cotangent(b, r, c, nz, ca * a + cv * vb);
              s.X[r * ldx + c] = vnext[r * ldz + c];
            }
          } else if (st > 0) {
            set_cotangent(b, r, c, nz, ca * a);  // vb is 0 past the z columns
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

template <bool BF16>
cudaError_t launch(const float* u0, const float* eps, const float* ys, const cnf::Weights& w,
                   const cnf::Dims& d, const float* t0, const float* dt, const float* gbar,
                   float* u0bar, float* epsbar, float* traj, float* partial, float* grads, int B,
                   int sd, int nc, int t_col, int steps, cudaStream_t stream) {
  const cnf::BwdPlan pl = cnf::make_bwd_plan(d, cnf::solve_bwd_extra(sd, d.nz));
  if (pl.rows == 0) return cudaErrorInvalidValue;
  const int grid = cnf::bwd_grid(B, pl.rows);
  cudaError_t err = cudaFuncSetAttribute(fused_solve_rk4_bwd_kernel<BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         pl.smem_bytes);
  if (err != cudaSuccess) return err;
  fused_solve_rk4_bwd_kernel<BF16><<<grid, cnf::kThreads, pl.smem_bytes, stream>>>(
      u0, eps, ys, w, d, pl.staged, pl.acc_smem, t0, dt, gbar, u0bar, epsbar, traj, partial, B,
      sd, nc, t_col, steps, pl.rows, pl.P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return cnf::launch_reduce(partial, grid, pl.P, grads, stream);
}

}  // namespace

// Weights as for cnf_fused_solve_rk4_fwd; W*t are read only when the backward
// plan does not stage the weights (cnf_bwd_plan with sd > 0).  gbar: the
// cotangent of u1 (B, sd).  traj: scratch of steps x B x nz floats; partial:
// grid x P floats (cnf_bwd_plan); grads receives the P weight gradients in
// the layout of cnf_fused_dynamics_bwd.
extern "C" int cnf_fused_solve_rk4_bwd(const float* u0, const float* eps, const float* ys,
                                       const float* A1, const float* b1, const float* A2,
                                       const float* b2, const float* A3, const float* b3,
                                       const float* W1t, const float* W2t, const float* W3t,
                                       const float* t0, const float* dt, const float* gbar,
                                       float* u0bar, float* epsbar, float* traj, float* partial,
                                       float* grads, int B, int sd, int n_in, int h, int n_out,
                                       int nz, int nc, int t_col, int steps, int bf16,
                                       void* stream) {
  if (B <= 0) return cudaSuccess;
  const cnf::Weights w{W1t, W2t, W3t, A1, A2, A3, b1, b2, b3};
  const cnf::Dims d{n_in, h, n_out, nz};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<true>(u0, eps, ys, w, d, t0, dt, gbar, u0bar, epsbar, traj, partial,
                             grads, B, sd, nc, t_col, steps, st)
              : launch<false>(u0, eps, ys, w, d, t0, dt, gbar, u0bar, epsbar, traj, partial,
                              grads, B, sd, nc, t_col, steps, st);
}
