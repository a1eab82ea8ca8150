// K3 on Hopper: the whole fixed-step RK4 solve of the augmented CNF state in
// one call.
//
// Replaces continuousnormalizingflows_tpu/ops/pallas_solve.py
// _solve_fwd_kernel (public fused_solve_rk4).  Three paths, chosen from the
// widths (solve_shape): one row per thread for h <= 32
// (fused_solve_rk4_rows), one tile of rows per block with register-tiled
// products up to kSolveWideMinH (fused_solve_rk4_kernel; row_stage.cuh
// `choose` picks between these two), and from there the wide path
// (wide_solve.cuh): the solve as a chain of dense products over the whole
// batch, on the tensor cores in bf16, issued from this call.  The row and
// tiled paths are one launch each and keep everything of the solve but u0,
// eps, ys and u1 on the SM.
//
// State per row: u = [z (nz), dlogp, E, n] (state_dim = nz + 3).  Each stage
// evaluates the dynamics of stage.cuh on the net input
// x = [z, t (non-autonomous), ys] and assembles du = [y, -div, |y|, |e_z|].
//
// What bounds it on an H100: a 32-step solve at the flagship width is 128
// stages of ~3.4 kFLOP per row against 4 x 32 bytes of HBM traffic per row
// for the whole solve, so it is bound by FMA issue and shared-memory traffic
// inside the block.  The row and tiled designs run each row's whole steps x
// 4-stage loop inside one block and keep u, the RK4 accumulator, every stage
// intermediate and (when they fit) the weights in shared memory for the
// whole solve; the stage input x is formed directly from u + c*dt*k, so no
// separate stage state is stored.  t0 and dt come from device memory, so a
// steered end time needs no host synchronisation.
//
// C interface for ctypes: returns a cudaError_t (0 on success).

#include <climits>

#include "row_stage.cuh"
#include "wide_solve.cuh"

namespace {

// du[c] of the stage just run, for state column c of row r
__device__ __forceinline__ float stage_du(const cnf::StageBufs& s, int r, int c, int nz) {
  if (c < nz) return s.Y[r * s.ldy + c];
  if (c == nz) return -s.ST[r * 3 + 0];
  return s.ST[r * 3 + (c - nz)];  // nz + 1 -> |y|, nz + 2 -> |e_z|
}

template <bool BF16>
__global__ void __launch_bounds__(cnf::kThreads)
fused_solve_rk4_kernel(const float* __restrict__ u0, const float* __restrict__ eps,
                       const float* __restrict__ ys, cnf::Weights gw, cnf::Dims d, bool staged,
                       const float* __restrict__ t0p, const float* __restrict__ dtp,
                       float* __restrict__ u1, int B, int sd, int nc, int t_col, int steps,
                       int rows) {
  extern __shared__ __align__(16) float smem[];
  float* p = smem;
  const cnf::Weights w = cnf::stage_weights(gw, d, staged, p);
  cnf::StageBufs s;
  p = cnf::carve_stage(p, rows, d, s);
  float* U = p;
  p += rows * sd;
  float* ACC = p;

  const long row0 = (long)blockIdx.x * rows;
  const int R = (long)B - row0 < rows ? (int)((long)B - row0) : rows;  // ragged last tile
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nz = d.nz, ldx = s.ldx;
  const int ys_off = nz + (t_col >= 0 ? 1 : 0);
  const float t0 = *t0p, dt = *dtp;
  const float half = 0.5f * dt;

  for (int idx = tid; idx < R * sd; idx += nt) U[idx] = u0[row0 * sd + idx];
  for (int idx = tid; idx < R * nz; idx += nt) {
    const int r = idx / nz, c = idx - r * nz;
    s.EPS[r * s.ldz + c] = eps[row0 * nz + idx];
  }
  for (int idx = tid; idx < R * nc; idx += nt) {
    const int r = idx / nc, j = idx - r * nc;
    s.X[r * ldx + ys_off + j] = ys[row0 * nc + idx];
  }
  __syncthreads();

  for (int i = 0; i < steps; ++i) {
    const float t = t0 + (float)i * dt;
    // k1 at (t, u)
    for (int idx = tid; idx < R * sd; idx += nt) {
      const int r = idx / sd, c = idx - r * sd;
      if (c < nz) s.X[r * ldx + c] = U[idx];
      else if (c == nz && t_col >= 0) s.X[r * ldx + t_col] = t;
    }
    __syncthreads();
    cnf::stage_fwd<BF16>(d, w, s, R);
    // k2 at (t + dt/2, u + dt/2 k1)
    for (int idx = tid; idx < R * sd; idx += nt) {
      const int r = idx / sd, c = idx - r * sd;
      const float k = stage_du(s, r, c, nz);
      ACC[idx] = k;
      if (c < nz) s.X[r * ldx + c] = U[idx] + half * k;
      else if (c == nz && t_col >= 0) s.X[r * ldx + t_col] = t + half;
    }
    __syncthreads();
    cnf::stage_fwd<BF16>(d, w, s, R);
    // k3 at (t + dt/2, u + dt/2 k2)
    for (int idx = tid; idx < R * sd; idx += nt) {
      const int r = idx / sd, c = idx - r * sd;
      const float k = stage_du(s, r, c, nz);
      ACC[idx] = ACC[idx] + 2.0f * k;
      if (c < nz) s.X[r * ldx + c] = U[idx] + half * k;
    }
    __syncthreads();
    cnf::stage_fwd<BF16>(d, w, s, R);
    // k4 at (t + dt, u + dt k3)
    for (int idx = tid; idx < R * sd; idx += nt) {
      const int r = idx / sd, c = idx - r * sd;
      const float k = stage_du(s, r, c, nz);
      ACC[idx] = ACC[idx] + 2.0f * k;
      if (c < nz) s.X[r * ldx + c] = U[idx] + dt * k;
      else if (c == nz && t_col >= 0) s.X[r * ldx + t_col] = t + dt;
    }
    __syncthreads();
    cnf::stage_fwd<BF16>(d, w, s, R);
    // u <- u + dt/6 (k1 + 2 k2 + 2 k3 + k4)
    for (int idx = tid; idx < R * sd; idx += nt) {
      const int r = idx / sd, c = idx - r * sd;
      U[idx] = U[idx] + (dt / 6.0f) * (ACC[idx] + stage_du(s, r, c, nz));
    }
    __syncthreads();
  }

  for (int idx = tid; idx < R * sd; idx += nt) u1[row0 * sd + idx] = U[idx];
}

// The row path: one row per thread, its state [U | ACC | X | Y | EPS] in a
// shared-memory row of its own (odd stride: no bank conflicts), the stage's
// activations in registers (row_stage.cuh).  No block synchronisation after
// the weights are staged.
template <int H, bool BF16>
__global__ void __launch_bounds__(cnf::kThreads)
fused_solve_rk4_rows(const float* __restrict__ u0, const float* __restrict__ eps,
                     const float* __restrict__ ys, cnf::Weights gw, cnf::Dims d,
                     const float* __restrict__ t0p, const float* __restrict__ dtp,
                     float* __restrict__ u1, int B, int sd, int nc, int t_col, int steps) {
  extern __shared__ __align__(16) float smem[];
  const cnf::RowWeights w = cnf::stage_row_weights<H, BF16>(gw, d, smem);
  const int ld = cnf::odd(2 * sd + d.n_in + d.n_out + d.nz);
  float* U = smem + cnf::row_weight_floats(d, H) + threadIdx.x * ld;
  float* ACC = U + sd;
  float* X = ACC + sd;
  float* Y = X + d.n_in;
  float* EPS = Y + d.n_out;
  __syncthreads();
  const long row = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;

  const int nz = d.nz;
  const int ys_off = nz + (t_col >= 0 ? 1 : 0);
  const float t0 = *t0p, dt = *dtp;
  for (int c = 0; c < sd; ++c) U[c] = u0[row * sd + c];
  for (int c = 0; c < nz; ++c) EPS[c] = eps[row * nz + c];
  for (int j = 0; j < nc; ++j) X[ys_off + j] = ys[row * nc + j];

  for (int i = 0; i < steps; ++i)
    cnf::row_rk4_step<H, BF16>(w, d, X, EPS, Y, U, ACC, sd, t_col, t0 + (float)i * dt, dt);
  for (int c = 0; c < sd; ++c) u1[row * sd + c] = U[c];
}

// K3's launch shape: cnf::choose's row or tiled path, or the wide path.
struct SolveShape {
  cnf::Choice c;
  bool wide;
};

SolveShape solve_shape(const cnf::Dims& d, int sd) {
  return SolveShape{cnf::choose(d, sd), d.h >= cnf::wide::kSolveWideMinH};
}

template <bool BF16>
cudaError_t launch(const float* u0, const float* eps, const float* ys, const cnf::Weights& w,
                   const cnf::Dims& d, const float* t0, const float* dt, float* u1,
                   float* scratch, int B, int sd, int nc, int t_col, int steps,
                   cudaStream_t stream) {
  const SolveShape shape = solve_shape(d, sd);
  if (shape.wide)
    return cnf::wide::solve_fwd<BF16>(u0, eps, ys, w, d, t0, dt, u1, scratch, B, nc, t_col,
                                      steps, stream);
  const cnf::Choice& c = shape.c;
  if (c.rows == 0) return cudaErrorInvalidValue;
  const int grid = (B + c.rows - 1) / c.rows;
  if (c.H == 0) {
    cudaError_t err = cudaFuncSetAttribute(fused_solve_rk4_kernel<BF16>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           c.smem_bytes);
    if (err != cudaSuccess) return err;
    fused_solve_rk4_kernel<BF16><<<grid, cnf::kThreads, c.smem_bytes, stream>>>(
        u0, eps, ys, w, d, c.staged, t0, dt, u1, B, sd, nc, t_col, steps, c.rows);
    return cudaGetLastError();
  }
  // H = 4, 8, ..., 32 (row_fwd_H)
  decltype(&fused_solve_rk4_rows<4, BF16>) const kernels[] = {
      fused_solve_rk4_rows<4, BF16>,  fused_solve_rk4_rows<8, BF16>,
      fused_solve_rk4_rows<12, BF16>, fused_solve_rk4_rows<16, BF16>,
      fused_solve_rk4_rows<20, BF16>, fused_solve_rk4_rows<24, BF16>,
      fused_solve_rk4_rows<28, BF16>, fused_solve_rk4_rows<32, BF16>};
  const auto kernel = kernels[c.H / 4 - 1];
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         c.smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, c.rows, c.smem_bytes, stream>>>(u0, eps, ys, w, d, t0, dt, u1, B, sd, nc,
                                                  t_col, steps);
  return cudaGetLastError();
}

}  // namespace

// The launch shape of K3 for these widths and batch (sd: the state width),
// and of K1 short of its wide path (sd = 0; K1's own plan is cnf_fwd_plan):
// returns rows a block (the row path: threads a block, one row each; the
// wide path: rows of an output tile) and sets info[0] = weights staged in
// shared memory, info[1] = H of the row path (row_fwd_H; 0: another path),
// info[2] = the wide path's scratch floats at this batch (0: another path;
// a scratch past 2^31 floats does not fit).
extern "C" int cnf_plan(int n_in, int h, int n_out, int nz, int sd, int B, int* info) {
  const cnf::Dims d{n_in, h, n_out, nz};
  const SolveShape shape = solve_shape(d, sd);
  const bool wide = sd > 0 && shape.wide;
  const long scratch = wide ? cnf::wide::solve_fwd_scratch_floats(d, B) : 0;
  info[0] = wide || !shape.c.staged ? 0 : 1;
  info[1] = wide ? 0 : shape.c.H;
  info[2] = scratch > INT_MAX ? 0 : (int)scratch;
  if (scratch > INT_MAX) return 0;
  return wide ? cnf::wide::kBM : shape.c.rows;
}

// Weights: A* in nn.Linear layout (out, in), W*t their transposes (in, out),
// all contiguous float32; W*t may be null when the weights are staged or the
// wide path runs (cnf_plan's info[0] == 0 and info[2] > 0).  t0 and dt are
// device scalars; ys may be null.  scratch: info[2] floats (the wide path's,
// else unread).
extern "C" int cnf_fused_solve_rk4_fwd(const float* u0, const float* eps, const float* ys,
                                       const float* A1, const float* b1, const float* A2,
                                       const float* b2, const float* A3, const float* b3,
                                       const float* W1t, const float* W2t, const float* W3t,
                                       const float* t0, const float* dt, float* u1,
                                       float* scratch, int B, int sd, int n_in, int h, int n_out,
                                       int nz, int nc, int t_col, int steps, int bf16,
                                       void* stream) {
  if (B <= 0) return cudaSuccess;
  const cnf::Weights w{W1t, W2t, W3t, A1, A2, A3, b1, b2, b3};
  const cnf::Dims d{n_in, h, n_out, nz};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<true>(u0, eps, ys, w, d, t0, dt, u1, scratch, B, sd, nc, t_col, steps, st)
              : launch<false>(u0, eps, ys, w, d, t0, dt, u1, scratch, B, sd, nc, t_col, steps,
                              st);
}
