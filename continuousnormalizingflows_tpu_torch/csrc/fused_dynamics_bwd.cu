// K2 on Hopper: the backward of one fused dynamics stage (K1) -- cotangents
// of (y, e_z, div, |y|, |e_z|) with respect to x, eps and the six weights.
//
// Replaces continuousnormalizingflows_tpu/ops/pallas_kernels.py _bwd_kernel
// (custom-VJP rule _fused_bwd).  Each block takes tiles of rows in turn
// (tiles b, b + grid, ...): it loads x, eps and the five cotangents of its
// tile, recomputes the stage's forward with every intermediate kept in
// shared memory (stage_bwd.cuh stage_fwd_keep), runs the hand-derived
// backward chain with its second-order gate terms (stage_bwd), writes xbar
// and epsbar, and adds the tile's weight-gradient terms to its own row of a
// (grid, P) buffer of partial sums.  A second kernel adds those rows in a
// fixed order, so the gradients are the same bits on every run.
//
// What bounds it on an H100: per row the backward is ~3x the forward's
// products (recompute, the six backward products, the six outer products of
// the weight gradients) against ~100 bytes of device traffic, so, like K1,
// FMA and shared-memory issue inside the SM.  This first version takes the
// tiled path of stage.cuh at every width (no row-per-thread path): simple
// and right first.
//
// C interface for ctypes: returns a cudaError_t (0 on success).

#include "stage_bwd.cuh"

namespace {

template <bool BF16>
__global__ void __launch_bounds__(cnf::kThreads)
fused_dynamics_bwd_kernel(const float* __restrict__ x, const float* __restrict__ eps,
                          cnf::Weights gw, cnf::Dims d, bool staged, bool acc_smem,
                          const float* __restrict__ ybar, const float* __restrict__ ezbar,
                          const float* __restrict__ divbar, const float* __restrict__ rzbar,
                          const float* __restrict__ rjbar, float* __restrict__ xbar,
                          float* __restrict__ epsbar, float* __restrict__ partial, int B,
                          int rows, long P) {
  extern __shared__ __align__(16) float smem[];
  float* p = smem;
  const cnf::Weights w = cnf::stage_weights(gw, d, staged, p);
  float* acc = partial + (long)blockIdx.x * P;
  if (acc_smem) {
    acc = p;
    p += P;
  }
  cnf::BwdBufs b;
  cnf::carve_bwd(p, rows, d, b);
  const cnf::StageBufs& s = b.f;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n_in = d.n_in, n_out = d.n_out, nz = d.nz;
  // each entry of acc is zeroed, summed and written by the same thread
  for (long q = tid; q < P; q += nt) acc[q] = 0.0f;

  for (long row0 = (long)blockIdx.x * rows; row0 < B; row0 += (long)gridDim.x * rows) {
    const int R = (long)B - row0 < rows ? (int)((long)B - row0) : rows;  // ragged last tile
    for (int idx = tid; idx < R * n_in; idx += nt) {
      const int r = idx / n_in, c = idx - r * n_in;
      s.X[r * s.ldx + c] = x[row0 * n_in + idx];
    }
    for (int idx = tid; idx < R * nz; idx += nt) {
      const int r = idx / nz, c = idx - r * nz;
      s.EPS[r * s.ldz + c] = eps[row0 * nz + idx];
      b.EB[r * s.ldz + c] = ezbar[row0 * nz + idx];
    }
    for (int idx = tid; idx < R * n_out; idx += nt) {
      const int r = idx / n_out, c = idx - r * n_out;
      b.YB[r * s.ldy + c] = ybar[row0 * n_out + idx];
    }
    for (int r = tid; r < R; r += nt) {
      b.CT[r * 3 + 0] = divbar[row0 + r];
      b.CT[r * 3 + 1] = rzbar[row0 + r];
      b.CT[r * 3 + 2] = rjbar[row0 + r];
    }
    __syncthreads();

    cnf::stage_fwd_keep<BF16>(d, w, b, R);
    cnf::stage_bwd<BF16>(d, w, b, R, n_in, acc);

    for (int idx = tid; idx < R * n_in; idx += nt) {
      const int r = idx / n_in, c = idx - r * n_in;
      xbar[row0 * n_in + idx] = b.XB[r * s.ldx + c];
    }
    for (int idx = tid; idx < R * nz; idx += nt) {
      const int r = idx / nz, c = idx - r * nz;
      epsbar[row0 * nz + idx] = b.EPB[r * s.ldz + c];
    }
    __syncthreads();  // the next tile overwrites the buffers
  }
  if (acc_smem)
    for (long q = tid; q < P; q += nt) partial[(long)blockIdx.x * P + q] = acc[q];
}

template <bool BF16>
cudaError_t launch(const float* x, const float* eps, const cnf::Weights& w, const cnf::Dims& d,
                   const float* ybar, const float* ezbar, const float* divbar,
                   const float* rzbar, const float* rjbar, float* xbar, float* epsbar,
                   float* partial, float* grads, int B, cudaStream_t stream) {
  const cnf::BwdPlan pl = cnf::make_bwd_plan(d, 0);
  if (pl.rows == 0) return cudaErrorInvalidValue;
  const int grid = cnf::bwd_grid(B, pl.rows);
  cudaError_t err = cudaFuncSetAttribute(fused_dynamics_bwd_kernel<BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         pl.smem_bytes);
  if (err != cudaSuccess) return err;
  fused_dynamics_bwd_kernel<BF16><<<grid, cnf::kThreads, pl.smem_bytes, stream>>>(
      x, eps, w, d, pl.staged, pl.acc_smem, ybar, ezbar, divbar, rzbar, rjbar, xbar, epsbar,
      partial, B, pl.rows, pl.P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return cnf::launch_reduce(partial, grid, pl.P, grads, stream);
}

}  // namespace

// Weights as for cnf_fused_dynamics_fwd; W*t are read only when the backward
// plan does not stage the weights (cnf_bwd_plan's info[0] == 0).  partial
// holds grid x P floats (cnf_bwd_plan); grads receives the P weight
// gradients in nn.Linear layout: A1 (h, n_in), b1, A2 (h, h), b2,
// A3 (n_out, h), b3, one after the other.
extern "C" int cnf_fused_dynamics_bwd(const float* x, const float* eps, const float* A1,
                                      const float* b1, const float* A2, const float* b2,
                                      const float* A3, const float* b3, const float* W1t,
                                      const float* W2t, const float* W3t, const float* ybar,
                                      const float* ezbar, const float* divbar,
                                      const float* rzbar, const float* rjbar, float* xbar,
                                      float* epsbar, float* partial, float* grads, int B,
                                      int n_in, int h, int n_out, int nz, int bf16,
                                      void* stream) {
  if (B <= 0) return cudaSuccess;
  const cnf::Weights w{W1t, W2t, W3t, A1, A2, A3, b1, b2, b3};
  const cnf::Dims d{n_in, h, n_out, nz};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<true>(x, eps, w, d, ybar, ezbar, divbar, rzbar, rjbar, xbar, epsbar,
                             partial, grads, B, st)
              : launch<false>(x, eps, w, d, ybar, ezbar, divbar, rzbar, rjbar, xbar, epsbar,
                              partial, grads, B, st);
}

// This kernel's launch plan for these widths and batch (the whole-solve
// backward's is cnf_solve_bwd_plan): returns rows per tile and sets info[0] =
// weights staged in shared memory, info[1] = grid (rows of the partial-sum
// buffer), info[2] = P, the parameter count.
extern "C" int cnf_bwd_plan(int n_in, int h, int n_out, int nz, int B, int* info) {
  const cnf::Dims d{n_in, h, n_out, nz};
  const cnf::BwdPlan pl = cnf::make_bwd_plan(d, 0);
  info[0] = pl.staged ? 1 : 0;
  info[1] = pl.rows ? cnf::bwd_grid(B, pl.rows) : 0;
  info[2] = (int)pl.P;
  return pl.rows;
}
