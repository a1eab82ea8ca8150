// K1 on Hopper: one dynamics stage, fused -- the MLP forward, the Hutchinson
// probe VJP and the per-row reductions in one launch.
//
// Replaces continuousnormalizingflows_tpu/ops/pallas_kernels.py _fwd_kernel
// (public fused_dynamics_vjp).  Two paths, chosen from the widths
// (row_stage.cuh `choose`):
//   * h <= 32: one row per thread, activations in registers, weights in
//     shared memory (row_stage.cuh);
//   * wider: one block per tile of rows, activations in shared memory,
//     register-tiled products (stage.cuh).
// Either way only y, e_z and the three per-row scalars are written to device
// memory, and the batch needs no divisibility: rows past the end are skipped.
//
// What bounds it on an H100: a flagship row is ~3.3 kFLOP against 96 bytes
// of device memory (x, eps in; y, e_z, 3 scalars out), ~35 FLOP per byte,
// above the fp32 CUDA-core balance of ~20 (67 TFLOP/s over 3.35 TB/s): FMA
// and shared-memory issue, not HBM.  Hence no intermediate leaves the SM, and
// the weights are read from shared memory as broadcasts.  At the tabular
// width (h = 176) a row is ~185 kFLOP and the products dominate more still.
//
// C interface for ctypes: returns a cudaError_t (0 on success).

#include "row_stage.cuh"

namespace {

template <bool BF16>
__global__ void __launch_bounds__(cnf::kThreads)
fused_dynamics_fwd_kernel(const float* __restrict__ x, const float* __restrict__ eps,
                          cnf::Weights gw, cnf::Dims d, bool staged,
                          float* __restrict__ y, float* __restrict__ ez,
                          float* __restrict__ div, float* __restrict__ reg_z,
                          float* __restrict__ reg_j, int B, int rows) {
  extern __shared__ __align__(16) float smem[];
  float* p = smem;
  const cnf::Weights w = cnf::stage_weights(gw, d, staged, p);
  cnf::StageBufs s;
  cnf::carve_stage(p, rows, d, s);
  const long row0 = (long)blockIdx.x * rows;
  const int R = (long)B - row0 < rows ? (int)((long)B - row0) : rows;  // ragged last tile
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int idx = tid; idx < R * d.n_in; idx += nt) {
    const int r = idx / d.n_in, c = idx - r * d.n_in;
    s.X[r * s.ldx + c] = x[row0 * d.n_in + idx];
  }
  for (int idx = tid; idx < R * d.nz; idx += nt) {
    const int r = idx / d.nz, c = idx - r * d.nz;
    s.EPS[r * s.ldz + c] = eps[row0 * d.nz + idx];
  }
  __syncthreads();

  cnf::stage_fwd<BF16>(d, w, s, R);

  for (int idx = tid; idx < R * d.n_out; idx += nt) {
    const int r = idx / d.n_out, c = idx - r * d.n_out;
    y[row0 * d.n_out + idx] = s.Y[r * s.ldy + c];
  }
  for (int idx = tid; idx < R * d.nz; idx += nt) {
    const int r = idx / d.nz, c = idx - r * d.nz;
    ez[row0 * d.nz + idx] = s.E[r * s.ldz + c];
  }
  for (int r = tid; r < R; r += nt) {
    div[row0 + r] = s.ST[r * 3 + 0];
    reg_z[row0 + r] = s.ST[r * 3 + 1];
    reg_j[row0 + r] = s.ST[r * 3 + 2];
  }
}

template <int H, bool BF16>
__global__ void __launch_bounds__(cnf::kThreads)
fused_dynamics_fwd_rows(const float* __restrict__ x, const float* __restrict__ eps,
                        cnf::Weights gw, cnf::Dims d, float* __restrict__ y,
                        float* __restrict__ ez, float* __restrict__ div,
                        float* __restrict__ reg_z, float* __restrict__ reg_j, int B) {
  extern __shared__ __align__(16) float smem[];
  const cnf::RowWeights w = cnf::stage_row_weights<H, BF16>(gw, d, smem);
  __syncthreads();
  const long row = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  float dv, ry, re;
  cnf::row_stage<H, BF16>(w, d, x + row * d.n_in, eps + row * d.nz, y + row * d.n_out,
                          ez + row * d.nz, dv, ry, re);
  div[row] = dv;
  reg_z[row] = ry;
  reg_j[row] = re;
}

template <bool BF16>
cudaError_t launch(const float* x, const float* eps, const cnf::Weights& w, const cnf::Dims& d,
                   float* y, float* ez, float* div, float* reg_z, float* reg_j, int B,
                   cudaStream_t stream) {
  const cnf::Choice c = cnf::choose(d, 0);
  if (c.rows == 0) return cudaErrorInvalidValue;
  const int grid = (B + c.rows - 1) / c.rows;
  if (c.H == 0) {
    cudaError_t err = cudaFuncSetAttribute(fused_dynamics_fwd_kernel<BF16>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           c.smem_bytes);
    if (err != cudaSuccess) return err;
    fused_dynamics_fwd_kernel<BF16><<<grid, cnf::kThreads, c.smem_bytes, stream>>>(
        x, eps, w, d, c.staged, y, ez, div, reg_z, reg_j, B, c.rows);
    return cudaGetLastError();
  }
  // H = 4, 8, ..., 32 (row_fwd_H)
  decltype(&fused_dynamics_fwd_rows<4, BF16>) const kernels[] = {
      fused_dynamics_fwd_rows<4, BF16>,  fused_dynamics_fwd_rows<8, BF16>,
      fused_dynamics_fwd_rows<12, BF16>, fused_dynamics_fwd_rows<16, BF16>,
      fused_dynamics_fwd_rows<20, BF16>, fused_dynamics_fwd_rows<24, BF16>,
      fused_dynamics_fwd_rows<28, BF16>, fused_dynamics_fwd_rows<32, BF16>};
  const auto kernel = kernels[c.H / 4 - 1];
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         c.smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, c.rows, c.smem_bytes, stream>>>(x, eps, w, d, y, ez, div, reg_z, reg_j, B);
  return cudaGetLastError();
}

// sigmoid and softplus of n values through stage.cuh's gates
__global__ void gates_kernel(const float* __restrict__ z, float* __restrict__ sig,
                             float* __restrict__ sp, int n) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) cnf::gates(z[i], sig[i], sp[i]);
}

}  // namespace

// Weights: A* in nn.Linear layout (out, in), W*t their transposes (in, out),
// all contiguous float32.  W*t are read only when the weights are not staged
// in shared memory (cnf_plan's info[0] == 0) and may be null otherwise.
extern "C" int cnf_fused_dynamics_fwd(const float* x, const float* eps, const float* A1,
                                      const float* b1, const float* A2, const float* b2,
                                      const float* A3, const float* b3, const float* W1t,
                                      const float* W2t, const float* W3t, float* y, float* ez,
                                      float* div, float* reg_z, float* reg_j, int B, int n_in,
                                      int h, int n_out, int nz, int bf16, void* stream) {
  if (B <= 0) return cudaSuccess;
  const cnf::Weights w{W1t, W2t, W3t, A1, A2, A3, b1, b2, b3};
  const cnf::Dims d{n_in, h, n_out, nz};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<true>(x, eps, w, d, y, ez, div, reg_z, reg_j, B, st)
              : launch<false>(x, eps, w, d, y, ez, div, reg_z, reg_j, B, st);
}

// The gates every stage takes (stage.cuh), on n values: for the test that
// holds them to their stated error.
extern "C" int cnf_gates(const float* z, float* sig, float* sp, int n, void* stream) {
  if (n <= 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  gates_kernel<<<(n + 255) / 256, 256, 0, st>>>(z, sig, sp, n);
  return cudaGetLastError();
}

extern "C" const char* cnf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The launch shape K1 and K3 take for these widths (sd: the whole-solve
// kernel's state width, 0 for the single stage): returns rows per block and
// sets info[0] = weights staged in shared memory, info[1] = H of the row path
// (row_fwd_H; 0: tiled path).
extern "C" int cnf_plan(int n_in, int h, int n_out, int nz, int sd, int* info) {
  const cnf::Choice c = cnf::choose(cnf::Dims{n_in, h, n_out, nz}, sd);
  info[0] = c.staged ? 1 : 0;
  info[1] = c.H;
  return c.rows;
}
