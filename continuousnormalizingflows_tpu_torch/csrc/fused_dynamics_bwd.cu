// K2 on Hopper: the backward of one fused dynamics stage (K1) -- cotangents
// of (y, e_z, div, |y|, |e_z|) with respect to x, eps and the six weights.
//
// Replaces continuousnormalizingflows_tpu/ops/pallas_kernels.py _bwd_kernel
// (custom-VJP rule _fused_bwd).  Three paths, chosen from the widths
// (bwd_shape below):
//   * h <= 24, one row per thread in tiles of 64 rows
//     (fused_dynamics_bwd_rows): the stage and its backward with the
//     accumulators in registers and the intermediates in per-row
//     shared-memory columns (row_stage_bwd.cuh: row_stage_keep,
//     row_stage_bwd), then, after one block synchronisation, the tile's
//     weight-gradient sums (row_accumulate_wgrads) into the block's own row
//     of a (grid, P) buffer of partial sums, which a second kernel adds in
//     order of block.  The tiled design it replaces at these widths
//     synchronised its block after each of seven products, most of whose
//     threads idled in the products with N = nz, and summed the weight
//     gradients with scalar shared-memory reads.
//   * h >= kWideMinH = 64, the wide path (wide_stage_bwd.cuh): the
//     chain as a sequence of dense products over the whole batch, each split
//     over its output tiles, bf16 on the tensor cores, the weight gradients
//     as products of depth 2B over the batch; its header has the design and
//     its bound.
//   * between them (24 < h < 64), the tiled path (fused_dynamics_bwd_kernel,
//     stage_bwd.cuh): tiles of rows a block, each recomputing its forward and
//     adding its weight-gradient terms to the block's row of the (grid, P)
//     buffer.  At h = 32, padded to 32, a block of the row path takes 122 KB
//     of shared memory, an SM holds one (two warps), and the tiled path is
//     faster there (kStageRowMaxH below).
// Every path gives the same bits on every run: no atomics.
//
// What bounds the row path on an H100: per row the backward is ~3x the
// forward's products (recompute, the six backward products, the six outer
// products of the weight gradients) against ~100 bytes of device traffic,
// so, like K1, FMA and shared-memory issue inside the SM.
//
// C interface for ctypes: returns a cudaError_t (0 on success).

#include <climits>

#include "row_stage_bwd.cuh"
#include "wide_stage_bwd.cuh"

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


// ---- the row path (h <= 24) ----

// The widest padded hidden width that takes the row path.  Measured on an
// H100 at batch 65,536 (PERF.md section 6): at H = 8, 16 and 24 the row path
// takes 0.55-0.65 of the tiled path's time, at H = 32 1.24 of it.
constexpr int kStageRowMaxH = 24;

// Floats of a thread's own row: y, e_z, xbar, epsbar.
__host__ __device__ inline int stage_row_ld(const cnf::Dims& d) {
  return cnf::odd(d.n_out + d.n_in + 2 * d.nz);
}

// One row per thread, tiles of kRowBwdThreads rows.  Shared memory: the
// staged weights, the block's P weight-gradient sums, the column buffers of
// row_stage_bwd.cuh, then each thread's own row (odd stride).
template <int H, bool BF16>
__global__ void __launch_bounds__(cnf::kRowBwdThreads)
fused_dynamics_bwd_rows(const float* __restrict__ x, const float* __restrict__ eps,
                        cnf::Weights gw, cnf::Dims d, const float* __restrict__ ybar,
                        const float* __restrict__ ezbar, const float* __restrict__ divbar,
                        const float* __restrict__ rzbar, const float* __restrict__ rjbar,
                        float* __restrict__ xbar, float* __restrict__ epsbar,
                        float* __restrict__ partial, int B) {
  extern __shared__ __align__(16) float smem[];
  const cnf::RowWeights w = cnf::stage_row_weights<H, BF16>(gw, d, smem);
  const long P = cnf::param_count(d);
  float* acc = smem + cnf::round4(cnf::row_weight_floats(d, H));
  float* cols = acc + cnf::round4(P);
  cnf::RowCols c;
  float* own = cnf::carve_row_cols(cols, H, d, c);
  const int nz = d.nz, n_in = d.n_in, n_out = d.n_out;
  const int tid = threadIdx.x, nt = blockDim.x;
  float* Y = own + tid * stage_row_ld(d);
  float* E = Y + n_out;
  float* XB = E + nz;
  float* EPSB = XB + n_in;
  constexpr int ld = cnf::kRowLd;
  const int units = cnf::row_bwd_units(d, H);
  const cnf::RowCols my = c.at(tid);
  my.ONE[0] = 1.0f;
  my.ZERO[0] = 0.0f;
  // each entry of acc is zeroed, summed and written by the same thread
  for (long q = tid; q < P; q += nt) acc[q] = 0.0f;
  __syncthreads();  // the staged weights

  for (long row0 = (long)blockIdx.x * nt; row0 < B; row0 += (long)gridDim.x * nt) {
    const int R = (long)B - row0 < nt ? (int)((long)B - row0) : nt;  // ragged last tile
    const int R4 = (R + 3) & ~3;
    // the rows past the batch that the weight-gradient pass reads add zeros
    // (ONE and ZERO, the last two units, stay)
    if (tid >= R && tid < R4)
      for (int u = 0; u < units - 2; ++u) cols[u * ld + tid] = 0.0f;
    if (tid < R) {
      const long row = row0 + tid;
      for (int i = 0; i < n_in; ++i) my.X[i * ld] = x[row * n_in + i];
      for (int k = 0; k < nz; ++k) {
        my.EPS[k * ld] = eps[row * nz + k];
        my.EB[k * ld] = ezbar[row * nz + k];
        EPSB[k] = 0.0f;
      }
      for (int o = 0; o < n_out; ++o) my.YB[o * ld] = ybar[row * n_out + o];
      cnf::row_keep_u2<H, BF16>(w, d, my);
      float dv, ry, re;
      cnf::row_stage_keep<H, BF16>(w, d, my, Y, E, dv, ry, re);
      cnf::row_stage_bwd<H, BF16, true>(w, d, my, Y, E, ry, re, divbar[row], rzbar[row],
                                        rjbar[row], n_in, XB, EPSB);
      for (int i = 0; i < n_in; ++i) xbar[row * n_in + i] = XB[i];
      for (int k = 0; k < nz; ++k) epsbar[row * nz + k] = EPSB[k];
    }
    __syncthreads();
    cnf::row_accumulate_wgrads<H, BF16>(d, c, R4, acc);
    __syncthreads();  // the next tile overwrites the columns
  }
  for (long q = tid; q < P; q += nt) partial[(long)blockIdx.x * P + q] = acc[q];
}

// ---- plan and dispatch ----

// The narrowest hidden width that takes the wide path; narrower nets past the
// row path take the tiled one.  Measured on an H100 (chip_profile.py k2-wide,
// PERF.md section 6), device ms wide / tiled at 6 -> h -> h -> 5: at h = 32
// and 48 the tiled path wins at every batch (B = 65,536, fp32: 0.49 / 0.24
// and 0.86 / 0.50); at h = 64 the wide path wins in bf16 at every batch
// (0.088 / 0.097 at B = 256, 0.63 / 1.21 at 65,536) and in fp32 at 8,192
// (0.141 / 0.154), loses in fp32 at 256 (0.099 / 0.067: its dozen launches
// are a floor of ~0.09 ms) and 65,536 (0.87 / 0.80); from h = 96 it wins at
// every batch measured, and at h = 1024, B = 256 it takes 0.23 ms against
// 12.65 in bf16.
constexpr int kWideMinH = 64;

// K2's launch shape for these widths and batch: the row path (H > 0;
// pl.rows threads a block, one row each, the weights staged), the wide path
// (wide; pl.rows the rows of an output tile, slices the cuts of the batch in
// its weight-gradient products) or the tiled path (pl.rows rows a tile, 0
// when one row does not fit).  The row and tiled paths' blocks take tiles in
// turn and the grid is capped at what the card holds at once (row_bwd_grid,
// bwd_grid).  The launch and cnf_bwd_plan both read it: grid is the row count
// of the caller's partial-sum buffer (the wide path's: its slices, when more
// than one, the larger of the two precisions' counts).
struct StageBwdShape {
  int H;
  int grid;
  cnf::BwdPlan pl;
  bool wide;
  int slices;
};

// CNF_K2_ONE_BLOCK_A_TILE builds the row path's other grid, a block for every
// tile, for the measurement that chose between the two (chip_profile.py
// k2-grid; the result is in PERF.md section 6).  No build of the package defines
// it.
StageBwdShape bwd_shape(const cnf::Dims& d, int B) {
  const cnf::RowBwdPlan rp = cnf::row_bwd_plan(d, stage_row_ld(d));
  if (rp.H && rp.H <= kStageRowMaxH) {
#ifdef CNF_K2_ONE_BLOCK_A_TILE
    const int grid = (B + cnf::kRowBwdThreads - 1) / cnf::kRowBwdThreads;
#else
    const int grid = cnf::row_bwd_grid(B, rp.smem_bytes);
#endif
    return StageBwdShape{rp.H, grid,
                         cnf::BwdPlan{true, false, cnf::kRowBwdThreads, rp.smem_bytes,
                                      cnf::param_count(d)},
                         false, 0};
  }
  if (d.h >= kWideMinH) {
    const int slices = cnf::wide::wgrad_rows(d, B);
    return StageBwdShape{0, slices > 1 ? slices : 0,
                         cnf::BwdPlan{false, false, cnf::wide::kBM, 0, cnf::param_count(d)},
                         true, slices};
  }
  const cnf::BwdPlan pl = cnf::make_bwd_plan(d, 0);
  return StageBwdShape{0, pl.rows ? cnf::bwd_grid(B, pl.rows) : 0, pl, false, 0};
}

template <int H, bool BF16>
cudaError_t launch_rows(const float* x, const float* eps, const cnf::Weights& w,
                        const cnf::Dims& d, const float* ybar, const float* ezbar,
                        const float* divbar, const float* rzbar, const float* rjbar,
                        float* xbar, float* epsbar, float* partial, int B, int grid,
                        int smem_bytes, cudaStream_t stream) {
  const cudaError_t err = cnf::set_smem(fused_dynamics_bwd_rows<H, BF16>, smem_bytes);
  if (err != cudaSuccess) return err;
  fused_dynamics_bwd_rows<H, BF16><<<grid, cnf::kRowBwdThreads, smem_bytes, stream>>>(
      x, eps, w, d, ybar, ezbar, divbar, rzbar, rjbar, xbar, epsbar, partial, B);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t launch(const float* x, const float* eps, const cnf::Weights& w, const cnf::Dims& d,
                   const float* ybar, const float* ezbar, const float* divbar,
                   const float* rzbar, const float* rjbar, float* xbar, float* epsbar,
                   float* partial, float* scratch, float* grads, int B, cudaStream_t stream) {
  const StageBwdShape shape = bwd_shape(d, B);
  const cnf::BwdPlan& pl = shape.pl;
  const int grid = shape.grid;
  if (shape.wide)
    return cnf::wide::stage_bwd<BF16>(x, eps, w, d, ybar, ezbar, divbar, rzbar, rjbar, xbar,
                                      epsbar, partial, scratch, grads, B, stream);
  if (shape.H) {
    auto rows = launch_rows<24, BF16>;
    if (shape.H == 8) rows = launch_rows<8, BF16>;
    if (shape.H == 16) rows = launch_rows<16, BF16>;
    const cudaError_t err = rows(x, eps, w, d, ybar, ezbar, divbar, rzbar, rjbar, xbar, epsbar,
                                 partial, B, grid, pl.smem_bytes, stream);
    if (err != cudaSuccess) return err;
    return cnf::launch_reduce(partial, grid, pl.P, grads, stream);
  }
  if (pl.rows == 0) return cudaErrorInvalidValue;
  cudaError_t err = cnf::set_smem(fused_dynamics_bwd_kernel<BF16>, pl.smem_bytes);
  if (err != cudaSuccess) return err;
  fused_dynamics_bwd_kernel<BF16><<<grid, cnf::kThreads, pl.smem_bytes, stream>>>(
      x, eps, w, d, pl.staged, pl.acc_smem, ybar, ezbar, divbar, rzbar, rjbar, xbar, epsbar,
      partial, B, pl.rows, pl.P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return cnf::launch_reduce(partial, grid, pl.P, grads, stream);
}

}  // namespace

// Weights as for cnf_fused_dynamics_fwd; W*t are read only by the tiled path
// when it does not stage the weights (cnf_bwd_plan's info[0] == 0 and
// info[4] == 0).  partial holds grid x P floats and scratch info[4]
// (cnf_bwd_plan); grads receives the P weight gradients in nn.Linear layout:
// A1 (h, n_in), b1, A2 (h, h), b2, A3 (n_out, h), b3, one after the other.
extern "C" int cnf_fused_dynamics_bwd(const float* x, const float* eps, const float* A1,
                                      const float* b1, const float* A2, const float* b2,
                                      const float* A3, const float* b3, const float* W1t,
                                      const float* W2t, const float* W3t, const float* ybar,
                                      const float* ezbar, const float* divbar,
                                      const float* rzbar, const float* rjbar, float* xbar,
                                      float* epsbar, float* partial, float* scratch,
                                      float* grads, int B,
                                      int n_in, int h, int n_out, int nz, int bf16,
                                      void* stream) {
  if (B <= 0) return cudaSuccess;
  const cnf::Weights w{W1t, W2t, W3t, A1, A2, A3, b1, b2, b3};
  const cnf::Dims d{n_in, h, n_out, nz};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<true>(x, eps, w, d, ybar, ezbar, divbar, rzbar, rjbar, xbar, epsbar,
                             partial, scratch, grads, B, st)
              : launch<false>(x, eps, w, d, ybar, ezbar, divbar, rzbar, rjbar, xbar, epsbar,
                              partial, scratch, grads, B, st);
}

// This kernel's launch plan for these widths and batch (the whole-solve
// backward's is cnf_solve_bwd_plan): returns rows per tile (the row path:
// threads a block, one row each; the wide path: rows of an output tile; 0:
// the widths do not fit) and sets info[0] = weights staged in shared memory,
// info[1] = grid (rows of the partial-sum buffer, 0: none), info[2] = P, the
// parameter count, info[3] = H of the row path (0: another path), info[4] =
// the wide path's scratch floats for this batch (0: another path; a scratch
// past 2^31 floats does not fit).
extern "C" int cnf_bwd_plan(int n_in, int h, int n_out, int nz, int B, int* info) {
  const cnf::Dims d{n_in, h, n_out, nz};
  const StageBwdShape shape = bwd_shape(d, B);
  const long scratch = shape.wide ? cnf::wide::scratch_floats(d, B) : 0;
  info[0] = shape.pl.staged ? 1 : 0;
  info[1] = shape.grid;
  info[2] = (int)shape.pl.P;
  info[3] = shape.H;
  info[4] = scratch > INT_MAX ? 0 : (int)scratch;
  return scratch > INT_MAX ? 0 : shape.pl.rows;
}
