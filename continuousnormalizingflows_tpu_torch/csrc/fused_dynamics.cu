// K1 on Hopper: one dynamics stage, fused -- the MLP forward, the Hutchinson
// probe VJP and the per-row reductions in one launch.
//
// Replaces continuousnormalizingflows_tpu/ops/pallas_kernels.py _fwd_kernel
// (public fused_dynamics_vjp).  Three paths, chosen from the widths
// (fwd_shape; row_stage.cuh `choose` between the first two, which K3 shares):
//   * h <= 32: one row per thread, activations in registers, weights in
//     shared memory (row_stage.cuh);
//   * h >= kWideMinH: the wide path, a chain of dense products over the
//     whole batch on the tensor cores (bf16) with K2's wide forward
//     (wide_stage_fwd.cuh), intermediates in a scratch the caller allocates;
//   * between: one block per tile of rows, activations in shared memory,
//     register-tiled products (stage.cuh).
// The row and tiled paths write only y, e_z and the three per-row scalars to
// device memory.  No path needs the batch to divide: rows past the end are
// skipped.
//
// What bounds it on an H100: a flagship row is ~3.3 kFLOP against 96 bytes
// of device memory (x, eps in; y, e_z, 3 scalars out), ~35 FLOP per byte,
// above the fp32 CUDA-core balance of ~20 (67 TFLOP/s over 3.35 TB/s): FMA
// and shared-memory issue, not HBM.  Hence no intermediate leaves the SM, and
// the weights are read from shared memory as broadcasts.  At the tabular
// width (h = 176) a row is ~185 kFLOP and the products dominate more still.
// At the image model's 785 -> 1024 -> 1024 -> 784 a row is 3.4 M FMA and the
// weights 21 MB: the tiled path fits 3 rows a block (86 blocks on 132 SMs),
// multiplies three rows at a time and re-reads every weight from L2 for each
// block, with bf16 rounded on the CUDA cores.  The wide path instead reads a
// weight tile once for every 64 rows of the batch, feeds bf16 operands to
// mma.sync, and keeps its intermediates in L2 (at that shape in bf16: 3 MB,
// beside 7 MB of bf16 copies of x, eps and the weights).
//
// C interface for ctypes: returns a cudaError_t (0 on success).

#include <climits>

#include "row_stage.cuh"
#include "wide_stage_fwd.cuh"

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

// ---- the wide path ----

// The narrowest hidden width that takes the wide path; narrower nets past the
// row path take the tiled one.  Measured on an H100 (chip_profile.py k1-wide,
// PERF.md section 6), device ms wide / tiled at 6 -> h -> h -> 5, B = 256,
// 8,192 and 65,536: at h = 33 and 48 the tiled path wins in bf16 at the
// large batches (h = 48, B = 65,536: 0.222 / 0.181); from h = 64 the wide path
// wins in bf16 at every batch (0.031 / 0.045, 0.046 / 0.058, 0.239 / 0.264),
// but loses in fp32 at every batch there (0.039 / 0.032 at 256, 0.300 / 0.204
// at 65,536: seven launches are a floor of ~0.03 ms, and its fp32 products
// run on the CUDA cores); from h = 96 it wins at every batch in both, and at
// h = 1024, B = 256 it takes 0.091 ms against 1.039 in bf16.
constexpr int kWideMinH = 64;

// K1's launch shape: cnf::choose's row or tiled path, or the wide path.
struct FwdShape {
  cnf::Choice c;
  bool wide;
};

FwdShape fwd_shape(const cnf::Dims& d) {
  const cnf::Choice c = cnf::choose(d, 0);
  return FwdShape{c, c.H == 0 && d.h >= kWideMinH};
}

// The wide path's scratch: s1, s2 (B x h, fp32), then two operand arrays,
// h1 then d2 and h2 then d1 (B x h fp32, or B x pad8(h) bf16 rows), and in
// bf16 the copies of the inputs (input_copy_halves); the larger of the two
// layouts, in floats.
long wide_scratch_fp32_part_of_bf16(const cnf::Dims& d, int B) {
  return (2L * B * d.h + 3) & ~3L;  // the bf16 copies start 16-byte aligned
}

long wide_scratch_floats(const cnf::Dims& d, int B) {
  const long fp32 = 4L * B * d.h;
  const long halves = 2L * B * cnf::wide::pad8(d.h) + cnf::wide::input_copy_halves(d, B);
  const long bf16 = wide_scratch_fp32_part_of_bf16(d, B) + (halves + 1) / 2;
  return fp32 > bf16 ? fp32 : bf16;
}

// K1's epilogues of the forward products: y and e_z into K1's outputs, s1
// and s2 (fp32) and the operands the next products read, h1, h2, d2, d1 (T,
// rows of ldt).  h1 and d2 share an array, as do h2 and d1: F3 writes d2
// once F2 has read h1, F4 d1 once F3 has read h2.
template <bool BF16>
struct FwdEpi {
  using T = std::conditional_t<BF16, cnf::wide::bf16, float>;
  int h, nz, ldt;
  const float *b1, *b2, *b3;
  float *S1, *S2;        // (B, h)
  T *H1, *H2, *D1, *D2;  // (B, ldt)
  float *Y, *E;          // (B, nz)

  __device__ __forceinline__ void operator()(const cnf::wide::Product& p, int, int m, int n,
                                             float a) const {
    using namespace cnf::wide;
    const long i = (long)m * h + n, it = (long)m * ldt + n;
    switch (p.epi) {
      case kF1: gate_into(a + b1[n], S1, i, H1, it); break;
      case kF2: gate_into(a + b2[n], S2, i, H2, it); break;
      case kY: Y[(long)m * nz + n] = a + b3[n]; break;
      case kU2: put(D2, it, S2[i] * a); break;
      case kU1: put(D1, it, S1[i] * a); break;
      default: E[(long)m * nz + n] = a;  // kE
    }
  }
};

// R: div = <e_z, eps>, |y| and |e_z| (floored at 1e-20 under the root) of
// each row, tpr threads a row (wide::row_threads), 256 / tpr rows a block.
__global__ void __launch_bounds__(256)
wide_fwd_norms(const float* __restrict__ y, const float* __restrict__ ez,
               const float* __restrict__ eps, float* __restrict__ div,
               float* __restrict__ reg_z, float* __restrict__ reg_j, int B, int nz, int tpr) {
  __shared__ float part[3][8];
  const int lt = threadIdx.x % tpr;  // the thread within its row
  const long row = (long)blockIdx.x * (256 / tpr) + threadIdx.x / tpr;
  const bool in = row < B;
  float s[3] = {0.0f, 0.0f, 0.0f};  // <e_z, eps>, sum y^2, sum e_z^2
  if (in) {
    const float *yr = y + row * nz, *er = ez + row * nz, *pr = eps + row * nz;
    for (int k = lt; k < nz; k += tpr) {
      s[0] = fmaf(er[k], pr[k], s[0]);
      s[1] = fmaf(yr[k], yr[k], s[1]);
      s[2] = fmaf(er[k], er[k], s[2]);
    }
  }
  cnf::wide::row_sums(s, part, tpr);
  if (!in || lt) return;
  div[row] = s[0];
  reg_z[row] = sqrtf(s[1] + 1e-20f);
  reg_j[row] = sqrtf(s[2] + 1e-20f);
}

// The wide path on the caller's stream: C (bf16), F1-F5, R.  scratch:
// wide_scratch_floats(d, B) floats.  n_out == nz.
template <bool BF16>
cudaError_t launch_wide(const float* x, const float* eps, const cnf::Weights& w,
                        const cnf::Dims& d, float* y, float* ez, float* div, float* reg_z,
                        float* reg_j, float* scratch, int B, cudaStream_t stream) {
  namespace wd = cnf::wide;
  using T = typename FwdEpi<BF16>::T;
  const int h = d.h, ldt = BF16 ? wd::pad8(h) : h;
  const long Bh = (long)B * h;
  FwdEpi<BF16> e{h, d.nz, ldt, w.b1, w.b2, w.b3, scratch, scratch + Bh};
  e.Y = y;
  e.E = ez;
  // the operands the products read: fp32, the inputs themselves
  wd::FwdOperands o{x, eps, w.A1, w.A2, w.A3, nullptr, nullptr, nullptr, nullptr,
                    d.n_in, d.nz, h};
  T* q = reinterpret_cast<T*>(scratch + (BF16 ? wide_scratch_fp32_part_of_bf16(d, B) : 2 * Bh));
  e.H1 = e.D2 = q;
  e.H2 = e.D1 = q + (long)B * ldt;
  if constexpr (BF16) {
    CNF_WIDE_TRY(wd::convert_inputs<1>(x, eps, w, d, B, q + 2L * B * ldt, o, stream));
    if (h & 7)  // the padding of the rows the epilogues write, zero
      CNF_WIDE_TRY(cudaMemsetAsync(q, 0, 2L * B * ldt * sizeof(T), stream));
  }
  o.H1 = e.H1;
  o.H2 = e.H2;
  o.D1 = e.D1;
  o.D2 = e.D2;
  CNF_WIDE_TRY(wd::forward_products<BF16>(o, d, B, e, stream));
  const int tpr = wd::row_threads(d.nz), rows = 256 / tpr;
  wide_fwd_norms<<<(B + rows - 1) / rows, 256, 0, stream>>>(y, ez, eps, div, reg_z, reg_j, B,
                                                            d.nz, tpr);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t launch(const float* x, const float* eps, const cnf::Weights& w, const cnf::Dims& d,
                   float* y, float* ez, float* div, float* reg_z, float* reg_j, float* scratch,
                   int B, cudaStream_t stream) {
  const FwdShape shape = fwd_shape(d);
  if (shape.wide)
    return launch_wide<BF16>(x, eps, w, d, y, ez, div, reg_z, reg_j, scratch, B, stream);
  const cnf::Choice& c = shape.c;
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
// all contiguous float32.  W*t are read only by the tiled path when it does
// not stage the weights in shared memory (cnf_fwd_plan's info[0] == 0 and
// info[2] == 0) and may be null otherwise.  scratch: info[2] floats
// (cnf_fwd_plan; the wide path's, else unread).
extern "C" int cnf_fused_dynamics_fwd(const float* x, const float* eps, const float* A1,
                                      const float* b1, const float* A2, const float* b2,
                                      const float* A3, const float* b3, const float* W1t,
                                      const float* W2t, const float* W3t, float* y, float* ez,
                                      float* div, float* reg_z, float* reg_j, float* scratch,
                                      int B, int n_in, int h, int n_out, int nz, int bf16,
                                      void* stream) {
  if (B <= 0) return cudaSuccess;
  const cnf::Weights w{W1t, W2t, W3t, A1, A2, A3, b1, b2, b3};
  const cnf::Dims d{n_in, h, n_out, nz};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<true>(x, eps, w, d, y, ez, div, reg_z, reg_j, scratch, B, st)
              : launch<false>(x, eps, w, d, y, ez, div, reg_z, reg_j, scratch, B, st);
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

// K1's launch plan for these widths and batch: returns rows a block (the row
// path: threads a block, one row each; the wide path: rows of an output tile;
// 0: the widths do not fit) and sets info[0] = weights staged in shared
// memory, info[1] = H of the row path (0: another path), info[2] = the wide
// path's scratch floats at this batch (0: another path; a scratch past 2^31
// floats does not fit).
extern "C" int cnf_fwd_plan(int n_in, int h, int n_out, int nz, int B, int* info) {
  const cnf::Dims d{n_in, h, n_out, nz};
  const FwdShape shape = fwd_shape(d);
  const long scratch = shape.wide ? wide_scratch_floats(d, B) : 0;
  info[0] = shape.wide || !shape.c.staged ? 0 : 1;
  info[1] = shape.wide ? 0 : shape.c.H;
  info[2] = scratch > INT_MAX ? 0 : (int)scratch;
  if (scratch > INT_MAX) return 0;
  return shape.wide ? cnf::wide::kBM : shape.c.rows;
}
