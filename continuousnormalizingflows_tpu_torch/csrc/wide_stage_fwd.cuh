// The stage's forward as a chain of dense products over the whole batch, as
// both wide paths run it: K1's (fused_dynamics.cu) to return y and e_z, K2's
// (wide_stage_bwd.cuh) as the first phases of its backward, keeping the
// intermediates the backward reads.  Each kernel passes its own epilogue
// (wide_gemm.cuh), which decides what becomes of a product's elements; the
// products, their launches and the operands' bf16 copies are the same.
//
// The phases, one launch each on the caller's stream (A1 (h, n_in), A2 (h, h),
// A3 (n_out, h), nn.Linear layout):
//   C   (bf16) x, eps, A1, A2, A3     -> their bf16 copies (convert_inputs)
//   F1  z1 = x A1^T + b1              -> s1, h1 (cnf::gates)
//   F2  z2 = h1 A2^T + b2             -> s2, h2
//   F3  y = h2 A3^T + b3;  u2 = eps A3 -> y;  d2 = u2 s2 (two products, one launch)
//   F4  u1 = d2 A2                    -> d1 = u1 s1
//   F5  e_z = d1 A1[:, :nz]
// (forward_products runs F1-F5.)  Then each kernel's per-row reductions over
// y and e_z (row_sums): K1's div and norms, K2's merged cotangents.
//
// precision: with BF16 the products read bfloat16 copies of their operands
// (rounded to nearest even from the fp32 values, as the plain version's
// _round_bf16), rows padded to a multiple of 8 elements and zero there: C
// makes those of the inputs, the epilogues those of h1, h2, d1 and d2 as they
// compute them (put).  s1, s2, the sums and the epilogues stay fp32.
#pragma once

#include <initializer_list>
#include <type_traits>

#include "stage.cuh"
#include "wide_gemm.cuh"

#define CNF_WIDE_TRY(call)                  \
  do {                                      \
    const cudaError_t err_ = (call);        \
    if (err_ != cudaSuccess) return err_;   \
  } while (0)

namespace cnf {
namespace wide {

// The forward products' epilogue cases; K2's backward cases follow them.
enum FwdCase : int { kF1, kF2, kY, kU2, kU1, kE, kFwdCases };

// Stores an operand element in its product type (bf16: rounded to nearest even).
template <class T>
__device__ __forceinline__ void put(T* a, long j, float v) {
  if constexpr (std::is_same_v<T, bf16>) {
    a[j] = __float2bfloat16_rn(v);
  } else {
    a[j] = v;
  }
}

// F1's and F2's epilogue: sigmoid(z) into S[i] (fp32), softplus(z) into the
// operand H[it].
template <class T>
__device__ __forceinline__ void gate_into(float z, float* S, long i, T* H, long it) {
  float sp;
  gates(z, S[i], sp);
  put(H, it, sp);
}

// Launches the products ps as one grid, with epilogue epi.
template <bool BF16, class Epi>
cudaError_t run(const Epi& epi, std::initializer_list<Product> ps, cudaStream_t stream) {
  Launch<Epi> L{};
  L.count = 0;
  for (const Product& q : ps) L.p[L.count++] = q;
  L.epi = epi;
  return launch_products<BF16>(L, stream);
}

// The forward's operands as the products read them: the fp32 arrays, or in
// bf16 their copies; rows of ldi (x, A1), ldz (eps) and ldh (h1, h2, d1, d2,
// A2, A3) elements.  h1, h2, d1 and d2 are what the epilogue writes in kF1,
// kF2, kU2 and kU1.
struct FwdOperands {
  const void *X, *EPS, *A1, *A2, *A3;
  const void *H1, *H2, *D1, *D2;
  int ldi, ldz, ldh;
};

// F1-F5 with the caller's epilogue.
template <bool BF16, class Epi>
cudaError_t forward_products(const FwdOperands& o, const Dims& d, int B, const Epi& epi,
                             cudaStream_t stream) {
  const int h = d.h, n_in = d.n_in, n_out = d.n_out, nz = d.nz;
  CNF_WIDE_TRY(run<BF16>(epi, {product(by_row(o.X, o.ldi, B), by_row(o.A1, o.ldi, h), B, h,
                                       n_in, kF1)}, stream));
  CNF_WIDE_TRY(run<BF16>(epi, {product(by_row(o.H1, o.ldh, B), by_row(o.A2, o.ldh, h), B, h, h,
                                       kF2)}, stream));
  CNF_WIDE_TRY(run<BF16>(epi, {product(by_row(o.H2, o.ldh, B), by_row(o.A3, o.ldh, n_out), B,
                                       n_out, h, kY),
                               product(by_row(o.EPS, o.ldz, B), by_col(o.A3, o.ldh, h), B, h, nz,
                                       kU2)}, stream));
  CNF_WIDE_TRY(run<BF16>(epi, {product(by_row(o.D2, o.ldh, B), by_col(o.A2, o.ldh, h), B, h, h,
                                       kU1)}, stream));
  return run<BF16>(epi, {product(by_row(o.D1, o.ldh, B), by_col(o.A1, o.ldi, nz), B, nz, h, kE)},
                   stream);
}

// bf16 elements of C's copies: eps, x (B rows), A1, A2, A3, rows padded to 8.
inline long input_copy_halves(const Dims& d, int B) {
  const long ldh = pad8(d.h), ldz = pad8(d.nz), ldi = pad8(d.n_in);
  return (long)B * (ldz + ldi) + (long)d.h * (ldi + ldh) + (long)d.n_out * ldh;
}

// The bf16 copies of kConvert fp32 matrices (rows x cols, row-major), rows
// padded to ld elements with zeros: block (i, j) takes rows i, i + gridDim.x,
// ... of matrix j.
constexpr int kConvert = 5;
struct Convert {
  const float* src[kConvert];
  bf16* dst[kConvert];
  int rows[kConvert], cols[kConvert], ld[kConvert];
};

// Owner: the kernel that launches it (1: K1, 2: K2, 3: K3, 4: K4), so that a
// profile tells their launches apart.
template <int Owner>
__global__ void __launch_bounds__(256) wide_to_bf16(const __grid_constant__ Convert cv) {
  const int j = blockIdx.y, cols = cv.cols[j], ld = cv.ld[j];
  for (long r = blockIdx.x; r < cv.rows[j]; r += gridDim.x) {
    const float* src = cv.src[j] + r * cols;
    bf16* dst = cv.dst[j] + r * ld;
    for (int c = threadIdx.x; c < ld; c += blockDim.x)
      dst[c] = __float2bfloat16_rn(c < cols ? src[c] : 0.0f);
  }
}

// C: carves the bf16 copies of eps, x, A1, A2, A3 (in that order,
// input_copy_halves of them) from q, launches their conversion, and points
// o's inputs at them with their padded rows.  With x null the x slot is left
// to the caller (the wide solves write their stage inputs there).
template <int Owner>
cudaError_t convert_inputs(const float* x, const float* eps, const Weights& w, const Dims& d,
                           int B, bf16* q, FwdOperands& o, cudaStream_t stream) {
  const int h = d.h, n_out = d.n_out;
  const int ldh = pad8(h), ldz = pad8(d.nz), ldi = pad8(d.n_in);
  bf16* eps16 = q;
  bf16* x16 = eps16 + (long)B * ldz;
  bf16* a1 = x16 + (long)B * ldi;
  bf16* a2 = a1 + (long)h * ldi;
  bf16* a3 = a2 + (long)h * ldh;
  const Convert cv{{x, eps, w.A1, w.A2, w.A3}, {x16, eps16, a1, a2, a3},
                   {x ? B : 0, B, h, h, n_out}, {d.n_in, d.nz, d.n_in, h, h},
                   {ldi, ldz, ldi, ldh, ldh}};
  int most = B > h ? B : h;
  most = most > n_out ? most : n_out;
  wide_to_bf16<Owner><<<dim3(most < 1024 ? most : 1024, kConvert), 256, 0, stream>>>(cv);
  o.X = x16;
  o.EPS = eps16;
  o.A1 = a1;
  o.A2 = a2;
  o.A3 = a3;
  o.ldi = ldi;
  o.ldz = ldz;
  o.ldh = ldh;
  return cudaGetLastError();
}

// Threads a row of the per-row reductions over `cols` columns: about 8
// columns a thread, a power of two from 32 to 256.
inline int row_threads(int cols) {
  int tpr = 32;
  while (tpr < 256 && 8 * tpr < cols) tpr *= 2;
  return tpr;
}

// Sums each of a thread's N values over the tpr threads of its row (256 /
// tpr rows a block of 256, row_threads): by shuffles within each warp, then
// the row's warps' sums in order, the same order on every run.  Every
// thread of the block calls it; part: shared [N][8].
template <int N>
__device__ __forceinline__ void row_sums(float (&v)[N], float (*part)[8], int tpr) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int off = 16; off; off >>= 1) v[j] += __shfl_xor_sync(0xffffffffu, v[j], off);
  if (lane == 0)
#pragma unroll
    for (int j = 0; j < N; ++j) part[j][warp] = v[j];
  __syncthreads();
  const int w0 = (tid / tpr) * (tpr / 32);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    v[j] = 0.0f;
    for (int w = w0; w < w0 + tpr / 32; ++w) v[j] += part[j][w];
  }
}

}  // namespace wide
}  // namespace cnf
