// One dynamics stage of a 3-layer softplus MLP with its Hutchinson probe VJP,
// for a tile of rows held in shared memory.  Shared by the per-stage kernel
// (fused_dynamics.cu) and the whole-solve RK4 kernel (fused_solve.cu).
//
// For each row r of the tile, with weights in nn.Linear layout
// A1 (h, n_in), A2 (h, h), A3 (n_out, h):
//
//   z1 = A1 x + b1,  s1 = sigmoid(z1),  h1 = softplus(z1)
//   z2 = A2 h1 + b2, s2 = sigmoid(z2),  h2 = softplus(z2)
//   y  = A3 h2 + b3
//   d2 = (A3^T eps) * s2,  d1 = (A2^T d2) * s1,  e_z = (A1^T d1)[:nz]
//   div = <e_z, eps>,  |y| = sqrt(sum y^2 + 1e-20),  |e_z| likewise
//
// The TPU kernels (continuousnormalizingflows_tpu/ops/pallas_kernels.py
// _recompute_forward, ops/pallas_solve.py _stage_fwd) compute the same chain
// on 128-lane zero-padded tiles.  Here no width is padded to a tile: every
// product loops over the true widths, and the ragged batch edge is handled by
// running the stage on the valid rows only.
//
// This is the path for nets wider than row_stage.cuh takes (h > 32), e.g. the
// tabular width 44 -> 176 -> 176 -> 43: ~185 kFLOP per row per stage against
// under 1 KB of input and output, so the stage is bound by instruction issue
// inside the SM (FMAs and their shared-memory operand loads), not by HBM.
// The design:
//   * every activation of the tile stays in 4 shared buffers of (rows, h),
//     reused in place (s1 -> d1, s2 -> d2); only the inputs and the outputs
//     the caller needs touch device memory;
//   * each product is register-tiled: a thread owns a 4 x 4 block of outputs
//     and loads 4 + 4 operands per 16 FMAs (a naive dot loads 2 per FMA);
//     row strides are odd so the threads of a warp hit distinct banks;
//   * the weights, in both the layouts the forward and the VJP products walk,
//     are staged once per block in shared memory when they fit (48 KB: up to
//     h ~ 75 at small n_in); wider nets read them from L2 through L1, from
//     transposed copies so a warp's reads are contiguous.
//
// precision: BF16 = true rounds both operands of every product to bfloat16
// (round to nearest even) and accumulates in fp32, the JAX compute_dtype=bf16
// path; BF16 = false is true fp32 (FMA on CUDA cores, no TF32).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cnf {

constexpr int kThreads = 256;
constexpr int kTM = 4;  // rows of a thread's output tile
constexpr int kTN = 4;  // columns of a thread's output tile
constexpr long kBlockBudgetBytes = 100L * 1024;  // two blocks per SM
constexpr long kStageWeightsBytes = 48L * 1024;
constexpr int kMaxRows = 128;

struct Dims {
  int n_in, h, n_out, nz;
};

// Weight pointers as the products read them: forward matrices transposed to
// (in, out) row-major, VJP matrices in nn.Linear layout.  When the weights
// are staged, the W*t pointers from the host are not read (may be null).
struct Weights {
  const float* W1t;  // (n_in, h)
  const float* W2t;  // (h, h)
  const float* W3t;  // (h, n_out)
  const float* A1;   // (h, n_in)
  const float* A2;   // (h, h)
  const float* A3;   // (n_out, h)
  const float* b1;   // (h)
  const float* b2;   // (h)
  const float* b3;   // (n_out)
};

// Shared-memory buffers of one stage, row-major with odd row strides.
struct StageBufs {
  float* X;    // (R, n_in)  net input
  float* S1;   // (R, h)     sigmoid(z1), then d1
  float* H1;   // (R, h)     softplus(z1)
  float* S2;   // (R, h)     sigmoid(z2), then d2
  float* H2;   // (R, h)     softplus(z2)
  float* Y;    // (R, n_out) net output
  float* E;    // (R, nz)    e_z
  float* EPS;  // (R, nz)    probe
  float* ST;   // (R, 3)     div, |y|, |e_z|
  int ldx, ldh, ldy, ldz;
};

__host__ __device__ inline int odd(int w) { return w | 1; }

__host__ __device__ inline long weight_floats(const Dims& d) {
  return 2L * ((long)d.n_in * d.h + (long)d.h * d.h + (long)d.h * d.n_out) + 2L * d.h + d.n_out;
}

__host__ __device__ inline int stage_floats_per_row(const Dims& d) {
  return odd(d.n_in) + 4 * odd(d.h) + odd(d.n_out) + 2 * odd(d.nz) + 3;
}

// Shared-memory plan of a block: whether the weights are staged, and how
// many rows a block takes (0 if one row does not fit in 227 KB).
struct Plan {
  bool staged;
  int rows;
  int smem_bytes;
};

inline Plan make_plan(const Dims& d, int extra_floats_per_row) {
  const long wf = weight_floats(d);
  const bool staged = 4 * wf <= kStageWeightsBytes;
  const long fixed = staged ? wf : 0;
  const long per_row = stage_floats_per_row(d) + extra_floats_per_row;
  long rows = (kBlockBudgetBytes / 4 - fixed) / per_row;
  if (rows > kMaxRows) rows = kMaxRows;
  if (rows < 1) rows = 1;
  const long bytes = 4 * (fixed + rows * per_row);
  if (bytes > 227L * 1024) return Plan{staged, 0, 0};
  return Plan{staged, (int)rows, (int)bytes};
}

// Lets a kernel take `bytes` of dynamic shared memory (above 48 KB a launch
// needs this first).
template <class K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Copies the weights into shared memory at p (when staged) and returns the
// pointers the products read.  The forward matrices are transposed from the
// nn.Linear layout on the way, so a staged call needs no W*t copies.
// Advances p past what it used.
__device__ inline Weights stage_weights(const Weights& g, const Dims& d, bool staged, float*& p) {
  if (!staged) return g;
  const int n_in = d.n_in, h = d.h, n_out = d.n_out;
  // destination m is (rows, cols) row-major; the first three read their
  // source (cols, rows) transposed
  const float* src[9] = {g.A1, g.A2, g.A3, g.A1, g.A2, g.A3, g.b1, g.b2, g.b3};
  const int rows[9] = {n_in, h, h, h, h, n_out, 1, 1, 1};
  const int cols[9] = {h, h, n_out, n_in, h, h, h, h, n_out};
  float* dst[9];
  for (int m = 0; m < 9; ++m) {
    dst[m] = p;
    const int n = rows[m] * cols[m];
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int r = i / cols[m], c = i - r * cols[m];
      p[i] = __ldg(src[m] + (m < 3 ? c * rows[m] + r : i));
    }
    p += n;
  }
  return Weights{dst[0], dst[1], dst[2], dst[3], dst[4], dst[5], dst[6], dst[7], dst[8]};
}

// Carves the stage buffers for `rows` rows from p; returns the next free float.
__device__ inline float* carve_stage(float* p, int rows, const Dims& d, StageBufs& s) {
  s.ldx = odd(d.n_in);
  s.ldh = odd(d.h);
  s.ldy = odd(d.n_out);
  s.ldz = odd(d.nz);
  s.X = p;   p += rows * s.ldx;
  s.S1 = p;  p += rows * s.ldh;
  s.H1 = p;  p += rows * s.ldh;
  s.S2 = p;  p += rows * s.ldh;
  s.H2 = p;  p += rows * s.ldh;
  s.Y = p;   p += rows * s.ldy;
  s.E = p;   p += rows * s.ldz;
  s.EPS = p; p += rows * s.ldz;
  s.ST = p;  p += rows * 3;
  return p;
}

template <bool BF16>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// sigmoid(z) and softplus(z) = log(1 + e^z) from one exponential, without
// overflow: with e = e^-|z|, softplus = max(z, 0) + log1p(e) and sigmoid is
// 1 / (1 + e) for z >= 0, e / (1 + e) below.  Every stage of every kernel
// (row and tiled, forward and backward) takes its gates here, so a
// backward's recompute equals its forward.
//
// ~17 instructions, two of them on the SM's special-function unit: e =
// ex2.approx(-|z| log2 e), 1 / (1 + e) = rcp.approx, and log1p(e) = e + e^2
// Q(e) with Q a degree-7 polynomial (relative error of the fit 3.3e-8 on
// [0, 1]).  The libm expf, IEEE division and log1pf it replaces took ~45,
// more than the products of a stage.  Error against float64 (a sweep over
// |z| <= 90, tests/test_torch_kernels_cuda.py): sigmoid within 2.5e-7
// absolute; both within 6e-7 + 8e-8 |z| relative (z < 0) or 6e-7 (z >= 0)
// wherever the float64 value is a normal float.  The |z| term is the
// rounding of -|z| log2 e to float, which shows only where the value is
// below e^-|z|; results below 2^-126 flush to zero (ftz).
__device__ __forceinline__ void gates(float z, float& sig, float& sp) {
  float e, inv;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(fabsf(z) * -1.44269504f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(inv) : "f"(1.0f + e));
  sig = z >= 0.0f ? inv : e * inv;
  float q = 5.36481850e-3f;
  q = fmaf(q, e, -3.00657712e-2f);
  q = fmaf(q, e, 7.92044997e-2f);
  q = fmaf(q, e, -1.37538001e-1f);
  q = fmaf(q, e, 1.91536531e-1f);
  q = fmaf(q, e, -2.48571634e-1f);
  q = fmaf(q, e, 3.33213240e-1f);
  q = fmaf(q, e, -4.99996483e-1f);
  sp = fmaxf(z, 0.0f) + fmaf(q * e, e, e);
}

// C = A M for rows [0, R): A is (R, K) in shared memory with row stride lda,
// M is (K, N) with element (k, n) at M[k * ldm + n].  Each thread computes
// kTM x kTN tiles of C and hands each valid element to epi(r, n, value).
// Sums run over k in order, one fp32 FMA per term.
template <bool BF16, class Epi>
__device__ __forceinline__ void block_mm(const float* A, int lda, int R, int K,
                                         const float* M, int ldm, int N, Epi epi) {
  const int col_tiles = (N + kTN - 1) / kTN;
  const int tiles = ((R + kTM - 1) / kTM) * col_tiles;
  for (int tile = threadIdx.x; tile < tiles; tile += blockDim.x) {
    const int r0 = (tile / col_tiles) * kTM, n0 = (tile % col_tiles) * kTN;
    // out-of-range rows and columns load a valid neighbour; their sums are dropped
    const float* arow[kTM];
#pragma unroll
    for (int i = 0; i < kTM; ++i) arow[i] = A + min(r0 + i, R - 1) * lda;
    int col[kTN];
#pragma unroll
    for (int j = 0; j < kTN; ++j) col[j] = min(n0 + j, N - 1);
    float acc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
#pragma unroll 2
    for (int k = 0; k < K; ++k) {
      const float* mk = M + (size_t)k * ldm;
      float a[kTM], m[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = rnd<BF16>(arow[i][k]);
#pragma unroll
      for (int j = 0; j < kTN; ++j) m[j] = rnd<BF16>(mk[col[j]]);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], m[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      if (r0 + i >= R) break;
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        if (n0 + j < N) epi(r0 + i, n0 + j, acc[i][j]);
    }
  }
}

// Runs one stage on rows [0, R) of the tile.  Reads s.X and s.EPS; writes
// s.Y, s.E and s.ST.  Every thread of the block must call it; it starts and
// ends with the block synchronised.
template <bool BF16>
__device__ void stage_fwd(const Dims& d, const Weights& w, const StageBufs& s, int R) {
  const int h = d.h, n_in = d.n_in, n_out = d.n_out, nz = d.nz;
  const int ldh = s.ldh, ldy = s.ldy, ldz = s.ldz;

  // layer 1: z1 = A1 x + b1
  block_mm<BF16>(s.X, s.ldx, R, n_in, w.W1t, h, h, [&](int r, int n, float acc) {
    gates(acc + w.b1[n], s.S1[r * ldh + n], s.H1[r * ldh + n]);
  });
  __syncthreads();

  // layer 2: z2 = A2 h1 + b2
  block_mm<BF16>(s.H1, ldh, R, h, w.W2t, h, h, [&](int r, int n, float acc) {
    gates(acc + w.b2[n], s.S2[r * ldh + n], s.H2[r * ldh + n]);
  });
  __syncthreads();

  // layer 3: y = A3 h2 + b3; and the probe enters: d2 = (A3^T eps) * s2,
  // written over s2 (each element is read and written by its own thread)
  block_mm<BF16>(s.H2, ldh, R, h, w.W3t, n_out, n_out, [&](int r, int n, float acc) {
    s.Y[r * ldy + n] = acc + w.b3[n];
  });
  block_mm<BF16>(s.EPS, ldz, R, nz, w.A3, h, h, [&](int r, int n, float acc) {
    s.S2[r * ldh + n] *= acc;
  });
  __syncthreads();

  // d1 = (A2^T d2) * s1, written over s1
  block_mm<BF16>(s.S2, ldh, R, h, w.A2, h, h, [&](int r, int n, float acc) {
    s.S1[r * ldh + n] *= acc;
  });
  __syncthreads();

  // e_z = (A1^T d1)[:nz]
  block_mm<BF16>(s.S1, ldh, R, h, w.A1, n_in, nz, [&](int r, int n, float acc) {
    s.E[r * ldz + n] = acc;
  });
  __syncthreads();

  // per-row reductions
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const float* e = s.E + r * ldz;
    const float* ep = s.EPS + r * ldz;
    const float* y = s.Y + r * ldy;
    float div = 0.0f, ee = 0.0f, yy = 0.0f;
    for (int i = 0; i < nz; ++i) {
      div = fmaf(e[i], ep[i], div);
      ee = fmaf(e[i], e[i], ee);
    }
    for (int o = 0; o < n_out; ++o) yy = fmaf(y[o], y[o], yy);
    s.ST[r * 3 + 0] = div;
    s.ST[r * 3 + 1] = sqrtf(yy + 1e-20f);
    s.ST[r * 3 + 2] = sqrtf(ee + 1e-20f);
  }
  __syncthreads();
}

}  // namespace cnf
