// The backward of one dynamics stage (stage.cuh) for a tile of rows held in
// shared memory, with the weight gradients summed into a per-block
// accumulator: the tiled path of the per-stage backward kernel
// (fused_dynamics_bwd.cu, K2), the whole-solve RK4 backward kernel
// (fused_solve_bwd.cu, K4) and the walk of the adaptive solve's backward
// (fused_adaptive_bwd.cu, K6).  The three take it for nets wider than h = 32,
// or where a block of the row-per-thread path (row_stage_bwd.cuh) does not
// fit in shared memory; narrower nets take that path.  The chain rule below,
// param_count, bwd_grid and the reduction of the partial sums serve both.
//
// The chain is the one of the TPU kernels (pallas_kernels.py _bwd_kernel,
// pallas_solve.py _stage_vjp).  With the forward intermediates of the row
// (stage_fwd_keep below) and the incoming cotangents ybar (n_out), ebar (nz),
// divbar, rzbar, rjbar:
//
//   ybar_t = ybar + rzbar * y / |y|
//   ebar_t = ebar + divbar * eps + rjbar * e_z / |e_z|
//   d1bar = ebar_t A1[:, :nz]^T     u1bar = d1bar * s1   z1_b = d1bar u1 s1 (1 - s1)
//   d2bar = u1bar A2^T              u2bar = d2bar * s2   z2_b = d2bar u2 s2 (1 - s2)
//   epsbar = divbar * e_z + u2bar A3^T
//   z2_t = (ybar_t A3) * s2 + z2_b
//   z1_t = (z2_t A2) * s1 + z1_b
//   xbar = z1_t A1
//   dA1 += z1_t^T x + d1^T ebar_t    db1 += sum z1_t
//   dA2 += z2_t^T h1 + d2^T u1bar    db2 += sum z2_t
//   dA3 += ybar_t^T h2 + eps^T u2bar db3 += sum ybar_t
//
// (weights in nn.Linear layout; the row vectors are the rows of the tile).
// Because the stage's output already holds a first derivative (the probe
// VJP), the chain carries the second-order sigmoid-gate terms z1_b and z2_b.
//
// Weight gradients.  The TPU grid runs in order, so its kernels carry the
// sums across batch tiles in VMEM.  Here blocks run in parallel: each block
// owns one row of a (grid, P) buffer of partial sums (P = the parameter
// count), held in shared memory while it fits (P <= kAccSmemFloats, the
// flagship's 893) and in device memory otherwise.  Each entry of that row is
// owned by one thread, which sums the entry's outer-product terms over the
// tile's rows in order; a second kernel (reduce_partials) adds the rows of
// the buffer in order of block.  No atomics: the same inputs give the same
// bits on every run.
//
// precision: BF16 rounds both operands of every product, the weight-gradient
// outer products included, as the JAX bf16 compute dtype does.
#pragma once

#include "stage.cuh"

namespace cnf {

constexpr long kAccSmemFloats = 4096;  // weight-gradient accumulator kept in shared memory
constexpr int kSMs = 132;              // streaming multiprocessors of an H100
constexpr int kMaxGrid = 2 * kSMs;     // blocks of a tiled backward launch (2 per SM)

// Shared-memory buffers of one backward stage, on top of the forward's.
struct BwdBufs {
  StageBufs f;  // X, S1, H1, S2, H2, Y, E (e_z), EPS, ST (div, |y|, |e_z|)
  float* U1;    // (R, h) u1 = d2 A2, then z1_b, then z1_t
  float* U2;    // (R, h) u2 = eps A3, then z2_b, then z2_t
  float* D1;    // (R, h) d1 = u1 * s1
  float* D2;    // (R, h) d2 = u2 * s2
  float* G1;    // (R, h) u1bar
  float* G2;    // (R, h) u2bar
  float* YB;    // (R, n_out) ybar in, ybar_t after the merge
  float* EB;    // (R, nz)    ebar in, ebar_t after the merge
  float* XB;    // (R, n_in)  xbar
  float* EPB;   // (R, nz)    epsbar
  float* CT;    // (R, 3)     divbar, rzbar, rjbar
};

__host__ __device__ inline long param_count(const Dims& d) {
  return (long)d.h * d.n_in + d.h + (long)d.h * d.h + d.h + (long)d.n_out * d.h + d.n_out;
}

__host__ __device__ inline int bwd_floats_per_row(const Dims& d) {
  return stage_floats_per_row(d) + 6 * odd(d.h) + odd(d.n_out) + 2 * odd(d.nz) + odd(d.n_in) +
         3;
}

__device__ inline float* carve_bwd(float* p, int rows, const Dims& d, BwdBufs& b) {
  p = carve_stage(p, rows, d, b.f);
  const int ldh = b.f.ldh;
  b.U1 = p;  p += rows * ldh;
  b.U2 = p;  p += rows * ldh;
  b.D1 = p;  p += rows * ldh;
  b.D2 = p;  p += rows * ldh;
  b.G1 = p;  p += rows * ldh;
  b.G2 = p;  p += rows * ldh;
  b.YB = p;  p += rows * b.f.ldy;
  b.EB = p;  p += rows * b.f.ldz;
  b.XB = p;  p += rows * b.f.ldx;
  b.EPB = p; p += rows * b.f.ldz;
  b.CT = p;  p += rows * 3;
  return p;
}

// Per-row floats of the whole-solve backward's own RK4 state (fused_solve_bwd.cu):
// the state cotangent and its update (sd each), and u, v1, v2, v3 and epsbar
// of the z columns (nz each).
__host__ __device__ inline int solve_bwd_extra(int sd, int nz) {
  return 2 * odd(sd) + 5 * odd(nz);
}

// Launch plan of a backward kernel: weights staged in shared memory or not,
// accumulator in shared memory or not, rows per tile (0: does not fit).
struct BwdPlan {
  bool staged;
  bool acc_smem;
  int rows;
  int smem_bytes;
  long P;
};

// extra_floats_per_row: the caller's own per-row buffers (K4's RK4 state).
inline BwdPlan make_bwd_plan(const Dims& d, int extra_floats_per_row) {
  const long wf = weight_floats(d);
  const long P = param_count(d);
  const bool staged = 4 * wf <= kStageWeightsBytes;
  const bool acc_smem = P <= kAccSmemFloats;
  const long fixed = (staged ? wf : 0) + (acc_smem ? P : 0);
  const long per_row = bwd_floats_per_row(d) + extra_floats_per_row;
  long rows = (kBlockBudgetBytes / 4 - fixed) / per_row;
  if (rows > kMaxRows) rows = kMaxRows;
  if (rows < 1) rows = 1;
  const long bytes = 4 * (fixed + rows * per_row);
  if (bytes > 227L * 1024) return BwdPlan{staged, acc_smem, 0, 0, P};
  return BwdPlan{staged, acc_smem, (int)rows, (int)bytes, P};
}

inline int bwd_grid(int B, int rows) {
  const long tiles = ((long)B + rows - 1) / rows;
  return tiles < kMaxGrid ? (int)tiles : kMaxGrid;
}

// The cotangent dub of column c of a solve stage's output du = [y, -div, |y|,
// |e_z|] as stage_bwd reads it; ebar = 0 (e_z is not an output of a step).
__device__ __forceinline__ void set_cotangent(const BwdBufs& b, int r, int c, int nz, float dub) {
  if (c < nz) {
    b.YB[r * b.f.ldy + c] = dub;
    b.EB[r * b.f.ldz + c] = 0.0f;
  } else if (c == nz) {
    b.CT[r * 3 + 0] = -dub;
  } else {
    b.CT[r * 3 + (c - nz)] = dub;  // nz + 1 -> |y|, nz + 2 -> |e_z|
  }
}

// The forward of one stage, keeping what the backward reads: s1, h1, s2, h2,
// u1, u2, d1, d2, y, e_z and the reductions.  Reads X and EPS.  Every thread
// of the block must call it; it starts and ends with the block synchronised.
template <bool BF16>
__device__ void stage_fwd_keep(const Dims& d, const Weights& w, const BwdBufs& b, int R) {
  const StageBufs& s = b.f;
  const int h = d.h, n_in = d.n_in, n_out = d.n_out, nz = d.nz;
  const int ldh = s.ldh, ldy = s.ldy, ldz = s.ldz;

  block_mm<BF16>(s.X, s.ldx, R, n_in, w.W1t, h, h, [&](int r, int n, float acc) {
    gates(acc + w.b1[n], s.S1[r * ldh + n], s.H1[r * ldh + n]);
  });
  __syncthreads();
  block_mm<BF16>(s.H1, ldh, R, h, w.W2t, h, h, [&](int r, int n, float acc) {
    gates(acc + w.b2[n], s.S2[r * ldh + n], s.H2[r * ldh + n]);
  });
  __syncthreads();
  block_mm<BF16>(s.H2, ldh, R, h, w.W3t, n_out, n_out, [&](int r, int n, float acc) {
    s.Y[r * ldy + n] = acc + w.b3[n];
  });
  block_mm<BF16>(s.EPS, ldz, R, nz, w.A3, h, h, [&](int r, int n, float acc) {
    b.U2[r * ldh + n] = acc;
    b.D2[r * ldh + n] = s.S2[r * ldh + n] * acc;
  });
  __syncthreads();
  block_mm<BF16>(b.D2, ldh, R, h, w.A2, h, h, [&](int r, int n, float acc) {
    b.U1[r * ldh + n] = acc;
    b.D1[r * ldh + n] = s.S1[r * ldh + n] * acc;
  });
  __syncthreads();
  block_mm<BF16>(b.D1, ldh, R, h, w.A1, n_in, nz, [&](int r, int n, float acc) {
    s.E[r * ldz + n] = acc;
  });
  __syncthreads();
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

// Adds this tile's weight-gradient terms to acc (P floats, this block's row
// of partial sums).  Entry p is always handled by thread p % blockDim.x.
template <bool BF16>
__device__ void accumulate_wgrads(const Dims& d, const BwdBufs& b, int R, float* acc) {
  const StageBufs& s = b.f;
  const int h = d.h, n_in = d.n_in, n_out = d.n_out, nz = d.nz;
  const int ldh = s.ldh, ldx = s.ldx, ldy = s.ldy, ldz = s.ldz;
  const long oB1 = (long)h * n_in, oA2 = oB1 + h, oB2 = oA2 + (long)h * h, oA3 = oB2 + h;
  const long oB3 = oA3 + (long)n_out * h, P = oB3 + n_out;
  for (long p = threadIdx.x; p < P; p += blockDim.x) {
    float s1 = 0.0f, s2 = 0.0f;
    if (p < oB1) {  // dA1[j, i] = sum_r z1_t[j] x[i] + d1[j] ebar_t[i]
      const int j = (int)(p / n_in), i = (int)(p - (long)j * n_in);
      for (int r = 0; r < R; ++r)
        s1 = fmaf(rnd<BF16>(b.U1[r * ldh + j]), rnd<BF16>(s.X[r * ldx + i]), s1);
      if (i < nz)
        for (int r = 0; r < R; ++r)
          s2 = fmaf(rnd<BF16>(b.D1[r * ldh + j]), rnd<BF16>(b.EB[r * ldz + i]), s2);
    } else if (p < oA2) {  // db1[j] = sum_r z1_t[j]
      const int j = (int)(p - oB1);
      for (int r = 0; r < R; ++r) s1 += b.U1[r * ldh + j];
    } else if (p < oB2) {  // dA2[k, j] = sum_r z2_t[k] h1[j] + d2[k] u1bar[j]
      const long q = p - oA2;
      const int k = (int)(q / h), j = (int)(q - (long)k * h);
      for (int r = 0; r < R; ++r) {
        s1 = fmaf(rnd<BF16>(b.U2[r * ldh + k]), rnd<BF16>(s.H1[r * ldh + j]), s1);
        s2 = fmaf(rnd<BF16>(b.D2[r * ldh + k]), rnd<BF16>(b.G1[r * ldh + j]), s2);
      }
    } else if (p < oA3) {  // db2[k] = sum_r z2_t[k]
      const int k = (int)(p - oB2);
      for (int r = 0; r < R; ++r) s1 += b.U2[r * ldh + k];
    } else if (p < oB3) {  // dA3[o, k] = sum_r ybar_t[o] h2[k] + eps[o] u2bar[k]
      const long q = p - oA3;
      const int o = (int)(q / h), k = (int)(q - (long)o * h);
      for (int r = 0; r < R; ++r) {
        s1 = fmaf(rnd<BF16>(b.YB[r * ldy + o]), rnd<BF16>(s.H2[r * ldh + k]), s1);
        s2 = fmaf(rnd<BF16>(s.EPS[r * ldz + o]), rnd<BF16>(b.G2[r * ldh + k]), s2);
      }
    } else {  // db3[o] = sum_r ybar_t[o]
      const int o = (int)(p - oB3);
      for (int r = 0; r < R; ++r) s1 += b.YB[r * ldy + o];
    }
    acc[p] += s1 + s2;
  }
}

// The backward of the stage whose forward stage_fwd_keep just ran.  Reads the
// cotangents from YB (ybar), EB (ebar) and CT; writes XB (the first nxb
// columns of xbar) and EPB, and adds the weight gradients to acc.  Every
// thread of the block must call it; it starts and ends with the block
// synchronised.
template <bool BF16>
__device__ void stage_bwd(const Dims& d, const Weights& w, const BwdBufs& b, int R, int nxb,
                          float* acc) {
  const StageBufs& s = b.f;
  const int h = d.h, n_in = d.n_in, n_out = d.n_out, nz = d.nz;
  const int ldh = s.ldh, ldy = s.ldy, ldz = s.ldz, ldx = s.ldx;

  // merge the cotangents of |y|, |e_z| and div into those of y and e_z
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const float ry = s.ST[r * 3 + 1], re = s.ST[r * 3 + 2];
    const float dv = b.CT[r * 3 + 0], rz = b.CT[r * 3 + 1], rj = b.CT[r * 3 + 2];
    for (int o = 0; o < n_out; ++o) b.YB[r * ldy + o] += rz * s.Y[r * ldy + o] / ry;
    for (int i = 0; i < nz; ++i)
      b.EB[r * ldz + i] = b.EB[r * ldz + i] + dv * s.EPS[r * ldz + i] + rj * s.E[r * ldz + i] / re;
  }
  __syncthreads();

  // probe-VJP path: d1bar = ebar_t A1[:, :nz]^T (the first nz rows of W1t)
  block_mm<BF16>(b.EB, ldz, R, nz, w.W1t, h, h, [&](int r, int n, float a) {
    const int i = r * ldh + n;
    const float sg = s.S1[i];
    b.G1[i] = a * sg;
    b.U1[i] = a * b.U1[i] * sg * (1.0f - sg);
  });
  __syncthreads();
  // d2bar = u1bar A2^T
  block_mm<BF16>(b.G1, ldh, R, h, w.W2t, h, h, [&](int r, int n, float a) {
    const int i = r * ldh + n;
    const float sg = s.S2[i];
    b.G2[i] = a * sg;
    b.U2[i] = a * b.U2[i] * sg * (1.0f - sg);
  });
  __syncthreads();
  // epsbar = divbar e_z + u2bar A3^T
  block_mm<BF16>(b.G2, ldh, R, h, w.W3t, n_out, nz, [&](int r, int n, float a) {
    b.EPB[r * ldz + n] = b.CT[r * 3 + 0] * s.E[r * ldz + n] + a;
  });
  // forward path: z2_t = (ybar_t A3) * s2 + z2_b
  block_mm<BF16>(b.YB, ldy, R, n_out, w.A3, h, h, [&](int r, int n, float a) {
    const int i = r * ldh + n;
    b.U2[i] = a * s.S2[i] + b.U2[i];
  });
  __syncthreads();
  // z1_t = (z2_t A2) * s1 + z1_b
  block_mm<BF16>(b.U2, ldh, R, h, w.A2, h, h, [&](int r, int n, float a) {
    const int i = r * ldh + n;
    b.U1[i] = a * s.S1[i] + b.U1[i];
  });
  __syncthreads();
  // xbar = z1_t A1, and the weight gradients (both only read the tile)
  block_mm<BF16>(b.U1, ldh, R, h, w.A1, n_in, nxb, [&](int r, int n, float a) {
    b.XB[r * ldx + n] = a;
  });
  accumulate_wgrads<BF16>(d, b, R, acc);
  __syncthreads();
}

namespace {

// grads[p] = sum over g of partial[g][p], in order of g.
__global__ void reduce_partials(const float* __restrict__ partial, int G, long P,
                                float* __restrict__ grads) {
  const long p = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float s = 0.0f;
  for (int g = 0; g < G; ++g) s += partial[(long)g * P + p];
  grads[p] = s;
}

inline cudaError_t launch_reduce(const float* partial, int G, long P, float* grads,
                                 cudaStream_t stream) {
  const int threads = 256;
  const long blocks = (P + threads - 1) / threads;
  reduce_partials<<<(unsigned)blocks, threads, 0, stream>>>(partial, G, P, grads);
  return cudaGetLastError();
}

}  // namespace

}  // namespace cnf
