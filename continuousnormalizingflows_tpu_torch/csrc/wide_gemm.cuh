// The product core of the wide paths: C = A B^T over operands in device
// memory, split over output tiles, with an epilogue that the caller supplies
// for every element of C.  K1's and K2's wide paths (fused_dynamics.cu,
// wide_stage_bwd.cuh) run their whole chains through it, the forward
// products of both from wide_stage_fwd.cuh, and so do K3's and K4's
// (wide_solve.cuh).
//
// A launch holds up to kMaxProducts independent products; its blocks are the
// output tiles of all of them, one tile each, so a chain's independent
// products (y and u2, or xbar and the three weight gradients) share one
// launch and fill the card together.  Product q's element (m, n) is
//
//   C[m][n] = sum over k in [0, K) of A(m, k) * B(n, k)
//
// where each operand is read from device memory through an Operand: the free
// index (m or n) runs over the rows or the columns of a row-major matrix, and
// the depth k over the other.  Depth may join two row sets of equal count
// (k < kseg: the first, else the second), which makes a weight gradient of
// two outer-product terms one product of depth 2B; past a set's extent in the
// free index an element reads 0 (the [ebar_t, 0] of dA1).  A product may be
// cut along k into slices, each written to its own partial row, that the
// caller then adds in a fixed order.
//
// Every tile is owned by one block, which sums over k in a fixed order, so
// the same inputs give the same bits on every run.  No atomics.
//
// The two precisions read different operands:
//   * bf16 (BF16 = true): the operands are bfloat16 copies (rounded to
//     nearest even from the fp32 values, as the plain version's _round_bf16)
//     whose rows are padded to a multiple of 8 elements and zero in the
//     padding.  cp.async copies each kBK16-deep slab, 16 bytes a copy, into
//     one of kStages shared buffers as it lies in device memory, kStages - 1
//     slabs ahead of the one being multiplied; ldmatrix (.trans for an
//     operand whose free index runs along its rows) feeds
//     mma.sync.m16n8k16 (bf16 in, fp32 accumulate).  A copy is whole or
//     zero: one that starts inside an operand reads its padding, whose
//     zeros (or those of the other operand at the same depth, or an output
//     column the epilogue drops) keep the sum exact.  Four warps, each a
//     32 x 16 piece of the 64 x 32 tile.
//   * fp32: true fp32 (no TF32) on the CUDA cores, from the fp32 values,
//     each output's depth summed in order, one fmaf a term.  What bounds it
//     on an H100 is instruction slots: an SM starts four warp instructions a clock, and
//     every shared-memory read, copy, address and barrier takes a slot from
//     the FMAs.  The first design (64 x 32 output tiles of 128 threads, a 4 x
//     4 register tile a thread, 32-deep slabs staged through registers into
//     two [k][free] buffers) spent two float4 reads on 16 FMAs and a store
//     and a barrier between slabs: 18.5 TFLOP/s of the 67 peak on a 8,192 x
//     352 x 352 product, 15.5 at N = 87.  The Hopper tiles (F32Tile: 128 x 96
//     or 64 x 96 outputs of 256 threads, 8 x 6 or 4 x 6 a thread) read 3.5
//     float4s for 48 FMAs.  cp.async copies each kF32BK-deep slab of both
//     operands into shared memory as it lies in device memory, 16 bytes a
//     copy (4 where a row is not 16-byte aligned), kF32Stages slabs in a ring
//     of dynamic shared memory, with no registers between and no transpose:
//     an operand whose rows run along k lands [free][k] and is read a float4
//     of four depths a row (its rows ty + TY i, so that a warp reads 4 or 8
//     neighbouring rows, on distinct banks), one whose rows run along the
//     free index lands [k][free] and is read a float4 of four rows a depth.
//     An early form that transposed the first kind with 4-byte copies spent
//     as long copying as multiplying.  The outputs go through shared memory
//     to the epilogue, a warp taking 32 neighbouring columns of a row: each
//     element's loads there wait in turn for device memory, and a thread of
//     the first layout's stride-4 columns waited for four times the sectors.
//     A launch takes a Hopper tile where its padded FMAs take the least time
//     at its measured rate and its grid fills the card (choose_f32): wide
//     products at a large batch; the first design's tile, unchanged, takes
//     narrow products, small grids and small weight gradients.  A launch's
//     products share its tile.  One block an SM, where the grid is short,
//     pays off only on deep products: the epilogue's waits and the first
//     slab's are then the block's alone to hide.
//     Every tile adds the same terms in the same order, so it gives the first
//     design's bits wherever the slices of K are the same: 22-30 TFLOP/s on
//     the 8,192-row products 352 wide, 18-20 at 87 wide, where cuBLAS's sgemm
//     runs 28-37 and 24 (chip_profile.py wide-f32, PERF.md section 6).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cnf {
namespace wide {

constexpr int kBM = 64;        // rows of an output tile
constexpr int kBN = 32;        // columns of an output tile
constexpr int kBK = 32;        // depth of an fp32 slab
constexpr int kBK16 = 64;      // depth of a bf16 slab
constexpr int kSliceK = 64;    // slices of K are multiples of it
constexpr int kThreads = 128;  // four warps
constexpr int kStages = 3;     // bf16: slabs in flight
constexpr int kMaxProducts = 4;
constexpr int kSMs = 132;      // an H100's SMs

using bf16 = __nv_bfloat16;

// bf16 rows in device memory are padded to a multiple of this many elements.
__host__ __device__ inline int pad8(int w) { return (w + 7) & ~7; }

// One operand, element (f, k): set s = (k >= kseg), row k' = k - s * kseg;
// kmajor: p[s][f * ld[s] + k'], else p[s][k' * ld[s] + f]; 0 for f >= ext[s].
// p points at floats for an fp32 product, at bf16 for a bf16 one.
struct Operand {
  const void* p[2];
  int ld[2];
  int ext[2];
  int kseg;
  int kmajor;
};

// Free index over the rows of a row-major (rows, ld) matrix, k over its columns.
inline Operand by_row(const void* p, int ld, int ext) {
  return Operand{{p, p}, {ld, ld}, {ext, ext}, 1 << 30, 1};
}

// Free index over the columns, k over the rows.
inline Operand by_col(const void* p, int ld, int ext) {
  return Operand{{p, p}, {ld, ld}, {ext, ext}, 1 << 30, 0};
}

// By columns, k over the rows of p0 (kseg of them), then over those of p1.
inline Operand by_col2(const void* p0, int ld0, int ext0, const void* p1, int ld1, int ext1,
                       int kseg) {
  return Operand{{p0, p1}, {ld0, ld1}, {ext0, ext1}, kseg, 0};
}

struct Product {
  Operand a, b;
  int M, N, K;
  int epi;       // the caller's epilogue case
  long out;      // the caller's output offset
  int tiles_n;   // tiles across N
  int tiles_mn;  // output tiles
  int slices;    // cuts of K, each to its own partial
  int kslice;    // depth of a slice, a multiple of kSliceK
};

// Sets the product's output tiles for tiles of bm x bn.
inline void tile_over(Product& p, int bm, int bn) {
  p.tiles_n = (p.N + bn - 1) / bn;
  p.tiles_mn = ((p.M + bm - 1) / bm) * p.tiles_n;
}

inline Product product(const Operand& a, const Operand& b, int M, int N, int K, int epi,
                       long out = 0, int slices = 1) {
  Product p{a, b, M, N, K, epi, out};
  tile_over(p, kBM, kBN);
  const int per = (K + slices - 1) / slices;
  p.kslice = (per + kSliceK - 1) / kSliceK * kSliceK;
  p.slices = (K + p.kslice - 1) / p.kslice;
  return p;
}

template <class Epi>
struct Launch {
  Product p[kMaxProducts];
  int first[kMaxProducts];  // first block of each product
  int count;
  Epi epi;
};

// One row set of an operand over depth rows [.., end): element (f, r) at
// p[f * ld + r] (kmajor) or p[r * ld + f]; 0 for f >= ext or r >= end.
struct Set {
  const void* p;
  long ld;
  int ext, end, kmajor;
};

__device__ __forceinline__ Set set_of(const Operand& o, int s, int end) {
  return s ? Set{o.p[1], o.ld[1], o.ext[1], end, o.kmajor}
           : Set{o.p[0], o.ld[0], o.ext[0], end, o.kmajor};
}

// ---- bf16: cp.async, ldmatrix, mma.sync ----

// Row strides of the bf16 tiles: [free][k] (kmajor) rows of kBK16 + 8, [k][free]
// rows of R + 8; 144 or 80 bytes, so the 8 rows an ldmatrix phase reads fall on
// distinct banks.
constexpr int kLdK16 = kBK16 + 8;
template <int R>
__host__ __device__ constexpr int ld_f16() { return R + 8; }
template <int R>
__host__ __device__ constexpr int tile16() {
  return R * kLdK16 > kBK16 * ld_f16<R>() ? R * kLdK16 : kBK16 * ld_f16<R>();
}
constexpr int kStage16 = tile16<kBM>() + tile16<kBN>();

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies the R x kBK16 slab of set o at free rows [f0, f0 + R), depth rows
// [r, r + kBK16) into tile as it lies in device memory, [free][k] (kmajor) or
// [k][free], 8 elements a copy; a copy that starts outside the set writes
// zeros.
template <int R>
__device__ __forceinline__ void copy_slab16(const Set& o, bf16* tile, int f0, int r) {
  const bf16* p = static_cast<const bf16*>(o.p);
  const int t = threadIdx.x;
  if (o.kmajor) {
#pragma unroll
    for (int c = t; c < R * kBK16 / 8; c += kThreads) {
      const int f = c / (kBK16 / 8), k = (c % (kBK16 / 8)) * 8;
      const bool in = f0 + f < o.ext && r + k < o.end;
      cp_async16(tile + f * kLdK16 + k, in ? p + (long)(f0 + f) * o.ld + r + k : p, 16 * in);
    }
  } else {
#pragma unroll
    for (int c = t; c < kBK16 * R / 8; c += kThreads) {
      const int k = c / (R / 8), f = (c % (R / 8)) * 8;
      const bool in = r + k < o.end && f0 + f < o.ext;
      cp_async16(tile + k * ld_f16<R>() + f, in ? p + (long)(r + k) * o.ld + f0 + f : p, 16 * in);
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One slab's products of a warp: its 32 x 16 piece of the tile, rows wm and
// columns wn on.  AK, BK: the two tiles' layouts (kmajor), fixed a product.
// The fragments as mma.m16n8k16 lays them out: A's four 8 x 8 blocks (rows
// lo/hi x depth lo/hi), B's two (depth lo/hi) of each 8-column half.
template <bool AK, bool BK>
__device__ __forceinline__ void mma_slab(const bf16* at, const bf16* bt, int wm, int wn,
                                         int lane, float (&acc)[2][2][4]) {
#pragma unroll
  for (int ks = 0; ks < kBK16; ks += 16) {
    uint32_t a[2][4], b[4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int m = wm + mi * 16;
      if constexpr (AK)
        ldmatrix_x4(a[mi], at + (m + (lane & 15)) * kLdK16 + ks + (lane >> 4) * 8);
      else
        ldmatrix_x4_trans(a[mi], at + (ks + (lane & 7) + ((lane >> 4) << 3)) * ld_f16<kBM>() +
                                     m + ((lane >> 3) & 1) * 8);
    }
    if constexpr (BK)
      ldmatrix_x4(b, bt + (wn + (lane & 7) + ((lane >> 4) << 3)) * kLdK16 + ks +
                         ((lane >> 3) & 1) * 8);
    else
      ldmatrix_x4_trans(b, bt + (ks + (lane & 7) + ((lane >> 3) & 1) * 8) * ld_f16<kBN>() + wn +
                               (lane >> 4) * 8);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) mma_bf16(acc[mi][ni], a[mi], b[2 * ni], b[2 * ni + 1]);
  }
}

// ---- fp32: register staging, FMA ----

// A thread's share of an R x kBK slab.  Neighbouring threads take
// neighbouring addresses of the operand's row-major matrix: for a kmajor
// operand thread t holds (f, k) = (t / kBK + i kThreads / kBK, t % kBK), else
// (t % R, t / R + i kThreads / R), element i of kPer.
template <int R>
struct Slab {
  static constexpr int kPer = R * kBK / kThreads;
  static constexpr int kFStep = kThreads / kBK;  // kmajor: f between a thread's elements
  static constexpr int kKStep = kThreads / R;    // else: k between them
  float v[kPer];

  // the slab of depth rows [r, r + kBK) of set o, free rows [f0, f0 + R)
  __device__ __forceinline__ void load(const Set& o, int f0, int r) {
    const float* p = static_cast<const float*>(o.p);
    const int t = threadIdx.x;
    if (o.kmajor) {
      const int f = f0 + t / kBK, k = r + t % kBK;
      const float* q = p + (long)f * o.ld + k;
      const bool in = k < o.end;
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        v[i] = in && f + i * kFStep < o.ext ? q[(long)i * kFStep * o.ld] : 0.0f;
    } else {
      const int f = f0 + t % R, k = r + t / R;
      const float* q = p + (long)k * o.ld + f;
      const bool in = f < o.ext;
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        v[i] = in && k + i * kKStep < o.end ? q[(long)i * kKStep * o.ld] : 0.0f;
    }
  }

  // into a [kBK][R + 4] tile
  __device__ __forceinline__ void store(int kmajor, float* tile) const {
    const int t = threadIdx.x;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int f = kmajor ? t / kBK + i * kFStep : t % R;
      const int k = kmajor ? t % kBK : t / R + i * kKStep;
      tile[k * (R + 4) + f] = v[i];
    }
  }
};

constexpr int kSmemB16 = kStages * kStage16 * 2;
constexpr int kSmemF32 = 2 * kBK * ((kBM + 4) + (kBN + 4)) * 4;
constexpr int kSmem = kSmemB16 > kSmemF32 ? kSmemB16 : kSmemF32;

template <bool BF16, class Epi>
__global__ void __launch_bounds__(kThreads)
wide_products(const __grid_constant__ Launch<Epi> L) {
  __shared__ __align__(16) unsigned char smem[kSmem];
  int q = 0;
#pragma unroll
  for (int i = 1; i < kMaxProducts; ++i)
    if (i < L.count && (int)blockIdx.x >= L.first[i]) q = i;
  const Product P = L.p[q];
  int t = blockIdx.x - L.first[q];
  const int slice = t / P.tiles_mn;
  t -= slice * P.tiles_mn;
  const int m0 = (t / P.tiles_n) * kBM, n0 = (t % P.tiles_n) * kBN;
  // the block's depth [kbeg, kend) as rows of the first set, then of the second
  constexpr int BK = BF16 ? kBK16 : kBK;
  const int kbeg = slice * P.kslice;
  const int kend = min(P.K, kbeg + P.kslice);
  const int seg = P.a.kseg;
  const int end0 = min(kend, seg), beg1 = max(kbeg, seg) - seg, end1 = kend - seg;
  const int slabs0 = kbeg < end0 ? (end0 - kbeg + BK - 1) / BK : 0;
  const int slabs = slabs0 + (beg1 < end1 ? (end1 - beg1 + BK - 1) / BK : 0);
  // slab j of the block's depth: its set, first depth row and end
  auto slab = [&](int j, int& s, int& r, int& end) {
    s = j >= slabs0;
    r = s ? beg1 + (j - slabs0) * BK : kbeg + j * BK;
    end = s ? end1 : end0;
  };

  if constexpr (BF16) {
    bf16* tiles = reinterpret_cast<bf16*>(smem);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 16;
    auto issue = [&](int j) {  // slab j into stage j % kStages
      bf16* st = tiles + (j % kStages) * kStage16;
      int s, r, end;
      slab(j, s, r, end);
      copy_slab16<kBM>(set_of(P.a, s, end), st, m0, r);
      copy_slab16<kBN>(set_of(P.b, s, end), st + tile16<kBM>(), n0, r);
    };
    float acc[2][2][4] = {};
#pragma unroll
    for (int j = 0; j < kStages - 1; ++j) {
      if (j < slabs) issue(j);
      cp_commit();
    }
    for (int j = 0; j < slabs; ++j) {
      cp_wait<kStages - 2>();
      __syncthreads();  // slab j has landed, and every warp is done with slab j - 1
      if (j + kStages - 1 < slabs) issue(j + kStages - 1);
      cp_commit();
      const bf16* at = tiles + (j % kStages) * kStage16;
      const bf16* bt = at + tile16<kBM>();
      if (P.a.kmajor) {
        if (P.b.kmajor) mma_slab<true, true>(at, bt, wm, wn, lane, acc);
        else mma_slab<true, false>(at, bt, wm, wn, lane, acc);
      } else {
        if (P.b.kmajor) mma_slab<false, true>(at, bt, wm, wn, lane, acc);
        else mma_slab<false, false>(at, bt, wm, wn, lane, acc);
      }
    }
    cp_wait<0>();
    const int g = lane >> 2, c = (lane & 3) * 2;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + wm + mi * 16 + g + (e >> 1) * 8;
          const int n = n0 + wn + ni * 8 + c + (e & 1);
          if (m < P.M && n < P.N) L.epi(P, slice, m, n, acc[mi][ni][e]);
        }
  } else {
    Slab<kBM> sa;
    Slab<kBN> sb;
    auto load = [&](int j) {  // slab j into registers
      int s, r, end;
      slab(j, s, r, end);
      sa.load(set_of(P.a, s, end), m0, r);
      sb.load(set_of(P.b, s, end), n0, r);
    };
    float* As = reinterpret_cast<float*>(smem);  // [2][kBK][kBM + 4]
    float* Bs = As + 2 * kBK * (kBM + 4);       // [2][kBK][kBN + 4]
    const int tm = (threadIdx.x >> 3) * 4, tn = (threadIdx.x & 7) * 4;
    float acc[4][4] = {};
    load(0);
    sa.store(P.a.kmajor, As);
    sb.store(P.b.kmajor, Bs);
    __syncthreads();
    for (int j = 0; j < slabs; ++j) {
      const int buf = j & 1;
      if (j + 1 < slabs) load(j + 1);
      const float* at = As + buf * kBK * (kBM + 4) + tm;
      const float* bt = Bs + buf * kBK * (kBN + 4) + tn;
#pragma unroll 8
      for (int k = 0; k < kBK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(at + k * (kBM + 4));
        const float4 b = *reinterpret_cast<const float4*>(bt + k * (kBN + 4));
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
      }
      if (j + 1 < slabs) {
        sa.store(P.a.kmajor, As + (buf ^ 1) * kBK * (kBM + 4));
        sb.store(P.b.kmajor, Bs + (buf ^ 1) * kBK * (kBN + 4));
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int m = m0 + tm + i, n = n0 + tn + jj;
        if (m < P.M && n < P.N) L.epi(P, slice, m, n, acc[i][jj]);
      }
  }
}

// ---- fp32 on Hopper: cp.async ring, 8 x 6 / 4 x 6 register tiles, FMA ----

constexpr int kF32BK = 32;     // depth of an fp32 slab
constexpr int kF32Stages = 2;  // slabs in the ring: 64.5 KB at 128 x 96

// Shared floats of an R-row operand's slab: [free][k] rows of kF32BK + 4 for
// an operand whose rows run along k (kmajor), [k][free] rows of R + 4 else.
template <int R>
__host__ __device__ constexpr int slab32() {
  return R * (kF32BK + 4) > kF32BK * (R + 4) ? R * (kF32BK + 4) : kF32BK * (R + 4);
}

// A tile of BM x BN outputs, TM x TN a thread; TX x TY threads, 8 x 4 a warp.
// A thread's rows: over a [free][k] slab ty + TY i, so that a warp's 4 rows
// are neighbours; over a [k][free] slab ty * 4 + [0, 4) and, for TM = 8, 4 TY
// more, so that its reads are float4s.  Its columns the same way, with tx,
// TX and the group of TN - 4 at 4 TX + tx (TN - 4).
template <int BM_, int BN_, int TM_, int TN_>
struct F32Tile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_;
  static constexpr int TX = BN / TN, TY = BM / TM;
  static constexpr int kThreads = TX * TY;
  static constexpr int kStage = slab32<BM>() + slab32<BN>();
  static constexpr int kSmem = kF32Stages * kStage * 4;  // bytes
  static_assert(TX % 8 == 0 && TY % 4 == 0 && (TM == 4 || TM == 8) && TN >= 4 && TN <= 8 &&
                TN % 2 == 0, "a warp is 8 x 4 threads, a thread's groups float4 and float2/4");

  // row i of thread ty (T = TY, W = TM) or column j of tx (TX, TN)
  template <int T, int W, bool KMajor>
  __device__ __forceinline__ static int index(int t, int i) {
    if constexpr (KMajor) return t + T * i;
    return i < 4 ? t * 4 + i : 4 * T + t * (W - 4) + i - 4;
  }
};

// The tiles of an fp32 launch, largest first; the last is the first design's
// 64 x 32 (wide_products<false, Epi>).
using F32Wide = F32Tile<128, 96, 8, 6>;
using F32Half = F32Tile<64, 96, 4, 6>;
constexpr int kF32Tiles = 3;
constexpr int kF32Shape[kF32Tiles][2] = {{F32Wide::BM, F32Wide::BN}, {F32Half::BM, F32Half::BN},
                                         {kBM, kBN}};

// The least blocks of an fp32 launch on a Hopper tile: 9 SMs in 10 busy.
constexpr int kFillBlocks = kSMs * 9 / 10;
// The least depth at which one block an SM keeps a Hopper tile ahead; below
// it the grid has to give those SMs both their blocks (twice kFillBlocks).
constexpr int kDeepK = 256;
// Each tile's TFLOP/s on an 8,192 x 352 x 352 product (PERF.md section 6).
constexpr int kF32Rate[kF32Tiles] = {29, 26, 18};

// Products launched on each tile since the library loaded (cnf_wide_f32_tally).
inline std::atomic<long long> f32_tally[kF32Tiles];

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

// Copies the R x kF32BK slab of set o at free rows [f0, f0 + R), depth rows
// [r, r + kF32BK) into tile as it lies in device memory: [free][k] rows of
// kF32BK + 4 (KMajor, o's rows run along k) or [k][free] rows of R + 4.  16
// bytes a copy where the set's rows and r are 16-byte aligned, else 4 (a
// slower path, kept from holding registers across the depth loop); elements
// past the set's extent or end read 0.
template <int R, int NT, bool KMajor>
__device__ __forceinline__ void copy_slab32(const Set& o, float* tile, int f0, int r) {
  constexpr int BK = kF32BK;
  const float* p = static_cast<const float*>(o.p);
  const int t = threadIdx.x;
  const bool wide = ((reinterpret_cast<uintptr_t>(p) | (uintptr_t)o.ld * 4 | (KMajor ? r * 4 : 0)) &
                     15) == 0;
  if constexpr (KMajor) {
    constexpr int L = BK + 4;
    if (wide) {
#pragma unroll
      for (int c = t; c < R * BK / 4; c += NT) {
        const int f = c / (BK / 4), k = (c % (BK / 4)) * 4;
        const int n = f0 + f < o.ext ? max(0, min(4, o.end - r - k)) : 0;
        cp_async16(tile + f * L + k, n ? p + (long)(f0 + f) * o.ld + r + k : p, 4 * n);
      }
    } else {
#pragma unroll 1
      for (int c = t; c < R * BK; c += NT) {
        const int f = c / BK, k = c % BK;
        const bool in = f0 + f < o.ext && r + k < o.end;
        cp_async4(tile + f * L + k, in ? p + (long)(f0 + f) * o.ld + r + k : p, 4 * in);
      }
    }
  } else {
    constexpr int L = R + 4;
    if (wide) {
#pragma unroll
      for (int c = t; c < BK * R / 4; c += NT) {
        const int k = c / (R / 4), f = (c % (R / 4)) * 4;
        const int n = r + k < o.end ? max(0, min(4, o.ext - f0 - f)) : 0;
        cp_async16(tile + k * L + f, n ? p + (long)(r + k) * o.ld + f0 + f : p, 4 * n);
      }
    } else {
#pragma unroll 1
      for (int c = t; c < BK * R; c += NT) {
        const int k = c / R, f = c % R;
        const bool in = r + k < o.end && f0 + f < o.ext;
        cp_async4(tile + k * L + f, in ? p + (long)(r + k) * o.ld + f0 + f : p, 4 * in);
      }
    }
  }
}

// W values of a thread at depth k of a [k][free] slab (rows of R + 4 floats):
// a float4 at t * 4, and W - 4 more at 4 T + t (W - 4).
template <int R, int T, int W>
__device__ __forceinline__ void by_depth(const float* tile, int k, int t, float* v) {
  const float* row = tile + k * (R + 4);
  const float4 x = *reinterpret_cast<const float4*>(row + t * 4);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  if constexpr (W == 8) {
    const float4 y = *reinterpret_cast<const float4*>(row + 4 * T + t * 4);
    v[4] = y.x, v[5] = y.y, v[6] = y.z, v[7] = y.w;
  } else if constexpr (W == 6) {
    const float2 y = *reinterpret_cast<const float2*>(row + 4 * T + t * 2);
    v[4] = y.x, v[5] = y.y;
  }
}

// Depths 4 q ... 4 q + 3 of free row f of a [free][k] slab.
__device__ __forceinline__ float4 by_free(const float* tile, int f, int q) {
  return *reinterpret_cast<const float4*>(tile + f * (kF32BK + 4) + 4 * q);
}

// One slab's FMAs of a thread: acc[i][j] += A(row i, k) B(column j, k) for k
// in order.  AK, BK: the two slabs' layouts ([free][k] when true).  Four
// depths at a time: the operand read along k gives a float4 a row, the other
// its values at each of the four depths; each output still adds its terms
// one depth after another.
template <class Tl, bool AK, bool BK>
__device__ __forceinline__ void fma_slab(const float* at, const float* bt, int tx, int ty,
                                         float (&acc)[Tl::TM][Tl::TN]) {
  constexpr int TM = Tl::TM, TN = Tl::TN;
#pragma unroll
  for (int q = 0; q < kF32BK / 4; ++q) {
    if constexpr (!AK && !BK) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float a[TM], b[TN];
        by_depth<Tl::BM, Tl::TY, TM>(at, 4 * q + kk, ty, a);
        by_depth<Tl::BN, Tl::TX, TN>(bt, 4 * q + kk, tx, b);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    } else if constexpr (AK) {
      float b[4][TN];  // B at the four depths
      if constexpr (BK) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const float4 x = by_free(bt, tx + Tl::TX * j, q);
          b[0][j] = x.x, b[1][j] = x.y, b[2][j] = x.z, b[3][j] = x.w;
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) by_depth<Tl::BN, Tl::TX, TN>(bt, 4 * q + kk, tx, b[kk]);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 x = by_free(at, ty + Tl::TY * i, q);
        const float a[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int j = 0; j < TN; ++j)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) acc[i][j] = fmaf(a[kk], b[kk][j], acc[i][j]);
      }
    } else {  // B along k, A by depth
      float a[4][TM];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) by_depth<Tl::BM, Tl::TY, TM>(at, 4 * q + kk, ty, a[kk]);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 x = by_free(bt, tx + Tl::TX * j, q);
        const float b[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) acc[i][j] = fmaf(a[kk][i], b[kk], acc[i][j]);
      }
    }
  }
}

// The whole depth of a block on layouts AK, BK, then the epilogue.
template <class Tl, bool AK, bool BK, class Epi>
__device__ __forceinline__ void f32_block(const Launch<Epi>& L, const Product& P, float* smem,
                                          int slice, int m0, int n0) {
  constexpr int BK_ = kF32BK, S = kF32Stages;
  const int kbeg = slice * P.kslice;
  const int kend = min(P.K, kbeg + P.kslice);
  const int seg = P.a.kseg;
  const int end0 = min(kend, seg), beg1 = max(kbeg, seg) - seg, end1 = kend - seg;
  const int slabs0 = kbeg < end0 ? (end0 - kbeg + BK_ - 1) / BK_ : 0;
  const int slabs = slabs0 + (beg1 < end1 ? (end1 - beg1 + BK_ - 1) / BK_ : 0);
  auto fetch = [&](int j) {  // slab j into stage j % S
    const int s = j >= slabs0;
    const int r = s ? beg1 + (j - slabs0) * BK_ : kbeg + j * BK_;
    const int end = s ? end1 : end0;
    float* st = smem + (j % S) * Tl::kStage;
    copy_slab32<Tl::BM, Tl::kThreads, AK>(set_of(P.a, s, end), st, m0, r);
    copy_slab32<Tl::BN, Tl::kThreads, BK>(set_of(P.b, s, end), st + slab32<Tl::BM>(), n0, r);
  };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tx = (warp % (Tl::TX / 8)) * 8 + (lane & 7);
  const int ty = (warp / (Tl::TX / 8)) * 4 + (lane >> 3);
  float acc[Tl::TM][Tl::TN] = {};
#pragma unroll
  for (int j = 0; j < S - 1; ++j) {
    if (j < slabs) fetch(j);
    cp_commit();
  }
  for (int j = 0; j < slabs; ++j) {
    cp_wait<S - 2>();
    __syncthreads();  // slab j has landed, and every warp is done with slab j - 1
    if (j + S - 1 < slabs) fetch(j + S - 1);
    cp_commit();
    const float* at = smem + (j % S) * Tl::kStage;
    fma_slab<Tl, AK, BK>(at, at + slab32<Tl::BM>(), tx, ty, acc);
  }
  // the outputs through shared memory, so that a warp's epilogue takes 32
  // neighbouring columns of a row, whatever the layouts gave each thread
  constexpr int LC = Tl::BN + 8;  // rows of the tile: a warp's 4 rows on other banks
  static_assert(Tl::BM * LC <= kF32Stages * Tl::kStage, "the tile fits the ring");
  cp_wait<0>();
  __syncthreads();  // every warp is done with the ring
#pragma unroll
  for (int i = 0; i < Tl::TM; ++i)
#pragma unroll
    for (int j = 0; j < Tl::TN; ++j)
      smem[Tl::template index<Tl::TY, Tl::TM, AK>(ty, i) * LC +
           Tl::template index<Tl::TX, Tl::TN, BK>(tx, j)] = acc[i][j];
  __syncthreads();
  for (int e = threadIdx.x; e < Tl::BM * Tl::BN; e += Tl::kThreads) {
    const int r = e / Tl::BN, c = e % Tl::BN;
    const int m = m0 + r, n = n0 + c;
    if (m < P.M && n < P.N) L.epi(P, slice, m, n, smem[r * LC + c]);
  }
}

// The fp32 products of L on tiles of Tl.  Its blocks, their depth and slabs
// as wide_products<false, Epi>'s, on the tile's own grid.
template <class Tl, class Epi>
__global__ void __launch_bounds__(Tl::kThreads, 2)
wide_products(const __grid_constant__ Launch<Epi> L) {
  extern __shared__ __align__(16) float smem[];
  int q = 0;
#pragma unroll
  for (int i = 1; i < kMaxProducts; ++i)
    if (i < L.count && (int)blockIdx.x >= L.first[i]) q = i;
  const Product& P = L.p[q];
  int t = blockIdx.x - L.first[q];
  const int slice = t / P.tiles_mn;
  t -= slice * P.tiles_mn;
  const int m0 = (t / P.tiles_n) * Tl::BM, n0 = (t % P.tiles_n) * Tl::BN;
  if (P.a.kmajor) {
    if (P.b.kmajor) f32_block<Tl, true, true>(L, P, smem, slice, m0, n0);
    else f32_block<Tl, true, false>(L, P, smem, slice, m0, n0);
  } else {
    if (P.b.kmajor) f32_block<Tl, false, true>(L, P, smem, slice, m0, n0);
    else f32_block<Tl, false, false>(L, P, smem, slice, m0, n0);
  }
}

// Output blocks of L's products on tile i, and the FMAs of those blocks,
// padding and all, over the tile's rate: the launch's time there, to a
// factor.
template <class Epi>
long blocks_on(const Launch<Epi>& L, int i, double* cost = nullptr) {
  long blocks = 0;
  double fma = 0.0;
  for (int q = 0; q < L.count; ++q) {
    Product p = L.p[q];
    tile_over(p, kF32Shape[i][0], kF32Shape[i][1]);
    blocks += (long)p.tiles_mn * p.slices;
    fma += (double)p.tiles_mn * kF32Shape[i][0] * kF32Shape[i][1] * p.K;
  }
  if (cost) *cost = fma / kF32Rate[i];
  return blocks;
}

// Whether a grid of `blocks` Hopper blocks over products of least depth
// `depth` fills the card: both blocks of 9 SMs in 10, or one where deep.
inline bool fills(long blocks, int depth) {
  return blocks >= 2 * kFillBlocks || (blocks >= kFillBlocks && depth >= kDeepK);
}

// The tile (an index of kF32Shape) of an fp32 launch: the first design's,
// unless a Hopper tile whose grid fills the card does its padded FMAs at
// its rate in under nine tenths of the time (the rates come from one
// shape), and then the quickest such.  Wide products at a large batch take
// a Hopper tile; narrow ones (a ragged edge of most of a tile), small grids
// and small weight gradients the first design's.
template <class Epi>
int choose_f32(const Launch<Epi>& L) {
  int best = kF32Tiles - 1, depth = L.p[0].K;
  for (int q = 1; q < L.count; ++q) depth = min(depth, L.p[q].K);
  double limit, cost;
  blocks_on(L, best, &limit);
  limit *= 0.9;
  for (int i = 0; i + 1 < kF32Tiles; ++i)
    if (fills(blocks_on(L, i, &cost), depth) && cost < limit) {
      best = i;
      limit = cost;
    }
  return best;
}

template <class Tl, class Epi>
cudaError_t launch_tile(const Launch<Epi>& L, int blocks, cudaStream_t stream) {
  if (Tl::kSmem > 48 * 1024) {  // past the default: asked for once on each device
    static std::atomic<unsigned long long> asked{0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = 1ull << (dev & 63);
    if (!(asked.load() & bit)) {
      err = cudaFuncSetAttribute(wide_products<Tl, Epi>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::kSmem);
      if (err != cudaSuccess) return err;
      asked |= bit;
    }
  }
  wide_products<Tl, Epi><<<blocks, Tl::kThreads, Tl::kSmem, stream>>>(L);
  return cudaGetLastError();
}

// Launches the products of L as one grid of the fp32 tile `tile` (an index
// of kF32Shape), a block a tile.
template <class Epi>
cudaError_t launch_f32(Launch<Epi> L, int tile, cudaStream_t stream) {
  const int bm = kF32Shape[tile][0], bn = kF32Shape[tile][1];
  int blocks = 0;
  for (int i = 0; i < L.count; ++i) {
    tile_over(L.p[i], bm, bn);
    L.first[i] = blocks;
    blocks += L.p[i].tiles_mn * L.p[i].slices;
  }
  f32_tally[tile] += L.count;
  if (tile == kF32Tiles - 1) {
    wide_products<false, Epi><<<blocks, kThreads, 0, stream>>>(L);
    return cudaGetLastError();
  }
  return tile == 0 ? launch_tile<F32Wide>(L, blocks, stream)
                   : launch_tile<F32Half>(L, blocks, stream);
}

// Launches the products of L (L.count of them) as one grid, a block a tile:
// bf16 on 64 x 32 tiles, fp32 on choose_f32's.
template <bool BF16, class Epi>
cudaError_t launch_products(Launch<Epi> L, cudaStream_t stream) {
  if constexpr (!BF16) {
    return launch_f32(L, choose_f32(L), stream);
  } else {
    int blocks = 0;
    for (int i = 0; i < L.count; ++i) {
      L.first[i] = blocks;
      blocks += L.p[i].tiles_mn * L.p[i].slices;
    }
    wide_products<true, Epi><<<blocks, kThreads, 0, stream>>>(L);
    return cudaGetLastError();
  }
}

}  // namespace wide
}  // namespace cnf
