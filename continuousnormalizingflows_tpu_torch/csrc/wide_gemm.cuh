// The product core of the wide paths: C = A B^T over operands in device
// memory, split over output tiles, with an epilogue that the caller supplies
// for every element of C.  K1's and K2's wide paths (fused_dynamics.cu,
// wide_stage_bwd.cuh) run their whole chains through it, the forward
// products of both from wide_stage_fwd.cuh.
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
//   * fp32: true fp32 (no TF32) on the CUDA cores, from the fp32 values.  A
//     thread loads its share of the next kBK-deep slab into registers while
//     the block multiplies the current one, then stores it into the other of
//     two [k][free] buffers; each thread holds a 4 x 4 register tile of
//     outputs, two float4 reads a k.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

inline Product product(const Operand& a, const Operand& b, int M, int N, int K, int epi,
                       long out = 0, int slices = 1) {
  Product p{a, b, M, N, K, epi, out};
  p.tiles_n = (N + kBN - 1) / kBN;
  p.tiles_mn = ((M + kBM - 1) / kBM) * p.tiles_n;
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

// Launches the products of L (L.count of them) as one grid, a block a tile.
template <bool BF16, class Epi>
cudaError_t launch_products(Launch<Epi> L, cudaStream_t stream) {
  int blocks = 0;
  for (int i = 0; i < L.count; ++i) {
    L.first[i] = blocks;
    blocks += L.p[i].tiles_mn * L.p[i].slices;
  }
  wide_products<BF16, Epi><<<blocks, kThreads, 0, stream>>>(L);
  return cudaGetLastError();
}

}  // namespace wide
}  // namespace cnf
