// One dynamics stage and its backward for the rows of one CTA of a thread
// block cluster, and the weight gradient of a stage as products over the
// cluster's rows: the stages of K5's and K6's cluster path
// (cluster_adaptive.cuh), for 32 < h <= 128.
//
// The arithmetic of every element is that of stage.cuh and stage_bwd.cuh:
// each product sums over k in order, one fp32 FMA a term, from 0, and the
// epilogues are theirs, so a stage here gives the bits of stage_fwd,
// stage_fwd_keep and stage_bwd on the same row, and K5 on this path the bits
// of K5 on the tiled path.  What differs is where the operands live and
// which thread takes which outputs:
//   * the weights are one copy in shared memory, in nn.Linear layout with odd
//     row strides (the weight image, which cluster_adaptive.cuh loads with
//     TMA); the products that stage.cuh reads from the (in, out) transposes
//     read the image transposed.  Where the image does not fit beside the
//     rows (Res = false), the products read the device-memory weights and
//     their transposes, as stage.cuh does;
//   * a thread's 4 output columns are c, c + nq, c + 2 nq and c + 3 nq (nq =
//     N / 4 rounded up), so the 32 lanes of a warp load 32 neighbouring
//     columns of a row-major operand, or 32 rows of odd stride of a
//     transposed one: no two lanes share a bank (stage.cuh's 4 neighbouring
//     columns a thread put 4 lanes on a bank);
//   * a thread's tile has 4, 2 or 1 rows, chosen per product, so that the
//     narrow products (N = nz) and the few rows of a CTA still give every
//     thread work.
#pragma once

#include <cooperative_groups.h>

#include "stage_bwd.cuh"

namespace cnf {

// The weights as the cluster path's products read them.
struct CWeights {
  const float* A1;  // (h, n_in), row stride l1
  const float* A2;  // (h, h), row stride l2
  const float* A3;  // (n_out, h), row stride l3
  int l1, l2, l3;
  const float* W1t;  // Res = false: the (in, out) transposes; unused with the image
  const float* W2t;
  const float* W3t;
  const float* b1;
  const float* b2;
  const float* b3;
};

// C = A M for rows [0, R) of A (row stride lda, K columns); element (k, n)
// of M is M[k * ldm + n] (T = false) or M[n * ldm + k] (T = true).  Every
// valid element goes to epi(r, n, value).
template <bool T, int TM, class Epi>
__device__ __forceinline__ void cmm_tm(const float* A, int lda, int R, int K, const float* M,
                                       int ldm, int N, Epi epi) {
  constexpr int TN = 4;
  const int nq = (N + TN - 1) / TN;
  const int tiles = ((R + TM - 1) / TM) * nq;
  const int mstep = T ? 1 : ldm;
  for (int tile = threadIdx.x; tile < tiles; tile += blockDim.x) {
    const int rq = tile / nq, c = tile - rq * nq, r0 = rq * TM;
    // out-of-range rows and columns load a valid neighbour; their sums are dropped
    const float* arow[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) arow[i] = A + min(r0 + i, R - 1) * lda;
    const float* mcol[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = min(c + j * nq, N - 1);
      mcol[j] = T ? M + n * ldm : M + n;
    }
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float a[TM], m[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = arow[i][k];
#pragma unroll
      for (int j = 0; j < TN; ++j) m[j] = mcol[j][k * mstep];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], m[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if (r0 + i >= R) break;
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (c + j * nq < N) epi(r0 + i, c + j * nq, acc[i][j]);
    }
  }
}

// cmm_tm with the tallest tile that still gives every thread of the block a tile.
template <bool T, class Epi>
__device__ __forceinline__ void cmm(const float* A, int lda, int R, int K, const float* M,
                                    int ldm, int N, Epi epi) {
  const int nq = (N + 3) / 4, nt = blockDim.x;
  if (((R + 3) / 4) * nq >= nt) cmm_tm<T, 4>(A, lda, R, K, M, ldm, N, epi);
  else if (((R + 1) / 2) * nq >= nt) cmm_tm<T, 2>(A, lda, R, K, M, ldm, N, epi);
  else cmm_tm<T, 1>(A, lda, R, K, M, ldm, N, epi);
}

// C = X A^T for a weight A in nn.Linear layout (out, in): from the image read
// transposed (row stride la), or from its (in, out) transpose Wt in device
// memory (row width ldw).
template <bool Res, class Epi>
__device__ __forceinline__ void mm_at(const float* X, int ldx, int R, int K, const float* A,
                                      int la, const float* Wt, int ldw, int N, Epi epi) {
  if constexpr (Res) cmm<true>(X, ldx, R, K, A, la, N, epi);
  else cmm<false>(X, ldx, R, K, Wt, ldw, N, epi);
}

// The per-row reductions of a stage: div, |y|, |e_z| (stage.cuh's).
__device__ __forceinline__ void stage_norms(const Dims& d, const StageBufs& s, int R) {
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const float* e = s.E + r * s.ldz;
    const float* ep = s.EPS + r * s.ldz;
    const float* y = s.Y + r * s.ldy;
    float div = 0.0f, ee = 0.0f, yy = 0.0f;
    for (int i = 0; i < d.nz; ++i) {
      div = fmaf(e[i], ep[i], div);
      ee = fmaf(e[i], e[i], ee);
    }
    for (int o = 0; o < d.n_out; ++o) yy = fmaf(y[o], y[o], yy);
    s.ST[r * 3 + 0] = div;
    s.ST[r * 3 + 1] = sqrtf(yy + 1e-20f);
    s.ST[r * 3 + 2] = sqrtf(ee + 1e-20f);
  }
}

// stage_fwd<false> of stage.cuh on rows [0, R).  Starts and ends with the
// block synchronised.
template <bool Res>
__device__ void cl_stage_fwd(const Dims& d, const CWeights& w, const StageBufs& s, int R) {
  const int h = d.h, n_in = d.n_in, n_out = d.n_out, nz = d.nz;
  const int ldh = s.ldh, ldy = s.ldy, ldz = s.ldz;
  mm_at<Res>(s.X, s.ldx, R, n_in, w.A1, w.l1, w.W1t, h, h, [&](int r, int n, float acc) {
    gates(acc + w.b1[n], s.S1[r * ldh + n], s.H1[r * ldh + n]);
  });
  __syncthreads();
  mm_at<Res>(s.H1, ldh, R, h, w.A2, w.l2, w.W2t, h, h, [&](int r, int n, float acc) {
    gates(acc + w.b2[n], s.S2[r * ldh + n], s.H2[r * ldh + n]);
  });
  __syncthreads();
  mm_at<Res>(s.H2, ldh, R, h, w.A3, w.l3, w.W3t, n_out, n_out, [&](int r, int n, float acc) {
    s.Y[r * ldy + n] = acc + w.b3[n];
  });
  cmm<false>(s.EPS, ldz, R, nz, w.A3, w.l3, h, [&](int r, int n, float acc) {
    s.S2[r * ldh + n] *= acc;
  });
  __syncthreads();
  cmm<false>(s.S2, ldh, R, h, w.A2, w.l2, h, [&](int r, int n, float acc) {
    s.S1[r * ldh + n] *= acc;
  });
  __syncthreads();
  cmm<false>(s.S1, ldh, R, h, w.A1, w.l1, nz, [&](int r, int n, float acc) {
    s.E[r * ldz + n] = acc;
  });
  __syncthreads();
  stage_norms(d, s, R);
  __syncthreads();
}

// stage_fwd_keep<false> of stage_bwd.cuh on rows [0, R).
template <bool Res>
__device__ void cl_stage_fwd_keep(const Dims& d, const CWeights& w, const BwdBufs& b, int R) {
  const StageBufs& s = b.f;
  const int h = d.h, n_in = d.n_in, n_out = d.n_out, nz = d.nz;
  const int ldh = s.ldh, ldy = s.ldy, ldz = s.ldz;
  mm_at<Res>(s.X, s.ldx, R, n_in, w.A1, w.l1, w.W1t, h, h, [&](int r, int n, float acc) {
    gates(acc + w.b1[n], s.S1[r * ldh + n], s.H1[r * ldh + n]);
  });
  __syncthreads();
  mm_at<Res>(s.H1, ldh, R, h, w.A2, w.l2, w.W2t, h, h, [&](int r, int n, float acc) {
    gates(acc + w.b2[n], s.S2[r * ldh + n], s.H2[r * ldh + n]);
  });
  __syncthreads();
  mm_at<Res>(s.H2, ldh, R, h, w.A3, w.l3, w.W3t, n_out, n_out, [&](int r, int n, float acc) {
    s.Y[r * ldy + n] = acc + w.b3[n];
  });
  cmm<false>(s.EPS, ldz, R, nz, w.A3, w.l3, h, [&](int r, int n, float acc) {
    b.U2[r * ldh + n] = acc;
    b.D2[r * ldh + n] = s.S2[r * ldh + n] * acc;
  });
  __syncthreads();
  cmm<false>(b.D2, ldh, R, h, w.A2, w.l2, h, [&](int r, int n, float acc) {
    b.U1[r * ldh + n] = acc;
    b.D1[r * ldh + n] = s.S1[r * ldh + n] * acc;
  });
  __syncthreads();
  cmm<false>(b.D1, ldh, R, h, w.A1, w.l1, nz, [&](int r, int n, float acc) {
    s.E[r * ldz + n] = acc;
  });
  __syncthreads();
  stage_norms(d, s, R);
  __syncthreads();
}

// The products of stage_bwd<false> (stage_bwd.cuh) on rows [0, R): xbar (the
// first nxb columns) into XB, epsbar into EPB, and z1_t, z2_t, u1bar, u2bar,
// ybar_t, ebar_t kept for the weight gradient, which cl_accumulate takes over
// the cluster's rows.  Starts and ends with the block synchronised.
template <bool Res>
__device__ void cl_stage_bwd(const Dims& d, const CWeights& w, const BwdBufs& b, int R, int nxb) {
  const StageBufs& s = b.f;
  const int h = d.h, n_out = d.n_out, nz = d.nz;
  const int ldh = s.ldh, ldy = s.ldy, ldz = s.ldz, ldx = s.ldx;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const float ry = s.ST[r * 3 + 1], re = s.ST[r * 3 + 2];
    const float dv = b.CT[r * 3 + 0], rz = b.CT[r * 3 + 1], rj = b.CT[r * 3 + 2];
    for (int o = 0; o < n_out; ++o) b.YB[r * ldy + o] += rz * s.Y[r * ldy + o] / ry;
    for (int i = 0; i < nz; ++i)
      b.EB[r * ldz + i] = b.EB[r * ldz + i] + dv * s.EPS[r * ldz + i] + rj * s.E[r * ldz + i] / re;
  }
  __syncthreads();
  // d1bar = ebar_t A1[:, :nz]^T
  mm_at<Res>(b.EB, ldz, R, nz, w.A1, w.l1, w.W1t, h, h, [&](int r, int n, float a) {
    const int i = r * ldh + n;
    const float sg = s.S1[i];
    b.G1[i] = a * sg;
    b.U1[i] = a * b.U1[i] * sg * (1.0f - sg);
  });
  __syncthreads();
  // d2bar = u1bar A2^T
  mm_at<Res>(b.G1, ldh, R, h, w.A2, w.l2, w.W2t, h, h, [&](int r, int n, float a) {
    const int i = r * ldh + n;
    const float sg = s.S2[i];
    b.G2[i] = a * sg;
    b.U2[i] = a * b.U2[i] * sg * (1.0f - sg);
  });
  __syncthreads();
  // epsbar = divbar e_z + u2bar A3^T
  mm_at<Res>(b.G2, ldh, R, h, w.A3, w.l3, w.W3t, n_out, nz, [&](int r, int n, float a) {
    b.EPB[r * ldz + n] = b.CT[r * 3 + 0] * s.E[r * ldz + n] + a;
  });
  // z2_t = (ybar_t A3) * s2 + z2_b
  cmm<false>(b.YB, ldy, R, n_out, w.A3, w.l3, h, [&](int r, int n, float a) {
    const int i = r * ldh + n;
    b.U2[i] = a * s.S2[i] + b.U2[i];
  });
  __syncthreads();
  // z1_t = (z2_t A2) * s1 + z1_b
  cmm<false>(b.U2, ldh, R, h, w.A2, w.l2, h, [&](int r, int n, float a) {
    const int i = r * ldh + n;
    b.U1[i] = a * s.S1[i] + b.U1[i];
  });
  __syncthreads();
  // xbar = z1_t A1
  cmm<false>(b.U1, ldh, R, h, w.A1, w.l1, nxb, [&](int r, int n, float a) {
    b.XB[r * ldx + n] = a;
  });
  __syncthreads();
}

// ---------------------------------------------------------------------------
// the weight gradient over the cluster's rows
// ---------------------------------------------------------------------------

// Hidden units (or outputs) of a CTA's share: n / C rounded up.
__host__ __device__ inline int share_units(int n, int C) { return (n + C - 1) / C; }

// Floats of a CTA's share of the weight gradient: the rows of dA1, db1, dA2
// and db2 of share_units(h, C) hidden units, the rows of dA3 and db3 of
// share_units(n_out, C) outputs.
__host__ __device__ inline long share_floats(const Dims& d, int C) {
  const long m = share_units(d.h, C), o = share_units(d.n_out, C);
  return round4(m * (d.n_in + 1 + d.h + 1) + o * (d.h + 1));
}

// CTA `rank`'s share, in shared memory: rows [m0, m1) of dA1 (h, n_in), db1,
// dA2 (h, h) and db2, rows [o0, o1) of dA3 (n_out, h) and db3.
struct GradShare {
  int m0, m1, o0, o1;
  float* dA1;
  float* db1;
  float* dA2;
  float* db2;
  float* dA3;
  float* db3;
};

__device__ inline GradShare carve_share(float* p, const Dims& d, int C, int rank) {
  GradShare g;
  const int mu = share_units(d.h, C), ou = share_units(d.n_out, C);
  g.m0 = min(d.h, rank * mu);
  g.m1 = min(d.h, g.m0 + mu);
  g.o0 = min(d.n_out, rank * ou);
  g.o1 = min(d.n_out, g.o0 + ou);
  g.dA1 = p;  p += mu * d.n_in;
  g.db1 = p;  p += mu;
  g.dA2 = p;  p += mu * d.h;
  g.db2 = p;  p += mu;
  g.dA3 = p;  p += ou * d.h;
  g.db3 = p;
  return g;
}

// One thread's 4 x 4 tile of out[m][n] += s1 + s2 (m = ma .. ma + 3, n =
// nb + j ns for j < 4): s1 = sum_rows P[r][m0 + m] Q[r][n], s2 = sum_rows
// U[r][m0 + m] V[r][n] (0 for n >= n2), the rows those of every CTA of the
// cluster in order of rank (each holds its R rows at the same offsets of its
// shared memory).
__device__ __forceinline__ void outer_tile(int C, int R, int ma, int nb, int ns, int mc, int N,
                                           int n2, int m0, const float* P, int ldp,
                                           const float* Q, int ldq, const float* U, int ldu,
                                           const float* V, int ldv, float* out, int ldo) {
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  int mi[4], nj[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) mi[i] = m0 + min(ma + i, mc - 1);
#pragma unroll
  for (int j = 0; j < 4; ++j) nj[j] = min(nb + j * ns, N - 1);
  float s1[4][4], s2[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s1[i][j] = s2[i][j] = 0.0f;
  for (int q = 0; q < C; ++q) {
    const float* Pq = cl.map_shared_rank(P, q);
    const float* Qq = cl.map_shared_rank(Q, q);
    const float* Uq = cl.map_shared_rank(U, q);
    const float* Vq = cl.map_shared_rank(V, q);
#pragma unroll 2
    for (int r = 0; r < R; ++r) {
      float p[4], u[4], qv[4], v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = Pq[r * ldp + mi[i]];
        u[i] = Uq[r * ldu + mi[i]];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = Qq[r * ldq + nj[j]];
        v[j] = nj[j] < n2 ? Vq[r * ldv + nj[j]] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s1[i][j] = fmaf(p[i], qv[j], s1[i][j]);
          s2[i][j] = fmaf(u[i], v[j], s2[i][j]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (ma + i >= mc) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = nb + j * ns;
      if (n < N) out[(ma + i) * ldo + n] += s1[i][j] + (n < n2 ? s2[i][j] : 0.0f);
    }
  }
}

// The tiles of an (mc, N) block of the share, a warp each 16 x 32 of it: the
// lanes 4 m-quads x 8 columns, a lane's columns 8 apart.  A warp reads 16 m
// and 32 n of each row (of P and U, of Q and V): each element of a peer's
// row is read by one warp, not by every warp.  tiles(): the threads the
// block takes (whole warps); tile(t): thread t's (ma, nb).
struct WarpTiles {
  int mc, N, nbn;
  __device__ __forceinline__ WarpTiles(int mc_, int N_) : mc(mc_), N(N_), nbn((N_ + 31) / 32) {}
  __device__ __forceinline__ int tiles() const { return mc > 0 ? ((mc + 15) / 16) * nbn * 32 : 0; }
  __device__ __forceinline__ void tile(int t, int& ma, int& nb) const {
    const int w = t >> 5, lane = t & 31;
    ma = (w / nbn) * 16 + (lane >> 3) * 4;
    nb = (w % nbn) * 32 + (lane & 7);
  }
};

// A bias's share: out[m] += sum_rows P[r][m0 + m], over the cluster's rows.
__device__ __forceinline__ void bias_entry(int C, int R, int m, int m0, const float* P, int ldp,
                                           float* out) {
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  float s = 0.0f;
  for (int q = 0; q < C; ++q) {
    const float* Pq = cl.map_shared_rank(P, q);
    for (int r = 0; r < R; ++r) s += Pq[r * ldp + m0 + m];
  }
  out[m] += s + 0.0f;
}

// Adds the stage's weight gradient over the R rows of every CTA of the
// cluster (their BwdBufs after cl_stage_bwd) to this CTA's share:
//   dA1[j, i] += sum z1_t[j] x[i] + d1[j] ebar_t[i] (i < nz)   db1[j] += sum z1_t[j]
//   dA2[k, j] += sum z2_t[k] h1[j] + d2[k] u1bar[j]            db2[k] += sum z2_t[k]
//   dA3[o, k] += sum ybar_t[o] h2[k] + eps[o] u2bar[k]         db3[o] += sum ybar_t[o]
// (stage_bwd.cuh's accumulate_wgrads, as products over the rows with 4 x 4
// register tiles, a warp 16 x 32 of them: WarpTiles).  Every entry of the share has one owner thread, which
// sums in a fixed order: the same inputs give the same bits.  The caller
// synchronises the cluster before (every CTA's buffers are written) and
// after (no CTA overwrites them while a peer reads).
__device__ inline void cl_accumulate(const Dims& d, const BwdBufs& b, int R, int C,
                                     const GradShare& g) {
  const StageBufs& s = b.f;
  const int h = d.h, n_in = d.n_in, nz = d.nz;
  const int mc = g.m1 - g.m0, oc = g.o1 - g.o0;
  const WarpTiles w1(mc, n_in), w2(mc, h), w3(oc, h);
  const int t1 = w1.tiles(), t2 = t1 + w2.tiles(), t3 = t2 + w3.tiles();
  const int total = t3 + 2 * mc + oc;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    int ma, nb;
    if (t < t1) {
      w1.tile(t, ma, nb);
      outer_tile(C, R, ma, nb, 8, mc, n_in, nz, g.m0, b.U1, s.ldh, s.X, s.ldx, b.D1, s.ldh, b.EB,
                 s.ldz, g.dA1, n_in);
    } else if (t < t2) {
      w2.tile(t - t1, ma, nb);
      outer_tile(C, R, ma, nb, 8, mc, h, h, g.m0, b.U2, s.ldh, s.H1, s.ldh, b.D2, s.ldh, b.G1,
                 s.ldh, g.dA2, h);
    } else if (t < t3) {
      w3.tile(t - t2, ma, nb);
      outer_tile(C, R, ma, nb, 8, oc, h, h, g.o0, b.YB, s.ldy, s.H2, s.ldh, s.EPS, s.ldz, b.G2,
                 s.ldh, g.dA3, h);
    } else if (t < t3 + mc) {
      bias_entry(C, R, t - t3, g.m0, b.U1, s.ldh, g.db1);
    } else if (t < t3 + 2 * mc) {
      bias_entry(C, R, t - t3 - mc, g.m0, b.U2, s.ldh, g.db2);
    } else {
      bias_entry(C, R, t - t3 - 2 * mc, g.o0, b.YB, s.ldy, g.db3);
    }
  }
}

}  // namespace cnf
