// K5's and K6's cluster path (32 < h <= 128): one thread-block cluster of
// 2 or 4 CTAs per control group, each CTA taking g / C of the group's rows.
//
// Why: on the tiled path (adaptive.cuh solve_tiled) one 256-thread block
// takes a whole 128-row group, so a batch of 8,192 rows (64 groups) leaves
// half of the 132 SMs idle; at h = 128 the weights do not fit its 48 KB
// staging budget and every product reads them from L2; a stage runs in
// passes of ~40 rows, and the group's state lives in device memory.  Here:
//   * the group's rows are split over the cluster, so a batch of G groups
//     keeps C G CTAs busy (C = 2 where a CTA's rows fit in shared memory,
//     else 4: cluster_plan);
//   * each CTA evaluates its rows in one pass a stage, with its state (u,
//     k_0..k_6, u5) in shared memory where it fits (else in the device-memory
//     scratch, which stays in L2);
//   * the weights are resident in shared memory in one layout (nn.Linear,
//     odd row strides), loaded once: each CTA copies a C-th of the weight
//     image from device memory with one bulk copy (TMA, cp.async.bulk)
//     multicast to every CTA of the cluster, completing on each CTA's
//     mbarrier.  The forward and the VJP products read that copy
//     (cluster_stage.cuh).  Where the image does not fit beside the rows,
//     the products read the device-memory weights (the plan says which);
//   * the controller's error sum is taken over the cluster through
//     distributed shared memory: rank 0's thread 0 reads every CTA's red[]
//     in order of rank, i.e. in order of row, as group_decide does, decides
//     (adaptive.cuh ctl_decide), and writes the Ctl into each peer's shared
//     memory; cluster barriers take the place of the block barriers around
//     the decision.  The trial-step arithmetic is adaptive.cuh's.
// The per-element arithmetic is the tiled path's, so K5 here gives its bits.
//
// K5's record: under autograd K5 (cl_solve) also writes, for each accepted
// step, the z columns of its six stage inputs v_0 (u at the step's start)
// ... v_5, built by stage_input from the accepted trial's k's (the values
// the stages were evaluated at), into a device buffer of max_nodes x 6 x nz
// x B floats ([node][stage][column][row]: a warp's stores and the walk's
// loads are neighbouring rows), with each step's t and dt and each group's
// accepted count and done flag.  K6 walks that record: it solves nothing
// again and recomputes no stage input.  A K6 called without K5's record
// (fused_solve_dopri5_bwd) has K5's kernel write one first: the same
// cl_solve, so the same steps and the same bits.
//
// K6's walk back (cl_walk) runs on a cluster of the same shape: each CTA walks its rows
// (in passes of walk_rows rows where they do not fit at once), its rows'
// cotangents (a, vbar_0..vbar_5, epsbar) in its shared memory for the whole
// walk.  The weight gradient is a product over the cluster's rows at each
// stage (cluster_stage.cuh cl_accumulate): each CTA owns a fixed share of
// the P entries, held in its shared memory across stages and steps, and
// reads its peers' activations and cotangents over distributed shared
// memory.  It is written once, to the group's row of the partial-sum buffer,
// at the end; the fixed-order reduction (stage_bwd.cuh launch_reduce) adds
// the groups' rows.  The next step's six stage inputs are loaded with cp.async
// while the current step's stages run.  A group that did not finish, or
// accepted more steps than the record holds, NaN-poisons its rows and its
// row of partial sums, as on the tiled path.
#pragma once

#include <stdint.h>

#include "adaptive.cuh"
#include "cluster_stage.cuh"

namespace cnf {

namespace cg = cooperative_groups;

// ---------------------------------------------------------------------------
// the plan
// ---------------------------------------------------------------------------

// The weight image: A1 (h, odd n_in), A2 (h, odd h), A3 (n_out, odd h), b1,
// b2, b3, padded to a multiple of 4 C floats so that each CTA's bulk copy of
// a C-th is a multiple of 16 bytes.  The wrapper builds it in this layout.
struct ImageLayout {
  int l1, lh;
  long oA2, oA3, ob1, ob2, ob3, floats;
};

__host__ __device__ inline ImageLayout image_layout(const Dims& d, int C) {
  ImageLayout L;
  L.l1 = odd(d.n_in);
  L.lh = odd(d.h);
  L.oA2 = (long)d.h * L.l1;
  L.oA3 = L.oA2 + (long)d.h * L.lh;
  L.ob1 = L.oA3 + (long)d.n_out * L.lh;
  L.ob2 = L.ob1 + d.h;
  L.ob3 = L.ob2 + d.h;
  const long unit = 4L * C;
  L.floats = (L.ob3 + d.n_out + unit - 1) / unit * unit;
  return L;
}

constexpr int kBarFloats = 4;  // the image's mbarrier (8 bytes), 16 bytes kept
constexpr int kClusterThreads = 256;  // threads of a CTA
constexpr int kRecordStages = 6;      // stage inputs of an accepted step in K5's record

struct ClusterPlan {
  int cluster;    // CTAs a control group (0: the cluster path is not taken)
  int rows;       // rows of a CTA: group / cluster
  int res_fwd;    // K5: the weight image resident in shared memory
  int state_fwd;  // K5: the rows' state in shared memory (else the device scratch)
  int smem_fwd;   // K5: bytes of shared memory
  int res_bwd;    // K6's walk: the weight image resident
  int walk_rows;  // K6's walk: rows of a pass
  int smem_bwd;   // K6's walk: bytes of shared memory
  int image;      // floats of the weight image (0: neither kernel holds it)
  int share;      // floats of a CTA's share of the weight gradient
};

// Floats of the forward solve of R rows: image, mbarrier, Ctl, red, the
// stage buffers, and the state when it is kept on chip.
__host__ __device__ inline long solve_floats(const Dims& d, int sd, int R, long image,
                                             bool state) {
  return (image ? image + kBarFloats : 0) + kCtlFloats + round4(R) +
         (long)R * (stage_floats_per_row(d) + (state ? kStateVecs * sd : 0));
}

// Floats of a row of K6's walk: the stage backward's buffers, the state
// cotangent a (sd), and z columns of the current and of the next step's six
// stage inputs (two buffers), the six input cotangents and epsbar.
__host__ __device__ inline long walk_row_floats(const Dims& d, int sd) {
  return bwd_floats_per_row(d) + odd(sd) + (3 * kRecordStages + 1) * odd(d.nz);
}

// The cluster plan for groups of g rows and a batch of B: C = 2 CTAs a group
// where a CTA's 64 rows fit, else C = 4 (the gate's edge, n_in and n_out
// near 128).  path: -1 or 1 the cluster path wherever it fits, 2 or 4 only
// with that C (to time one C against the other), 0 the tiled path (cluster
// = 0).  chip_profile.py adaptive-wide timed the tiled path, C = 2 and C = 4
// in one call at h = 33 ... 128 and B = 8,192 ... 65,536 and at the adaptive
// band (42 -> 128 -> 128 -> 41, B = 16,384 and 65,536) on an H100: the
// cluster path was ahead of the tiled path for K5 and K6 everywhere, and
// C = 2 ahead of C = 4 for K6 everywhere and for K5 but at h = 96, B =
// 65,536 and at the band (where C = 4 holds the weight image and C = 2 does
// not); a band step's K6 gains more than its K5 loses.
// For the C taken, the kernels keep the weight image and then the state in
// shared memory where they fit beside one pass of the CTA's rows, and K6's
// walk keeps the image (where K5 holds one) where that costs it no extra
// pass.  Where the image is not resident, the products read the
// device-memory weights (from L2):
//   * K5 at the adaptive band (C = 2: 64 rows a CTA) and at
//     the gate's edge, where one layout does not fit beside a CTA's rows;
//     sharding the image over the cluster and reading the peers' parts over
//     DSMEM is not done;
//   * K6's walk at h = 128 (6 -> 128 -> 128 -> 5, the band) and at h = 64,
//     where holding the image would cost the walk a pass more.
inline ClusterPlan cluster_plan(const Dims& d, int sd, int g, int B, int path) {
  if (path == 0 || g <= 0 || B % g) return ClusterPlan{};
  const long cap = kSmemMax / 4;
  for (int C : {2, 4}) {
    if (g % C || (path > 1 && C != path)) continue;
    ClusterPlan pl{};
    pl.cluster = C;
    const int R = pl.rows = g / C;
    const long img = image_layout(d, C).floats;
    pl.res_fwd = solve_floats(d, sd, R, img, false) <= cap;
    const long wf = pl.res_fwd ? img : 0;
    if (solve_floats(d, sd, R, wf, false) > cap) continue;
    pl.state_fwd = solve_floats(d, sd, R, wf, true) <= cap;
    pl.smem_fwd = (int)(4 * solve_floats(d, sd, R, wf, pl.state_fwd));
    pl.share = (int)share_floats(d, C);
    const long per = walk_row_floats(d, sd);
    auto passes = [&](long w) {
      const long rw = (cap - (w ? w + kBarFloats : 0) - pl.share) / per;
      return rw < 1 ? 0L : (R + rw - 1) / rw;
    };
    const long p_img = pl.res_fwd ? passes(img) : 0;
    const long p_dev = passes(0);
    if (!p_dev) continue;
    pl.res_bwd = p_img && p_img <= p_dev;
    const long np = pl.res_bwd ? p_img : p_dev;
    pl.walk_rows = (int)((R + np - 1) / np);  // passes of equal rows
    const long walk = (pl.res_bwd ? img + kBarFloats : 0) + pl.share + (long)pl.walk_rows * per;
    pl.smem_bwd = (int)(4 * walk);
    pl.image = pl.res_fwd ? (int)img : 0;
    return pl;
  }
  return ClusterPlan{};
}

// ---------------------------------------------------------------------------
// the weights
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Waits for phase `parity` of the mbarrier; a copy that never lands traps
// (a launch error) after ~2 s instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t ok;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
    if (ok) return;
    if (clock64() - start > (1LL << 32)) __trap();
  }
}

// The weight image into every CTA of the cluster: CTA `rank` copies the
// rank-th C-th of it from device memory with one bulk copy multicast to the
// whole cluster; each CTA's mbarrier expects the whole image.  Every thread
// returns once the image is in its CTA's shared memory.
__device__ inline void load_image(float* img, const float* src, long floats, uint64_t* bar) {
  cg::cluster_group cl = cg::this_cluster();
  const unsigned C = cl.num_blocks(), rank = cl.block_rank();
  const uint32_t b = smem_addr(bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(b), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cl.sync();  // every CTA's mbarrier is set before any copy lands
  if (threadIdx.x == 0) {
    const long chunk = floats / C;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b),
                 "r"((uint32_t)(floats * 4))
                 : "memory");
    const uint16_t mask = (uint16_t)((1u << C) - 1);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
        " [%0], [%1], %2, [%3], %4;" ::"r"(smem_addr(img + rank * chunk)),
        "l"(src + rank * chunk), "r"((uint32_t)(chunk * 4)), "r"(b), "h"(mask)
        : "memory");
  }
  mbar_wait(b, 0);
}

// The weights as the products read them; with Res the image is loaded into
// shared memory at p (advanced past it and its mbarrier).
template <bool Res>
__device__ inline CWeights cluster_weights(const Weights& g, const float* image, const Dims& d,
                                           float*& p) {
  if constexpr (Res) {
    const ImageLayout L = image_layout(d, cg::this_cluster().num_blocks());
    float* img = p;
    p += L.floats;
    load_image(img, image, L.floats, reinterpret_cast<uint64_t*>(p));
    p += kBarFloats;
    return CWeights{img,     img + L.oA2, img + L.oA3, L.l1,        L.lh,       L.lh,
                    nullptr, nullptr,     nullptr,     img + L.ob1, img + L.ob2, img + L.ob3};
  } else {
    return CWeights{g.A1, g.A2, g.A3, d.n_in, d.h, d.h, g.W1t, g.W2t, g.W3t, g.b1, g.b2, g.b3};
  }
}

// ---------------------------------------------------------------------------
// the solve
// ---------------------------------------------------------------------------

// Stage i (0: at u, 1..5: the stage inputs, 6: at u5) of the CTA's R rows in
// one pass, into k_i of the state St (R rows of 9 sd floats).  X's condition
// columns and EPS are set once by the caller.
template <bool Res>
__device__ inline void cl_eval(const Dims& d, const CWeights& w, const StageBufs& s, int R,
                               float* St, int sd, int t_col, int i, float t, float dtc) {
  const int nz = d.nz, ss = kStateVecs * sd, tid = threadIdx.x, nt = blockDim.x;
  for (int idx = tid; idx < R * nz; idx += nt) {
    const int r = idx / nz, col = idx - r * nz;
    const float* Sr = St + (long)r * ss;
    float v = Sr[col];
    if (i == 6) v = Sr[8 * sd + col];
    else if (i > 0) v = stage_input(i, v, Sr + sd + col, sd, dtc);
    s.X[r * s.ldx + col] = v;
  }
  if (t_col >= 0)
    for (int r = tid; r < R; r += nt) s.X[r * s.ldx + t_col] = t;
  __syncthreads();
  cl_stage_fwd<Res>(d, w, s, R);
  for (int idx = tid; idx < R * sd; idx += nt) {
    const int r = idx / sd, col = idx - r * sd;
    St[(long)r * ss + (1 + i) * sd + col] = stage_du(s, r, col, nz);
  }
  __syncthreads();
}

// The group's solve on the cluster: this CTA's R rows, u0 in U of St on
// entry, the state at exit on return; every CTA's c holds the group's
// controller.  red: R floats.  row0: this CTA's first row of the batch (for
// the node buffer), grp: the group (for its node times).
template <bool Res>
__device__ void cl_solve(const Dims& d, const CWeights& w, const StageBufs& s, int R, float* St,
                         int sd, int t_col, float t0, float t1, const Solver& sv, Ctl& c,
                         float* red, const Nodes& nodes, long grp, long row0, long B) {
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int nz = d.nz, ss = kStateVecs * sd, tid = threadIdx.x, nt = blockDim.x;
  const float span = __fadd_rn(t1, -t0);
  cl_eval<Res>(d, w, s, R, St, sd, t_col, 0, t0, 0.0f);
  if (tid == 0) {  // every CTA starts the same controller
    ctl_start(c, t0, span, sv);
    ctl_clamp(c, t1, span);
  }
  __syncthreads();
  while (running(c, sv)) {
    const float t = c.t, dtc = c.dtc;
    for (int i = 1; i < 6; ++i)
      cl_eval<Res>(d, w, s, R, St, sd, t_col, i, __fadd_rn(t, __fmul_rn(kDpC[i], dtc)), dtc);
    for (int idx = tid; idx < R * sd; idx += nt) {
      const int r = idx / sd, col = idx - r * sd;
      float* Sr = St + (long)r * ss;
      Sr[8 * sd + col] = step_solution(Sr[col], Sr + sd + col, sd, dtc);
    }
    __syncthreads();
    cl_eval<Res>(d, w, s, R, St, sd, t_col, 6, __fadd_rn(t, dtc), dtc);
    for (int r = tid; r < R; r += nt) {
      const float* Sr = St + (long)r * ss;
      float sum = 0.0f;
      for (int col = 0; col < sd; ++col)
        sum = __fadd_rn(sum, scaled_err_sq(Sr[col], Sr[8 * sd + col], Sr + sd + col, sd, dtc, sv));
      red[r] = sum;
    }
    cl.sync();  // every CTA's red is complete
    if (rank == 0 && tid == 0) {
      float sum = 0.0f;
      for (int q = 0; q < C; ++q) {
        const float* rq = cl.map_shared_rank(red, q);
        for (int r = 0; r < R; ++r) sum = __fadd_rn(sum, rq[r]);
      }
      ctl_decide(c, sum, C * R * sd, sv, t1, span, nodes, grp);
      ctl_clamp(c, t1, span);
      for (int q = 1; q < C; ++q) *cl.map_shared_rank(&c, q) = c;
    }
    cl.sync();  // every CTA holds the decision; no red is written before it
    if (c.accept) {
      if (nodes.traj != nullptr) {
        // the record: v_0 (u) and v_1..v_5 as cl_eval built them, before the
        // FSAL shift; a warp's stores are neighbouring rows
        const long idx = min(c.nacc - 1, nodes.max_nodes - 1);
        float* rec = nodes.traj + idx * kRecordStages * nz * B + row0;
        for (int e = tid; e < kRecordStages * nz * R; e += nt) {
          const int q = e / R, r = e - q * R, i = q / nz, col = q - i * nz;
          const float* Sr = St + (long)r * ss;
          rec[(long)q * B + r] = i == 0 ? Sr[col] : stage_input(i, Sr[col], Sr + sd + col, sd, dtc);
        }
        __syncthreads();
      }
      for (int e = tid; e < R * sd; e += nt) {
        const int r = e / sd, col = e - r * sd;
        float* Sr = St + (long)r * ss;
        Sr[col] = Sr[8 * sd + col];
        Sr[sd + col] = Sr[7 * sd + col];
      }
    }
    __syncthreads();
  }
}

// Carves the solve's shared memory at p: Ctl, red, the stage buffers of R
// rows, and the state where it is kept on chip (else St points at the CTA's
// rows of the device scratch S).  Loads u0, eps and the conditions of the
// CTA's rows.  Ends with the block synchronised.
struct SolveBufs {
  Ctl* c;
  float* red;
  StageBufs s;
  float* St;
};

__device__ inline SolveBufs solve_setup(float* p, const Dims& d, int R, bool state, float* S,
                                        const float* u0, const float* eps, const float* ys,
                                        long row0, int sd, int nc, int t_col) {
  SolveBufs v;
  v.c = reinterpret_cast<Ctl*>(p);
  p += kCtlFloats;
  v.red = p;
  p += round4(R);
  p = carve_stage(p, R, d, v.s);
  const int ss = kStateVecs * sd, nz = d.nz, ys_off = nz + (t_col >= 0 ? 1 : 0);
  v.St = state ? p : S + row0 * ss;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int idx = tid; idx < R * sd; idx += nt) {
    const int r = idx / sd, col = idx - r * sd;
    v.St[(long)r * ss + col] = u0[row0 * sd + idx];
  }
  for (int idx = tid; idx < R * nz; idx += nt) {
    const int r = idx / nz, col = idx - r * nz;
    v.s.EPS[r * v.s.ldz + col] = eps[row0 * nz + idx];
  }
  for (int idx = tid; idx < R * nc; idx += nt) {
    const int r = idx / nc, j = idx - r * nc;
    v.s.X[r * v.s.ldx + ys_off + j] = ys[row0 * nc + idx];
  }
  __syncthreads();
  return v;
}

// ---------------------------------------------------------------------------
// K6's walk
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// The six stage inputs (z columns) of accepted step n of the pass's Rp rows
// (from row `row` of the batch) into NV (stage i at NV + i * vz),
// asynchronously; cp_async_wait makes them visible.
__device__ inline void prefetch_step(float* NV, int vz, int ldz, const Nodes& nodes, int n, int nz,
                                     long row, int Rp, long B) {
  const float* rec = nodes.traj + (long)n * kRecordStages * nz * B + row;
  for (int idx = threadIdx.x; idx < kRecordStages * nz * Rp; idx += blockDim.x) {
    const int q = idx / Rp, r = idx - q * Rp;  // a warp's loads are neighbouring rows
    const int i = q / nz, col = q - i * nz;
    cp_async4(NV + i * vz + r * ldz + col, rec + (long)q * B + r);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The walk over the group's `walk` accepted steps, last first, of this CTA's
// R rows in passes of cp.walk_rows; the weight gradient summed into the
// CTA's share g (zeroed by the caller) over the cluster's rows.  p: the
// shared memory after the weights and the share.  Pointers eps, ys, gbar,
// u0bar, epsbar at the CTA's first row (row0 of the batch).  The stage
// inputs come from the record (nodes.traj); the next step's are loaded
// while the current step's stages run, into the other of two buffers.
// Every CTA of the cluster calls it with the same R, walk rows and walk.
template <bool Res>
__device__ void cl_walk(const Dims& d, const CWeights& w, float* p, int Rw, int R, long row0,
                        long grp, const float* eps, const float* ys, const float* gbar,
                        float* u0bar, float* epsbar, const Nodes& nodes, int walk,
                        const GradShare& g, int sd, int nc, int t_col, long B, float poison) {
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks();
  BwdBufs b;
  p = carve_bwd(p, Rw, d, b);
  const StageBufs& s = b.f;
  const int nz = d.nz, ldx = s.ldx, ldz = s.ldz, lds = odd(sd);
  const int ys_off = nz + (t_col >= 0 ? 1 : 0);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int vz = Rw * ldz;                  // floats of one z-column buffer
  float* A = p;                             // (Rw, lds) state cotangent a
  float* VS[2] = {A + Rw * lds, A + Rw * lds + kRecordStages * vz};  // v_0..v_5, two steps
  float* VB = VS[1] + kRecordStages * vz;   // vbar_0..vbar_5
  float* EPSB = VB + 6 * vz;                // epsbar
  const float* tdt = nodes.tdt + grp * nodes.max_nodes * 2;

  for (int r0 = 0; r0 < R; r0 += Rw) {
    const int Rp = min(Rw, R - r0);
    for (int idx = tid; idx < Rp * nz; idx += nt) {
      const int r = idx / nz, c = idx - r * nz;
      s.EPS[r * ldz + c] = eps[(long)r0 * nz + idx];
      EPSB[r * ldz + c] = 0.0f;
    }
    for (int idx = tid; idx < Rp * sd; idx += nt) {
      const int r = idx / sd, c = idx - r * sd;
      A[r * lds + c] = gbar[(long)r0 * sd + idx];
    }
    for (int idx = tid; idx < Rp * nc; idx += nt) {
      const int r = idx / nc, j = idx - r * nc;
      s.X[r * ldx + ys_off + j] = ys[(long)r0 * nc + idx];
    }
    if (walk > 0) prefetch_step(VS[0], vz, ldz, nodes, walk - 1, nz, row0 + r0, Rp, B);

    for (int n = walk - 1; n >= 0; --n) {
      const float t = tdt[2 * n], dt = tdt[2 * n + 1];
      const float* V = VS[(walk - 1 - n) & 1];
      cp_async_wait();
      __syncthreads();  // step n's inputs are in V; the other buffer's last reader is done
      if (n > 0) prefetch_step(VS[(walk - n) & 1], vz, ldz, nodes, n - 1, nz, row0 + r0, Rp, B);
      // the six stages backward, last first
      for (int i = 5; i >= 0; --i) {
        for (int idx = tid; idx < Rp * nz; idx += nt) {
          const int r = idx / nz, c = idx - r * nz;
          s.X[r * ldx + c] = V[i * vz + r * ldz + c];
        }
        if (t_col >= 0)
          for (int r = tid; r < Rp; r += nt)
            s.X[r * ldx + t_col] = __fadd_rn(t, __fmul_rn(kDpC[i], dt));
        const float bi = kDpB[i];
        for (int idx = tid; idx < Rp * sd; idx += nt) {
          const int r = idx / sd, c = idx - r * sd;
          float kbar = bi != 0.0f ? __fmul_rn(__fmul_rn(dt, bi), A[r * lds + c]) : 0.0f;
          if (c < nz)
            for (int m = i + 1; m < 6; ++m) {
              const float a = kDpA[m - 1][i];
              if (a != 0.0f) kbar = fmaf(__fmul_rn(dt, a), VB[m * vz + r * ldz + c], kbar);
            }
          set_cotangent(b, r, c, nz, kbar);
        }
        __syncthreads();
        cl_stage_fwd_keep<Res>(d, w, b, Rp);
        cl_stage_bwd<Res>(d, w, b, Rp, nz);
        cl.sync();  // every CTA's stage is complete
        cl_accumulate(d, b, Rp, C, g);
        for (int idx = tid; idx < Rp * nz; idx += nt) {
          const int r = idx / nz, c = idx - r * nz;
          VB[i * vz + r * ldz + c] = b.XB[r * ldx + c];
          EPSB[r * ldz + c] += b.EPB[r * ldz + c];
        }
        cl.sync();  // no CTA overwrites its buffers while a peer reads them
      }
      for (int idx = tid; idx < Rp * nz; idx += nt) {
        const int r = idx / nz, c = idx - r * nz;
        float a = A[r * lds + c];
        for (int i = 0; i < 6; ++i) a = __fadd_rn(a, VB[i * vz + r * ldz + c]);
        A[r * lds + c] = a;
      }
      __syncthreads();
    }

    for (int idx = tid; idx < Rp * sd; idx += nt) {
      const int r = idx / sd, c = idx - r * sd;
      u0bar[(long)r0 * sd + idx] = A[r * lds + c] * poison;
    }
    for (int idx = tid; idx < Rp * nz; idx += nt) {
      const int r = idx / nz, c = idx - r * nz;
      epsbar[(long)r0 * nz + idx] = EPSB[r * ldz + c] * poison;
    }
    __syncthreads();  // the next pass overwrites the buffers
  }
}

// The CTA's share of the weight gradient into the group's row of the
// partial sums (P floats, the layout of cnf_fused_dynamics_bwd), times
// `poison` where the group is poisoned.
__device__ inline void write_share(const Dims& d, const GradShare& g, float* row, bool ok,
                                   float poison) {
  const int h = d.h, n_in = d.n_in, n_out = d.n_out;
  const long oB1 = (long)h * n_in, oA2 = oB1 + h, oB2 = oA2 + (long)h * h, oA3 = oB2 + h;
  const long oB3 = oA3 + (long)n_out * h;
  const int mc = g.m1 - g.m0, oc = g.o1 - g.o0, tid = threadIdx.x, nt = blockDim.x;
  auto put = [&](long at, float v) { row[at] = ok ? v : v * poison; };
  for (int e = tid; e < mc * n_in; e += nt) put((long)g.m0 * n_in + e, g.dA1[e]);
  for (int e = tid; e < mc; e += nt) put(oB1 + g.m0 + e, g.db1[e]);
  for (int e = tid; e < mc * h; e += nt) put(oA2 + (long)g.m0 * h + e, g.dA2[e]);
  for (int e = tid; e < mc; e += nt) put(oB2 + g.m0 + e, g.db2[e]);
  for (int e = tid; e < oc * h; e += nt) put(oA3 + (long)g.o0 * h + e, g.dA3[e]);
  for (int e = tid; e < oc; e += nt) put(oB3 + g.o0 + e, g.db3[e]);
}

// Launches `kernel` as clusters of C CTAs of kClusterThreads threads with `smem`
// bytes of shared memory each.  A refused launch returns its error; it never
// falls back to another path.
template <class Kernel, class... Args>
cudaError_t launch_cluster(Kernel kernel, int grid, int C, int smem, cudaStream_t stream,
                           Args... args) {
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace cnf
