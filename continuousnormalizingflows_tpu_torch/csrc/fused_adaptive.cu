// K5 on Hopper: the whole adaptive Dormand-Prince 5(4) solve of the
// augmented CNF state in one launch, one block per control group of rows.
//
// Replaces continuousnormalizingflows_tpu/ops/pallas_adaptive.py
// _adaptive_fwd_kernel (public fused_solve_dopri5).  Each group runs its own
// step sequence with the controller of adaptive.cuh; a group that does not
// finish within max_steps NaN-poisons its rows of u1.  One stats row per
// group: [nfe, naccept, nreject, dt_final].  Nothing is read back to the
// host inside the call: t0 and t1 are device scalars (a steered t1 costs no
// synchronisation) and the counts stay on the device.
//
// What bounds it on an H100: a trial step is 6 stages of ~3.4 kFLOP per row
// at the flagship width (h = 24) against no device-memory traffic at all on
// the row path (u0, eps and ys read once, u1 written once), so instruction
// issue inside the SM (the FMAs, the weights' shared-memory loads and the
// address arithmetic around them), plus one block-wide reduction and two
// barriers per trial step.  A group of 128 rows is one block of 128 threads, compiled for four
// blocks an SM (128 registers a thread) with one copy of the stage in its
// code (adaptive.cuh), so the 512 groups of the flagship batch (65,536) run
// in one wave on the 132 SMs.
// Wider nets (32 < h <= 128) take the cluster path of cluster_adaptive.cuh:
// a group's rows split over a thread-block cluster of 2 or 4 CTAs, the
// weights resident in shared memory, one pass a stage, the error sum over
// distributed shared memory.  Under autograd the cluster path also writes
// K5's record for K6: each accepted step's six stage inputs (z columns),
// its t and dt, each group's accepted count and done flag
// (cluster_adaptive.cuh).  At the default 128 nodes that is 6 x 128 x nz x B
// floats: 3.4 GB at nz = 17, B = 65,536, each accepted step's 6 nz B floats
// written once (27 MB there).  Where its plan does not fit they take the
// tiled stage of stage.cuh, one block a group, with the rows' state in a
// device-memory scratch, and write no record.
//
// C interface for ctypes: returns a cudaError_t (0 on success).

#include "cluster_adaptive.cuh"

namespace {

using cnf::Ctl;
using cnf::Nodes;
using cnf::Solver;

// The row path: thread r owns row r of the block's group.
template <int H>
__global__ void __launch_bounds__(cnf::kMaxGroup, cnf::kRowGroupsPerSM)
adaptive_fwd_rows(const float* __restrict__ u0, const float* __restrict__ eps,
                  const float* __restrict__ ys, cnf::Weights gw, cnf::Dims d,
                  const float* __restrict__ t0p, const float* __restrict__ t1p,
                  float* __restrict__ u1, float* __restrict__ stats, int B, int sd, int nc,
                  int t_col, Solver s) {
  extern __shared__ __align__(16) float smem[];
  const cnf::RowWeights w = cnf::stage_row_weights<H, false>(gw, d, smem);
  float* p = smem + cnf::row_weight_floats(d, H);
  Ctl& c = *reinterpret_cast<Ctl*>(p);
  p += cnf::kCtlFloats;
  float* red = p;
  p += blockDim.x;
  const int ld = cnf::adaptive_row_floats(d, sd);
  float* row = p + threadIdx.x * ld;
  float* U = row;
  float* X = row + 9 * sd;
  float* EPS = X + d.n_in + d.n_out;
  const long r = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int nz = d.nz, ys_off = nz + (t_col >= 0 ? 1 : 0);
  for (int col = 0; col < sd; ++col) U[col] = u0[r * sd + col];
  for (int col = 0; col < nz; ++col) EPS[col] = eps[r * nz + col];
  for (int j = 0; j < nc; ++j) X[ys_off + j] = ys[r * nc + j];
  __syncthreads();  // the staged weights

  cnf::solve_rows<H>(w, d, row, sd, t_col, *t0p, *t1p, s, c, red, Nodes{nullptr, nullptr, 0}, r,
                     B);
  const float nan = __int_as_float(0x7fc00000);
  for (int col = 0; col < sd; ++col) u1[r * sd + col] = c.done ? U[col] : nan;
  if (threadIdx.x == 0) {
    float* st = stats + (long)blockIdx.x * 4;
    st[0] = (float)c.nfe;
    st[1] = (float)c.nacc;
    st[2] = (float)(c.steps - c.nacc);
    st[3] = c.dt;
  }
}

// The tiled path: kThreads threads, the group's state in the scratch S
// (B x 9 x sd floats).
__global__ void __launch_bounds__(cnf::kThreads)
adaptive_fwd_tiled(const float* __restrict__ u0, const float* __restrict__ eps,
                   const float* __restrict__ ys, cnf::Weights gw, cnf::Dims d, bool staged,
                   const float* __restrict__ t0p, const float* __restrict__ t1p,
                   float* __restrict__ S, float* __restrict__ u1, float* __restrict__ stats,
                   int B, int sd, int nc, int t_col, int g, int rows, Solver s) {
  extern __shared__ __align__(16) float smem[];
  float* p = smem;
  const cnf::Weights w = cnf::stage_weights(gw, d, staged, p);
  cnf::StageBufs sb;
  p = cnf::carve_stage(p, rows, d, sb);
  Ctl& c = *reinterpret_cast<Ctl*>(p);
  p += cnf::kCtlFloats;
  float* red = p;
  const long row0 = (long)blockIdx.x * g;
  const int ss = cnf::kStateVecs * sd;
  float* Sg = S + row0 * ss;
  for (int idx = threadIdx.x; idx < g * sd; idx += blockDim.x) {
    const int r = idx / sd, col = idx - r * sd;
    Sg[(long)r * ss + col] = u0[row0 * sd + idx];
  }
  __syncthreads();

  cnf::solve_tiled(d, w, sb, rows, g, Sg, eps + row0 * d.nz, ys == nullptr ? ys : ys + row0 * nc,
                   sd, nc, t_col, *t0p, *t1p, s, c, red, Nodes{nullptr, nullptr, 0}, row0, B);
  const float nan = __int_as_float(0x7fc00000);
  for (int idx = threadIdx.x; idx < g * sd; idx += blockDim.x) {
    const int r = idx / sd, col = idx - r * sd;
    u1[row0 * sd + idx] = c.done ? Sg[(long)r * ss + col] : nan;
  }
  if (threadIdx.x == 0) {
    float* st = stats + (long)blockIdx.x * 4;
    st[0] = (float)c.nfe;
    st[1] = (float)c.nacc;
    st[2] = (float)(c.steps - c.nacc);
    st[3] = c.dt;
  }
}

// The cluster path: cp.cluster CTAs of kClusterThreads threads a group, each
// taking cp.rows of its rows (cluster_adaptive.cuh).  With Res the weights
// are the image, resident in shared memory.  With nodes.traj the record
// for K6 (nacc_out and done_out: each group's accepted count and flag).
template <bool Res>
__global__ void __launch_bounds__(cnf::kClusterThreads, 2)
adaptive_fwd_cluster(const float* __restrict__ u0, const float* __restrict__ eps,
                     const float* __restrict__ ys, cnf::Weights gw,
                     const float* __restrict__ image, cnf::Dims d, cnf::ClusterPlan cp,
                     const float* __restrict__ t0p, const float* __restrict__ t1p,
                     float* __restrict__ S, float* __restrict__ u1, float* __restrict__ stats,
                     Nodes nodes, int* __restrict__ nacc_out, int* __restrict__ done_out, int B,
                     int sd, int nc, int t_col, int g, Solver s) {
  extern __shared__ __align__(16) float smem[];
  const int rank = (int)cnf::cg::this_cluster().block_rank(), R = cp.rows;
  const long grp = blockIdx.x / cp.cluster, row0 = grp * g + (long)rank * R;
  float* p = smem;
  const cnf::CWeights w = cnf::cluster_weights<Res>(gw, image, d, p);
  const cnf::SolveBufs v =
      cnf::solve_setup(p, d, R, cp.state_fwd, S, u0, eps, ys, row0, sd, nc, t_col);
  cnf::cl_solve<Res>(d, w, v.s, R, v.St, sd, t_col, *t0p, *t1p, s, *v.c, v.red, nodes, grp,
                     row0, B);
  const Ctl& c = *v.c;
  const float nan = __int_as_float(0x7fc00000);
  const int ss = cnf::kStateVecs * sd;
  for (int idx = threadIdx.x; idx < R * sd; idx += blockDim.x) {
    const int r = idx / sd, col = idx - r * sd;
    u1[row0 * sd + idx] = c.done ? v.St[(long)r * ss + col] : nan;
  }
  if (rank == 0 && threadIdx.x == 0) {
    float* st = stats + grp * 4;
    st[0] = (float)c.nfe;
    st[1] = (float)c.nacc;
    st[2] = (float)(c.steps - c.nacc);
    st[3] = c.dt;
    if (nodes.traj != nullptr) {
      nacc_out[grp] = c.nacc;
      done_out[grp] = c.done;
    }
  }
  cnf::cg::this_cluster().sync();  // no CTA leaves while a peer may reach its shared memory
}

cudaError_t launch(const float* u0, const float* eps, const float* ys, const cnf::Weights& w,
                   const float* image, const cnf::Dims& d, const float* t0, const float* t1,
                   float* S, float* u1, float* stats, const Nodes& nodes, int* nacc, int* done,
                   int B, int sd, int nc, int t_col, int g, int path, const Solver& s,
                   cudaStream_t stream) {
  const cnf::AdaptivePlan pl = cnf::adaptive_plan(d, sd, g);
  if (pl.smem_fwd == 0) return cudaErrorInvalidValue;
  const int grid = B / g;
  if (pl.H == 0 && pl.walk_H == 0) {
    const cnf::ClusterPlan cp = cnf::cluster_plan(d, sd, g, B, path);
    if (cp.cluster) {
      if (cp.res_fwd && image == nullptr) return cudaErrorInvalidValue;
      const auto kernel = cp.res_fwd ? adaptive_fwd_cluster<true> : adaptive_fwd_cluster<false>;
      return cnf::launch_cluster(kernel, grid * cp.cluster, cp.cluster, cp.smem_fwd, stream, u0,
                                 eps, ys, w, image, d, cp, t0, t1, S, u1, stats, nodes, nacc,
                                 done, B, sd, nc, t_col, g, s);
    }
  }
  if (path >= 1) return cudaErrorInvalidValue;  // the cluster path was asked for and does not fit
  if (nodes.traj != nullptr) return cudaErrorInvalidValue;  // a record only on the cluster path
  if (pl.H == 0) {
    cudaError_t err = cnf::set_smem(adaptive_fwd_tiled, pl.smem_fwd);
    if (err != cudaSuccess) return err;
    adaptive_fwd_tiled<<<grid, cnf::kThreads, pl.smem_fwd, stream>>>(
        u0, eps, ys, w, d, pl.staged, t0, t1, S, u1, stats, B, sd, nc, t_col, g, pl.rows, s);
    return cudaGetLastError();
  }
  // H = 4, 8, ..., 32 (row_fwd_H)
  decltype(&adaptive_fwd_rows<4>) const kernels[] = {
      adaptive_fwd_rows<4>,  adaptive_fwd_rows<8>,  adaptive_fwd_rows<12>, adaptive_fwd_rows<16>,
      adaptive_fwd_rows<20>, adaptive_fwd_rows<24>, adaptive_fwd_rows<28>, adaptive_fwd_rows<32>};
  const auto kernel = kernels[pl.H / 4 - 1];
  cudaError_t err = cnf::set_row_smem(kernel, pl.smem_fwd);
  if (err != cudaSuccess) return err;
  kernel<<<grid, g, pl.smem_fwd, stream>>>(u0, eps, ys, w, d, t0, t1, u1, stats, B, sd, nc, t_col,
                                            s);
  return cudaGetLastError();
}

}  // namespace

// Weights as for cnf_fused_solve_rk4_fwd (W*t read only on the tiled and
// cluster paths when the weights are not in shared memory).  image: the
// weight image of cnf_adaptive_cluster_plan (null where the plan holds none).
// t0, t1: device scalars.  S: scratch of B x 9 x sd floats (used by the
// tiled and cluster paths).  stats: (B / group) x 4.  B must be a multiple of
// group (<= 128, a multiple of 8).  path: -1 the plan's, 0 the tiled path, 1
// the cluster path, 2 or 4 the cluster path of that many CTAs a group (an
// error where it does not fit).  rec (null: no record; the cluster path
// only): K5's record for K6, max_nodes x 6 x nz x B floats; tdt: (B / group)
// x max_nodes x 2 floats; nacc and done: (B / group) ints each.
extern "C" int cnf_fused_adaptive_fwd(const float* u0, const float* eps, const float* ys,
                                      const float* A1, const float* b1, const float* A2,
                                      const float* b2, const float* A3, const float* b3,
                                      const float* W1t, const float* W2t, const float* W3t,
                                      const float* image, const float* t0, const float* t1,
                                      float* S, float* u1, float* stats, float* rec, float* tdt,
                                      int* nacc, int* done, int B, int sd, int n_in,
                                      int h, int n_out, int nz, int nc, int t_col, int group,
                                      int path, int max_nodes, int max_steps,
                                      float rtol, float atol, float dt0f, float safety,
                                      float min_f, float max_f, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (group <= 0 || group > cnf::kMaxGroup || B % group != 0) return cudaErrorInvalidValue;
  if (rec != nullptr && (max_nodes < 1 || tdt == nullptr || nacc == nullptr || done == nullptr))
    return cudaErrorInvalidValue;
  const cnf::Weights w{W1t, W2t, W3t, A1, A2, A3, b1, b2, b3};
  const cnf::Dims d{n_in, h, n_out, nz};
  const Solver s{rtol, atol, dt0f, safety, min_f, max_f, max_steps};
  const Nodes nodes = rec != nullptr ? Nodes{rec, tdt, max_nodes} : Nodes{nullptr, nullptr, 0};
  return launch(u0, eps, ys, w, image, d, t0, t1, S, u1, stats, nodes, nacc, done, B, sd, nc,
                t_col, group, path, s, static_cast<cudaStream_t>(stream));
}

// The launch plan of K5 and K6, which the wrapper reads to size K6's
// partial-sum buffer: returns the forward's shared bytes (0: does not fit);
// info = {H, rows, bwd_rows, smem_bwd, walk_H, walk_blocks} (AdaptivePlan).
extern "C" int cnf_adaptive_plan(int n_in, int h, int n_out, int nz, int sd, int group,
                                 int* info) {
  const cnf::AdaptivePlan pl = cnf::adaptive_plan(cnf::Dims{n_in, h, n_out, nz}, sd, group);
  info[0] = pl.H;
  info[1] = pl.rows;
  info[2] = pl.bwd_rows;
  info[3] = pl.smem_bwd;
  info[4] = pl.walk_H;
  info[5] = pl.walk_blocks;
  return pl.smem_fwd;
}

// The cluster path's plan (cluster_adaptive.cuh) for a batch of B rows in
// groups of `group`: returns the CTAs a group (0: K5 and K6 do not take the
// cluster path, with `path` as for cnf_fused_adaptive_fwd); info = {rows,
// res_fwd, state_fwd, smem_fwd, res_bwd, walk_rows, smem_bwd, image, share}
// (ClusterPlan).  The wrapper builds the weight image of
// `image` floats where it is not 0.
extern "C" int cnf_adaptive_cluster_plan(int n_in, int h, int n_out, int nz, int sd, int group,
                                         int B, int path, int* info) {
  const cnf::Dims d{n_in, h, n_out, nz};
  const cnf::AdaptivePlan pl = cnf::adaptive_plan(d, sd, group);
  cnf::ClusterPlan cp{};
  if (pl.H == 0 && pl.walk_H == 0) cp = cnf::cluster_plan(d, sd, group, B, path);
  const int out[] = {cp.rows,     cp.res_fwd,  cp.state_fwd, cp.smem_fwd, cp.res_bwd,
                     cp.walk_rows, cp.smem_bwd, cp.image,     cp.share};
  for (int i = 0; i < 9; ++i) info[i] = out[i];
  return cp.cluster;
}
