// K3's and K4's wide paths: the whole fixed-step RK4 solve (K3) and its
// exact discrete backward (K4) as chains of dense products over the whole
// batch, for nets of h >= kSolveWideMinH.
//
// Replaces continuousnormalizingflows_tpu/ops/pallas_solve.py
// _solve_fwd_kernel (:176) and _solve_bwd_kernel (:206) at these widths.
// They compute what the plain versions fused_solve_rk4_reference and
// fused_solve_rk4_bwd_reference compute.
//
// What bounds them on an H100: operations.  At the digits-shaped fit (65 ->
// 256 -> 256 -> 64, B = 256, rk4-24) K3 needs 4.4 G FMA (9.0 us at the 989
// TFLOP/s bf16 tensor-core peak) and K4 about three times that, against a
// few MB of inputs and outputs.  The tiled path these replace there
// (fused_solve.cu, fused_solve_bwd.cu) fitted 7 rows a block, 37 blocks on
// 132 SMs, each running the whole solve as products of 7 rows at a time on
// the CUDA cores, re-reading the 396 KB of fp32 weights from L2 for every
// stage of every tile, and (K4) adding its weight-gradient terms as rank-1
// updates of a (grid, P) buffer.  Here every product takes the whole batch
// as its M, split over output tiles (wide_gemm.cuh: bf16 on mma.sync over 64
// x 32 tiles), a weight tile is read once for every tile of rows, and the
// weight gradients are products of depth 2B over the batch, one a stage.
// The chains are launched from C++ inside the one call, on the caller's
// stream; t0 and dt stay in device memory, and every time and RK4 weight is
// formed on the card.  Measured there (PERF.md section 6): K4 17.2 ms and K3
// 4.1 ms by CUDA events in bf16, against the tiled path's 84.4-85.3 and
// 24.7-25.1 in the same run.
//
// In fp32 (true fp32 on the CUDA cores, the benchmark's d43 fit: 88 -> 352
// -> 352 -> 87, B = 8,192, rk4-32) the products are what bounds them: 713
// GFLOP a K3 call, 2.8 TFLOP a K4 call, 10.6 and 42 ms at the 67 TFLOP/s
// fp32 peak.  The first fp32 core (64 x 32 tiles, a 4 x 4 register tile a
// thread) spent two shared reads on 16 FMAs and ran 18.5 TFLOP/s on a lone
// 352-wide product; in the chains, with the epilogues' reads and writes, K4
// took 226 ms and K3 54.  The Hopper tiles (128 x 96 and 64 x 96 of 256
// threads, 8 x 6 and 4 x 6 a thread, both operands copied by cp.async as
// they lie in device memory, the outputs through shared memory into the
// epilogue a row at a time) run 27-30 TFLOP/s on the 352-wide products and
// 18-20 on the 87-wide ones; a launch takes the tile whose grid fits the
// card in the fewest waves, and the weight gradients the slices of theirs.
// What is left in the chains is mostly the epilogues: each element's loads
// wait in turn for device memory, 20-55 us a product.
//
// K3, the forward (solve_fwd), launches:
//   C   (bf16) eps, A1, A2, A3 -> their bf16 copies (convert_inputs<3>)
//   I   X = [z, t0, ys] of u0 (solve_inputs), U = u0
//   U   u2 = eps A3, once: eps is fixed over the solve
//   then each of the 4 steps x stages, K1's wide forward on X:
//   F1  z1 = X A1^T + b1 -> s1, h1      F2  z2 = h1 A2^T + b2 -> s2, h2, d2 = u2 s2
//   F3  y = h2 A3^T + b3, and F4  u1 = d2 A2 -> d1 = u1 s1 (one launch)
//   F5  e_z = d1 A1[:, :nz]
//   R   div, |y|, |e_z| of each row, du = [y, -div, |y|, |e_z|], and the RK4
//       step: the accumulator and the next stage's X, or u after the step
//       (solve_rk4_stage; into u1 after the last)
// 5 launches a stage: 480 for rk4-24.
//
// K4, the backward (solve_bwd), the chain of fused_solve_bwd.cu's header:
//   C, I, U as K3 (u2 once; the state cotangent's z columns A = gbar[:, :nz]:
//       its columns past nz never change, no stage input reaches them)
//   the trajectory: steps - 1 steps of 4 stage forwards that compute y only
//       (F1, F2, then F3 with the RK4 step in its epilogue, kStep), storing
//       each step's z in traj.  The last step's end state is not needed.
//   the walk back, for step n = steps - 1 ... 0:
//       X0 = [z_n, t_n, ys] from traj (solve_load_x, but for the last step)
//       k1..k3 again (y only) -> the stage inputs v1, v2, v3 in X1, X2, X3
//       then stages 4, 3, 2, 1 at X3, X2, X1, X0, each K2's wide chain:
//       F1-F5 (d2 from the call's u2), K4's merge (solve_merge: the stage's
//       cotangent dub = ca a + cv vb as the cotangents of y, div, |y| and
//       |e_z|, ebar = 0), B1, B2, B3 (z2_t only), B4, then B5: the input
//       cotangent's z columns vb = z1_t A1[:, :nz] (a_new += vb) and the
//       weight gradients dA1 += z1_t^T x + d1^T [ebar_t, 0], dA2 += z2_t^T h1
//       + d2^T u1bar, dA3 += ybar_t^T h2, accumulated in a fixed order
//       (where the batch is cut into slices, solve_add_slices adds them)
//   E   epsbar = sum of divbar e_z + (sum of u2bar) A3^T and dA3 += eps^T
//       (sum of u2bar): the terms linear in u2bar once a call, on u2bar
//       summed over the stages; u0bar = [a, gbar[:, nz:]]
//   db  the bias gradients, column sums of z1_t, z2_t and ybar_t summed over
//       the stages (wide_bias_sums<4>)
// 3 launches a y-only stage and 10 a stage backward (11 with slices): for
// rk4-24 at the digits-shaped widths (2 slices) 1,575 in fp32, 1,577 in bf16.
//
// Every sum over the solve (the weight gradients, u2bar, z1_t, z2_t, ybar_t,
// divbar e_z) is added in stream order, each element by its own thread: the
// same bits on every call, no atomics.
//
// precision: as the wide stage (wide_stage_fwd.cuh): with BF16 every product
// reads bfloat16 copies of its operands (rounded to nearest even) and
// accumulates in fp32; the states, the RK4 sums, the epilogues and the sums
// over the solve stay fp32.  The two terms linear in u2bar round its fp32
// sum over the stages once, where the plain version rounds each stage's.
#pragma once

#include "wide_stage_bwd.cuh"

namespace cnf {
namespace wide {

// The narrowest hidden width whose solves take the wide path; K3 and K4
// keep their row paths (h <= 32) and their tiled path between.  Measured on
// an H100 (chip_profile.py solve-wide, PERF.md section 6), device ms wide /
// tiled, 4 steps at 6 -> h -> h -> 5 and B = 256, 8,192, 65,536: from h = 64
// both win in bf16 at every batch (K4 1.98 / 2.30, 2.50 / 6.95, 12.60 /
// 55.49; K3 0.43 / 0.61, 0.52 / 0.80, 3.32 / 3.83); at h = 48 K3 loses at
// the two larger batches and K4 at B = 256.  At h = 64 in fp32 K3 loses at
// every batch and K4 at B = 256 (about 5 launches a stage are a floor of
// ~0.1 ms a step); from h = 96 both win in fp32 but K4 at B = 256 by 1 %.
constexpr int kSolveWideMinH = 64;

// The time of stage j (0 ... 3) of step i: t, t + dt/2, t + dt/2, t + dt,
// with t = t0 + i dt, as the plain version forms them.
__device__ __forceinline__ float stage_time(float t0, float dt, int i, int j) {
  const float t = t0 + (float)i * dt;
  return j == 0 ? t : j == 3 ? t + dt : t + 0.5f * dt;
}

// The weight of k_j in the input of stage j + 1 (j < 3): dt/2, dt/2, dt.
__device__ __forceinline__ float stage_step(float dt, int j) { return j == 2 ? dt : 0.5f * dt; }

// K4's epilogue cases beyond K2's.
enum SolveCase : int { kYF1 = kGrad + 1, kYF2, kStep, kVb };

// ---- the scratch ----

// K3: S1, S2, U2 (B x h), Y, E (B x nz), U, ACC (B x sd) in fp32; then the
// operands H1 (also D1), H2, D2 (B x h) and X (B x n_in), fp32, or in bf16
// rows padded to 8 and the copies of the inputs, X in their x slot.
inline long solve_fwd_fp32_floats(const Dims& d, int B) {
  return (long)B * (3L * d.h + 2L * d.nz + 2L * (d.nz + 3));
}

inline long solve_fwd_scratch_floats(const Dims& d, int B) {
  const long f32 = solve_fwd_fp32_floats(d, B);
  const long fp32 = f32 + (long)B * (3L * d.h + d.n_in);
  const long halves = 3L * B * pad8(d.h) + input_copy_halves(d, B);
  const long bf16 = ((f32 + 3) & ~3L) + (halves + 1) / 2;
  return fp32 > bf16 ? fp32 : bf16;
}

// K4: the sums over the solve U2B, ZS1, ZS2 (B x h), YBS, EPSB (B x nz), then
// S1, S2, U1, U2, U2c (B x h), Y, E, VB (also ACC), A, AN (B x nz) in fp32;
// then the operands H1, H2, D1, D2, G1 (B x h), YB, EB (B x nz) and the
// stage inputs X0 ... X3 (B x n_in), fp32, or in bf16 H1 ... G1, Z1, Z2 and
// YB, EB and X0 ... X3 rows padded to 8, and the copies of the inputs.  The
// trajectory (steps x B x nz) is the caller's traj.
inline long solve_bwd_fp32_floats(const Dims& d, int B) {
  return (long)B * (8L * d.h + 7L * d.nz);
}

inline long solve_bwd_scratch_floats(const Dims& d, int B) {
  const long f32 = solve_bwd_fp32_floats(d, B);
  const long fp32 = f32 + (long)B * (5L * d.h + 2L * d.nz + 4L * d.n_in);
  const long halves = (long)B * (7L * pad8(d.h) + 2L * pad8(d.nz) + 4L * pad8(d.n_in)) +
                      input_copy_halves(d, B);
  const long bf16 = ((f32 + 3) & ~3L) + (halves + 1) / 2;
  return fp32 > bf16 ? fp32 : bf16;
}

// ---- K3 ----

// K3's epilogues: K1's forward, with d2 = u2 s2 from the call's u2 in F2's.
template <bool BF16>
struct SolveFwdEpi {
  using T = std::conditional_t<BF16, bf16, float>;
  int h, nz, ldt;
  const float *b1, *b2, *b3;
  float *S1, *S2, *U2;   // (B, h)
  T *H1, *H2, *D1, *D2;  // (B, ldt); D1 shares H1's array
  float *Y, *E;          // (B, nz)

  __device__ __forceinline__ void operator()(const Product& p, int, int m, int n,
                                             float a) const {
    const long i = (long)m * h + n, it = (long)m * ldt + n;
    switch (p.epi) {
      case kF1: gate_into(a + b1[n], S1, i, H1, it); break;
      case kF2:
        gate_into(a + b2[n], S2, i, H2, it);
        put(D2, it, U2[i] * S2[i]);
        break;
      case kY: Y[(long)m * nz + n] = a + b3[n]; break;
      case kU2: U2[i] = a; break;
      case kU1: put(D1, it, S1[i] * a); break;
      default: E[(long)m * nz + n] = a;  // kE
    }
  }
};

namespace {

// Blocks of 256 threads for a grid-stride loop over n elements.
inline int grid_of(long n) { return (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096); }

// I: `count` stage inputs of B rows, X = [z, t0, ys] (rows of ldx, zero
// past n_in) from u0's z columns, t0 and ys.  Owner: the kernel that
// launches it (3: K3, 4: K4), so that a profile tells them apart.
template <int Owner, class T>
__global__ void __launch_bounds__(256)
solve_inputs(const float* __restrict__ u0, const float* __restrict__ ys,
             const float* __restrict__ t0p, T* __restrict__ X, int count, int B, int nz,
             int nc, int t_col, int ldx) {
  const int ys_off = nz + (t_col >= 0 ? 1 : 0), sd = nz + 3;
  const float t0 = *t0p;
  const long n = (long)count * B * ldx;
  for (long idx = (long)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (long)gridDim.x * blockDim.x) {
    const long r = (idx / ldx) % B;
    const int c = (int)(idx % ldx);
    float v = 0.0f;
    if (c < nz) v = u0[r * sd + c];
    else if (c == t_col) v = t0;
    else if (c >= ys_off && c < ys_off + nc) v = ys[r * nc + c - ys_off];
    put(X, idx, v);
  }
}

// R: stage j of step i of K3 (tpr threads a row, wide::row_threads; 256 /
// tpr rows a block).  div = <e_z, eps>, |y| and |e_z| (floored at 1e-20
// under the root), du = [y, -div, |y|, |e_z|]; then for j < 3 ACC = k1 (j =
// 0) or ACC + 2 k and the next stage's X = [u + c dt du, t, ys], for j = 3
// u + dt/6 (ACC + k4) into U and X, or into u1 after the last step.
template <class T>
__global__ void __launch_bounds__(256)
solve_rk4_stage(const float* __restrict__ Y, const float* __restrict__ E,
                const float* __restrict__ eps, float* __restrict__ U, float* __restrict__ ACC,
                T* __restrict__ X, float* __restrict__ u1, const float* __restrict__ t0p,
                const float* __restrict__ dtp, int B, int nz, int ldx, int t_col, int i, int j,
                int tpr) {
  __shared__ float part[3][8];
  const int lt = threadIdx.x % tpr;  // the thread within its row
  const long row = (long)blockIdx.x * (256 / tpr) + threadIdx.x / tpr;
  const bool in = row < B;
  float s[3] = {0.0f, 0.0f, 0.0f};  // <e_z, eps>, sum y^2, sum e_z^2
  if (in) {
    const float *yr = Y + row * nz, *er = E + row * nz, *pr = eps + row * nz;
    for (int k = lt; k < nz; k += tpr) {
      s[0] = fmaf(er[k], pr[k], s[0]);
      s[1] = fmaf(yr[k], yr[k], s[1]);
      s[2] = fmaf(er[k], er[k], s[2]);
    }
  }
  row_sums(s, part, tpr);
  if (!in) return;
  const float dt = *dtp, t0 = *t0p;
  const float ry = sqrtf(s[1] + 1e-20f), re = sqrtf(s[2] + 1e-20f);
  const int sd = nz + 3;
  for (int c = lt; c < sd; c += tpr) {
    const float k = c < nz ? Y[row * nz + c] : c == nz ? -s[0] : c == nz + 1 ? ry : re;
    const long q = row * sd + c;
    if (j == 3) {
      const float un = U[q] + (dt / 6.0f) * (ACC[q] + k);
      if (u1) {
        u1[q] = un;
      } else {
        U[q] = un;
        if (c < nz) put(X, row * ldx + c, un);
      }
    } else {
      ACC[q] = j == 0 ? k : ACC[q] + 2.0f * k;
      if (c < nz) put(X, row * ldx + c, U[q] + stage_step(dt, j) * k);
    }
  }
  if (lt == 0 && t_col >= 0 && !u1)
    put(X, row * ldx + t_col,
        j == 3 ? stage_time(t0, dt, i + 1, 0) : stage_time(t0, dt, i, j + 1));
}

}  // namespace

// K3's wide path on the caller's stream.  scratch: solve_fwd_scratch_floats(d,
// B) floats.  n_out == nz, sd == nz + 3.
template <bool BF16>
cudaError_t solve_fwd(const float* u0, const float* eps, const float* ys, const Weights& w,
                      const Dims& d, const float* t0, const float* dt, float* u1, float* scratch,
                      int B, int nc, int t_col, int steps, cudaStream_t stream) {
  const int h = d.h, nz = d.nz, n_in = d.n_in, sd = nz + 3;
  if (steps <= 0)
    return cudaMemcpyAsync(u1, u0, (size_t)B * sd * sizeof(float), cudaMemcpyDeviceToDevice,
                           stream);
  using T = typename SolveFwdEpi<BF16>::T;
  SolveFwdEpi<BF16> e{h, nz, BF16 ? pad8(h) : h, w.b1, w.b2, w.b3};
  float* p = scratch;
  auto take = [&](long n) {
    float* q = p;
    p += n;
    return q;
  };
  const long Bh = (long)B * h, Bz = (long)B * nz;
  e.S1 = take(Bh);
  e.S2 = take(Bh);
  e.U2 = take(Bh);
  e.Y = take(Bz);
  e.E = take(Bz);
  float* U = take((long)B * sd);
  float* ACC = take((long)B * sd);
  // the operands the products read: fp32, the inputs themselves
  FwdOperands f{nullptr, eps, w.A1, w.A2, w.A3, nullptr, nullptr, nullptr, nullptr, n_in, nz, h};
  T* X;
  if constexpr (BF16) {
    bf16* q = reinterpret_cast<bf16*>(scratch + ((solve_fwd_fp32_floats(d, B) + 3) & ~3L));
    e.H1 = q;
    e.H2 = q + (long)B * e.ldt;
    e.D2 = q + 2L * B * e.ldt;
    CNF_WIDE_TRY(convert_inputs<3>(nullptr, eps, w, d, B, q + 3L * B * e.ldt, f, stream));
    X = const_cast<bf16*>(static_cast<const bf16*>(f.X));
    if (h & 7)  // the padding of the rows the epilogues write, zero
      CNF_WIDE_TRY(cudaMemsetAsync(q, 0, 3L * B * e.ldt * sizeof(bf16), stream));
  } else {
    e.H1 = take(Bh);
    e.H2 = take(Bh);
    e.D2 = take(Bh);
    X = take((long)B * n_in);
  }
  e.D1 = e.H1;
  const int ldh = f.ldh, ldz = f.ldz, ldi = f.ldi;
  const void *A1 = f.A1, *A2 = f.A2, *A3 = f.A3;

  solve_inputs<3><<<grid_of((long)B * ldi), 256, 0, stream>>>(u0, ys, t0, X, 1, B, nz, nc, t_col,
                                                               ldi);
  CNF_WIDE_TRY(cudaGetLastError());
  CNF_WIDE_TRY(cudaMemcpyAsync(U, u0, (size_t)B * sd * sizeof(float), cudaMemcpyDeviceToDevice,
                               stream));
  CNF_WIDE_TRY(run<BF16>(e, {product(by_row(f.EPS, ldz, B), by_col(A3, ldh, h), B, h, nz, kU2)},
                         stream));
  const int tpr = row_threads(nz), rows = 256 / tpr;
  for (int i = 0; i < steps; ++i) {
    for (int j = 0; j < 4; ++j) {
      CNF_WIDE_TRY(run<BF16>(e, {product(by_row(X, ldi, B), by_row(A1, ldi, h), B, h, n_in,
                                         kF1)}, stream));
      CNF_WIDE_TRY(run<BF16>(e, {product(by_row(e.H1, ldh, B), by_row(A2, ldh, h), B, h, h,
                                         kF2)}, stream));
      CNF_WIDE_TRY(run<BF16>(e, {product(by_row(e.H2, ldh, B), by_row(A3, ldh, nz), B, nz, h,
                                         kY),
                                 product(by_row(e.D2, ldh, B), by_col(A2, ldh, h), B, h, h,
                                         kU1)}, stream));
      CNF_WIDE_TRY(run<BF16>(e, {product(by_row(e.D1, ldh, B), by_col(A1, ldi, nz), B, nz, h,
                                         kE)}, stream));
      solve_rk4_stage<<<(B + rows - 1) / rows, 256, 0, stream>>>(
          e.Y, e.E, eps, U, ACC, X, i == steps - 1 && j == 3 ? u1 : nullptr, t0, dt, B, nz, ldi,
          t_col, i, j, tpr);
      CNF_WIDE_TRY(cudaGetLastError());
    }
  }
  return cudaSuccess;
}

// ---- K4 ----

// K4's epilogues: the y-only stage forwards with the RK4 step in F3's
// (kYF1, kYF2, kStep), u2 once a call (kU2), K2's chain with d2 from the
// call's u2 (kF1 ... kZ1), sums over the solve where K2 writes a stage's
// values (u2bar into U2B, z1_t and z2_t into ZS1, ZS2), the input
// cotangent vb (kVb), the weight gradients accumulated (kGrad), and epsbar
// and u0bar once a call (kEpsbar).  T: the type of the arrays only products
// read (rows of ldt); Z1 and Z2 are the bf16 copies of z1_t and z2_t (in
// fp32 the products read U1 and U2).
template <bool BF16>
struct SolveBwdEpi {
  using T = std::conditional_t<BF16, bf16, float>;
  int h, nz, ldt, ldx, t_col;
  int step, stage;  // kStep: the stage being run, its step's z (TZ), the next input Xn
  int first;        // kVb: the first stage backward of a step (AN = A + vb)
  long P;
  const float *b1, *b2, *b3, *t0p, *dtp;
  float *S1, *S2, *U1, *U2, *U2c, *U2B, *ZS1, *ZS2;  // (B, h)
  T *H1, *H2, *D1, *D2, *G1, *Z1, *Z2;               // (B, ldt)
  float *Y, *E, *ACC, *VB, *AN;                      // (B, nz)
  const float *TZ, *A, *EPSB, *gbar;
  float *TZn, *grads, *partial, *epsbar, *u0bar;
  T* Xn;

  // kStep: k = y of stage `stage` of step `step` on TZ's z; the next input
  // Xn = [z + c dt k, t] (ACC: the trajectory's RK4 sum, else none), or
  // after the fourth stage z + dt/6 (ACC + k) into TZn and Xn.
  __device__ __forceinline__ void step_into(int m, int n, long q, float k) const {
    const float dt = *dtp, t0 = *t0p;
    const float z = TZ[q];
    const long x = (long)m * ldx;
    if (stage < 3) {
      if (ACC) ACC[q] = stage == 0 ? k : ACC[q] + 2.0f * k;
      put(Xn, x + n, z + stage_step(dt, stage) * k);
      if (n == 0 && t_col >= 0) put(Xn, x + t_col, stage_time(t0, dt, step, stage + 1));
    } else {
      const float zn = z + (dt / 6.0f) * (ACC[q] + k);
      TZn[q] = zn;
      put(Xn, x + n, zn);
      if (n == 0 && t_col >= 0) put(Xn, x + t_col, stage_time(t0, dt, step + 1, 0));
    }
  }

  __device__ __forceinline__ void operator()(const Product& p, int slice, int m, int n,
                                             float a) const {
    const long i = (long)m * h + n, it = (long)m * ldt + n, q = (long)m * nz + n;
    switch (p.epi) {
      case kYF1: {
        float sg, sp;
        gates(a + b1[n], sg, sp);
        put(H1, it, sp);
        break;
      }
      case kYF2: {
        float sg, sp;
        gates(a + b2[n], sg, sp);
        put(H2, it, sp);
        break;
      }
      case kStep: step_into(m, n, q, a + b3[n]); break;
      case kU2: U2c[i] = a; break;
      case kF1: gate_into(a + b1[n], S1, i, H1, it); break;
      case kF2:
        gate_into(a + b2[n], S2, i, H2, it);
        put(D2, it, U2c[i] * S2[i]);
        break;
      case kY: Y[q] = a + b3[n]; break;
      case kU1: U1[i] = a; put(D1, it, S1[i] * a); break;
      case kE: E[q] = a; break;
      case kB1: {
        const float sg = S1[i];
        put(G1, it, a * sg);
        U1[i] = a * U1[i] * sg * (1.0f - sg);
        break;
      }
      case kB2: {
        const float sg = S2[i];
        U2B[i] += a * sg;
        U2[i] = a * U2c[i] * sg * (1.0f - sg);
        break;
      }
      case kZ2: {
        const float z = a * S2[i] + U2[i];
        U2[i] = z;
        if constexpr (BF16) put(Z2, it, z);
        ZS2[i] += z;
        break;
      }
      case kZ1: {
        const float z = a * S1[i] + U1[i];
        U1[i] = z;
        if constexpr (BF16) put(Z1, it, z);
        ZS1[i] += z;
        break;
      }
      case kVb:
        VB[q] = a;
        AN[q] = (first ? A[q] : AN[q]) + a;
        break;
      case kEpsbar: {
        const int sd = nz + 3;
        epsbar[q] = EPSB[q] + a;
        u0bar[(long)m * sd + n] = A[q];
        if (n == 0)
          for (int c = nz; c < sd; ++c) u0bar[(long)m * sd + c] = gbar[(long)m * sd + c];
        break;
      }
      default: {  // kGrad
        const long g = p.out + (long)m * p.N + n;
        if (p.slices > 1)
          partial[slice * P + g] = a;
        else
          grads[g] += a;
      }
    }
  }
};

namespace {

// X0 = [z_n, t_n, ys] for step n of the walk back: the z columns from the
// trajectory, the time (ys and the padding stay from solve_inputs).
template <class T>
__global__ void __launch_bounds__(256)
solve_load_x(const float* __restrict__ tz, const float* __restrict__ t0p,
             const float* __restrict__ dtp, int n, T* __restrict__ X, int B, int nz, int t_col,
             int ldx) {
  const long cnt = (long)B * (nz + 1);
  for (long idx = (long)blockIdx.x * blockDim.x + threadIdx.x; idx < cnt;
       idx += (long)gridDim.x * blockDim.x) {
    const long r = idx / (nz + 1);
    const int c = (int)(idx % (nz + 1));
    if (c < nz)
      put(X, r * ldx + c, tz[r * nz + c]);
    else if (t_col >= 0)
      put(X, r * ldx + t_col, stage_time(*t0p, *dtp, n, 0));
  }
}

// K4's merged cotangents of stage st (3: k4 ... 0: k1) of a step, tpr threads
// a row, 256 / tpr rows a block.  The stage's cotangent is dub = ca a + cv vb
// (ca = dt/6, dt/3, dt/3, dt/6 and cv = 0, dt, dt/2, dt/2 for st = 3 ... 0;
// vb the input cotangent of the stage after it), read as the cotangents of
// the stage's outputs: ybar = dub[:nz], ebar = 0, divbar = -dub[nz], rzbar =
// dub[nz + 1], rjbar = dub[nz + 2], whose a columns are gbar's.  Then as
// wide_merge: ybar_t = ybar + rzbar y / |y|, ebar_t = divbar eps + rjbar e_z
// / |e_z|, and the sums over the solve YBS += ybar_t (db3) and EPSB +=
// divbar e_z (epsbar's term outside the products).
__global__ void __launch_bounds__(256)
solve_merge(const float* __restrict__ A, const float* __restrict__ VB,
            const float* __restrict__ gbar, const float* __restrict__ eps,
            const float* __restrict__ Y, const float* __restrict__ E,
            const float* __restrict__ dtp, int st, float* __restrict__ YB,
            float* __restrict__ EB, bf16* __restrict__ YB16, bf16* __restrict__ EB16,
            float* __restrict__ YBS, float* __restrict__ EPSB, int ldz, int B, int nz, int tpr) {
  __shared__ float part[2][8];
  const int lt = threadIdx.x % tpr;  // the thread within its row
  const long row = (long)blockIdx.x * (256 / tpr) + threadIdx.x / tpr;
  const bool in = row < B;
  const float* y = Y + row * nz;
  const float* e = E + row * nz;
  float ss[2] = {0.0f, 0.0f};  // sum y^2, sum e_z^2
  if (in)
    for (int k = lt; k < nz; k += tpr) {
      ss[0] = fmaf(y[k], y[k], ss[0]);
      ss[1] = fmaf(e[k], e[k], ss[1]);
    }
  row_sums(ss, part, tpr);
  if (!in) return;
  const float dt = *dtp;
  const float ca = st == 0 || st == 3 ? dt / 6.0f : dt / 3.0f;
  const float cv = st == 2 ? dt : 0.5f * dt;
  const float* g = gbar + row * (nz + 3) + nz;
  const float dv = -(ca * g[0]), rz = ca * g[1], rj = ca * g[2];
  const float ry = sqrtf(ss[0] + 1e-20f), re = sqrtf(ss[1] + 1e-20f);
  for (int k = lt; k < nz; k += tpr) {
    const long q = row * nz + k;
    const float yb = st == 3 ? ca * A[q] : ca * A[q] + cv * VB[q];
    const float v = yb + rz * y[k] / ry;
    const float eb = dv * eps[q] + rj * e[k] / re;
    YBS[q] += v;
    EPSB[q] += dv * e[k];
    if (YB16) {
      YB16[row * ldz + k] = __float2bfloat16_rn(v);
      EB16[row * ldz + k] = __float2bfloat16_rn(eb);
    } else {
      YB[q] = v;
      EB[q] = eb;
    }
  }
  if (YB16)  // the rows' padding, zero (wide_gemm.cuh reads it)
    for (int k = nz + lt; k < ldz; k += tpr) {
      YB16[row * ldz + k] = __float2bfloat16_rn(0.0f);
      EB16[row * ldz + k] = __float2bfloat16_rn(0.0f);
    }
}

// grads[p] += the sum over slices s of partial[s][p], in order of s, for the
// entries of the three weight matrices: a stage's weight gradients where its
// products are cut into slices.
__global__ void __launch_bounds__(256)
solve_add_slices(const float* __restrict__ partial, int S, Offsets o, float* __restrict__ grads) {
  const long p = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= o.P) return;
  if ((p >= o.b1 && p < o.A2) || (p >= o.b2 && p < o.A3) || p >= o.b3) return;
  float s = 0.0f;
  for (int q = 0; q < S; ++q) s += partial[(long)q * o.P + p];
  grads[p] += s;
}

}  // namespace

// K4's wide path on the caller's stream.  traj: steps x B x nz floats;
// partial: slices x P floats when wgrad_slices(d, B, BF16) > 1; scratch:
// solve_bwd_scratch_floats(d, B) floats.  n_out == nz, sd == nz + 3.
template <bool BF16>
cudaError_t solve_bwd(const float* u0, const float* eps, const float* ys, const Weights& w,
                      const Dims& d, const float* t0, const float* dt, const float* gbar,
                      float* u0bar, float* epsbar, float* traj, float* partial, float* scratch,
                      float* grads, int B, int nc, int t_col, int steps, cudaStream_t stream) {
  const int h = d.h, nz = d.nz, n_in = d.n_in, sd = nz + 3;
  const Offsets o = offsets(d);
  const int slices = wgrad_slices(d, B, BF16);
  using T = typename SolveBwdEpi<BF16>::T;
  SolveBwdEpi<BF16> e{};
  e.h = h;
  e.nz = nz;
  e.ldt = BF16 ? pad8(h) : h;
  e.ldx = BF16 ? pad8(n_in) : n_in;
  e.t_col = t_col;
  e.P = o.P;
  e.b1 = w.b1;
  e.b2 = w.b2;
  e.b3 = w.b3;
  e.t0p = t0;
  e.dtp = dt;
  e.gbar = gbar;
  e.grads = grads;
  e.partial = partial;
  e.epsbar = epsbar;
  e.u0bar = u0bar;
  float* p = scratch;
  auto take = [&](long n) {
    float* q = p;
    p += n;
    return q;
  };
  const long Bh = (long)B * h, Bz = (long)B * nz;
  // the sums over the solve first, zeroed by one memset
  e.U2B = take(Bh);
  e.ZS1 = take(Bh);
  e.ZS2 = take(Bh);
  float* YBS = take(Bz);
  float* EPSB = take(Bz);
  const long zeroed = p - scratch;
  e.S1 = take(Bh);
  e.S2 = take(Bh);
  e.U1 = take(Bh);
  e.U2 = take(Bh);
  e.U2c = take(Bh);
  e.Y = take(Bz);
  e.E = take(Bz);
  e.VB = take(Bz);
  float* A = take(Bz);
  float* AN = take(Bz);
  float *YB = nullptr, *EB = nullptr;  // fp32 ybar_t, ebar_t (the fp32 chain's operands)
  bf16 *YB16 = nullptr, *EB16 = nullptr;
  FwdOperands f{nullptr, eps, w.A1, w.A2, w.A3, nullptr, nullptr, nullptr, nullptr, n_in, nz, h};
  T* X[4];
  if constexpr (BF16) {
    bf16* q = reinterpret_cast<bf16*>(scratch + ((solve_bwd_fp32_floats(d, B) + 3) & ~3L));
    bf16* ops = q;
    auto take16 = [&](long n) {
      bf16* r = q;
      q += n;
      return r;
    };
    for (T** a : {&e.H1, &e.H2, &e.D1, &e.D2, &e.G1, &e.Z1, &e.Z2}) *a = take16((long)B * e.ldt);
    YB16 = take16((long)B * pad8(nz));
    EB16 = take16((long)B * pad8(nz));
    for (int j = 0; j < 4; ++j) X[j] = take16((long)B * e.ldx);
    CNF_WIDE_TRY(convert_inputs<4>(nullptr, eps, w, d, B, q, f, stream));
    if (h & 7)  // the padding of the rows the epilogues write, zero
      CNF_WIDE_TRY(cudaMemsetAsync(ops, 0, 7L * B * e.ldt * sizeof(bf16), stream));
  } else {
    for (T** a : {&e.H1, &e.H2, &e.D1, &e.D2, &e.G1}) *a = take(Bh);
    YB = take(Bz);
    EB = take(Bz);
    for (int j = 0; j < 4; ++j) X[j] = take((long)B * n_in);  // contiguous
  }
  const int ldh = f.ldh, ldz = f.ldz, ldi = f.ldi;
  const void *A1 = f.A1, *A2 = f.A2, *A3 = f.A3, *EPS = f.EPS;
  const void* YBo = BF16 ? static_cast<const void*>(YB16) : YB;
  const void* EBo = BF16 ? static_cast<const void*>(EB16) : EB;
  const void* Z1o = BF16 ? static_cast<const void*>(e.Z1) : e.U1;
  const void* Z2o = BF16 ? static_cast<const void*>(e.Z2) : e.U2;

  CNF_WIDE_TRY(cudaMemsetAsync(scratch, 0, zeroed * sizeof(float), stream));
  CNF_WIDE_TRY(cudaMemsetAsync(grads, 0, o.P * sizeof(float), stream));
  if (slices > 1)  // a product cut into fewer slices leaves its rows past them zero
    CNF_WIDE_TRY(cudaMemsetAsync(partial, 0, slices * o.P * sizeof(float), stream));
  // the four stage inputs, contiguous: X[1 ...] take their ys and padding
  // here, z and t with each step
  solve_inputs<4><<<grid_of(4L * B * ldi), 256, 0, stream>>>(u0, ys, t0, X[0], 4, B, nz, nc,
                                                                t_col, ldi);
  CNF_WIDE_TRY(cudaGetLastError());
  const size_t zrow = nz * sizeof(float), srow = sd * sizeof(float);
  CNF_WIDE_TRY(cudaMemcpy2DAsync(traj, zrow, u0, srow, zrow, B, cudaMemcpyDeviceToDevice, stream));
  CNF_WIDE_TRY(cudaMemcpy2DAsync(A, zrow, gbar, srow, zrow, B, cudaMemcpyDeviceToDevice, stream));
  CNF_WIDE_TRY(run<BF16>(e, {product(by_row(EPS, ldz, B), by_col(A3, ldh, h), B, h, nz, kU2)},
                         stream));

  // stage j of step i, y only, from input Xin; kStep forms the next input
  auto y_only = [&](const T* Xin, int i, int j, const float* tz, float* tzn, float* acc,
                    T* xn) {
    e.step = i;
    e.stage = j;
    e.TZ = tz;
    e.TZn = tzn;
    e.ACC = acc;
    e.Xn = xn;
    CNF_WIDE_TRY(run<BF16>(e, {product(by_row(Xin, ldi, B), by_row(A1, ldi, h), B, h, n_in,
                                       kYF1)}, stream));
    CNF_WIDE_TRY(run<BF16>(e, {product(by_row(e.H1, ldh, B), by_row(A2, ldh, h), B, h, h,
                                       kYF2)}, stream));
    return run<BF16>(e, {product(by_row(e.H2, ldh, B), by_row(A3, ldh, nz), B, nz, h, kStep)},
                     stream);
  };
  // the backward of stage st at input Xst; a: the step's state cotangent,
  // an: a plus the input cotangents of the step's stages taken so far
  const int tpr = row_threads(nz), rows = 256 / tpr;
  auto stage_back = [&](const T* Xst, int st, const float* a, float* an) {
    CNF_WIDE_TRY(run<BF16>(e, {product(by_row(Xst, ldi, B), by_row(A1, ldi, h), B, h, n_in,
                                       kF1)}, stream));
    CNF_WIDE_TRY(run<BF16>(e, {product(by_row(e.H1, ldh, B), by_row(A2, ldh, h), B, h, h,
                                       kF2)}, stream));
    CNF_WIDE_TRY(run<BF16>(e, {product(by_row(e.H2, ldh, B), by_row(A3, ldh, nz), B, nz, h, kY),
                               product(by_row(e.D2, ldh, B), by_col(A2, ldh, h), B, h, h,
                                       kU1)}, stream));
    CNF_WIDE_TRY(run<BF16>(e, {product(by_row(e.D1, ldh, B), by_col(A1, ldi, nz), B, nz, h,
                                       kE)}, stream));
    solve_merge<<<(B + rows - 1) / rows, 256, 0, stream>>>(a, e.VB, gbar, eps, e.Y, e.E, dt, st,
                                                           YB, EB, YB16, EB16, YBS, EPSB, ldz,
                                                           B, nz, tpr);
    CNF_WIDE_TRY(cudaGetLastError());
    CNF_WIDE_TRY(run<BF16>(e, {product(by_row(EBo, ldz, B), by_row(A1, ldi, h), B, h, nz, kB1)},
                           stream));
    CNF_WIDE_TRY(run<BF16>(e, {product(by_row(e.G1, ldh, B), by_row(A2, ldh, h), B, h, h, kB2)},
                           stream));
    CNF_WIDE_TRY(run<BF16>(e, {product(by_row(YBo, ldz, B), by_col(A3, ldh, h), B, h, nz, kZ2)},
                           stream));
    CNF_WIDE_TRY(run<BF16>(e, {product(by_row(Z2o, ldh, B), by_col(A2, ldh, h), B, h, h, kZ1)},
                           stream));
    e.A = a;
    e.AN = an;
    e.first = st == 3;
    CNF_WIDE_TRY(run<BF16>(e, {
        product(by_row(Z1o, ldh, B), by_col(A1, ldi, nz), B, nz, h, kVb),
        product(by_col2(Z1o, ldh, h, e.D1, ldh, h, B), by_col2(Xst, ldi, n_in, EBo, ldz, nz, B),
                h, n_in, 2 * B, kGrad, o.A1, slices),
        product(by_col2(Z2o, ldh, h, e.D2, ldh, h, B), by_col2(e.H1, ldh, h, e.G1, ldh, h, B), h,
                h, 2 * B, kGrad, o.A2, slices),
        product(by_col(YBo, ldz, nz), by_col(e.H2, ldh, h), nz, h, B, kGrad, o.A3, slices)},
        stream));
    if (slices > 1) {
      solve_add_slices<<<(unsigned)((o.P + 255) / 256), 256, 0, stream>>>(partial, slices, o,
                                                                          grads);
      CNF_WIDE_TRY(cudaGetLastError());
    }
    return cudaSuccess;
  };

  // the trajectory: z of u_0 ... u_{steps-1} into traj, X[0] the next step's
  // input after each (VB holds the RK4 sum)
  const long zs = Bz;
  for (int i = 0; i + 1 < steps; ++i)
    for (int j = 0; j < 4; ++j)
      CNF_WIDE_TRY(y_only(X[j], i, j, traj + i * zs, traj + (i + 1) * zs, e.VB, X[(j + 1) % 4]));
  // the walk back
  float *a = A, *an = AN;
  for (int n = steps - 1; n >= 0; --n) {
    const float* tz = traj + n * zs;
    if (n + 1 < steps) {  // X[0] holds the last step's input from the trajectory
      solve_load_x<<<grid_of((long)B * (nz + 1)), 256, 0, stream>>>(tz, t0, dt, n, X[0], B, nz,
                                                                    t_col, ldi);
      CNF_WIDE_TRY(cudaGetLastError());
    }
    for (int j = 0; j < 3; ++j) CNF_WIDE_TRY(y_only(X[j], n, j, tz, nullptr, nullptr, X[j + 1]));
    for (int st = 3; st >= 0; --st) CNF_WIDE_TRY(stage_back(X[st], st, a, an));
    float* t = a;
    a = an;
    an = t;
  }

  // E: epsbar, u0bar and dA3's eps term, on the sum of u2bar (in bf16 its
  // copy, in G1's array)
  const void* U2Bo = e.U2B;
  if constexpr (BF16) {
    Convert cv{};
    cv.src[0] = e.U2B;
    cv.dst[0] = e.G1;
    cv.rows[0] = B;
    cv.cols[0] = h;
    cv.ld[0] = ldh;
    wide_to_bf16<4><<<dim3(B < 1024 ? B : 1024, kConvert), 256, 0, stream>>>(cv);
    CNF_WIDE_TRY(cudaGetLastError());
    U2Bo = e.G1;
  }
  e.A = a;
  e.EPSB = EPSB;
  CNF_WIDE_TRY(run<BF16>(e, {product(by_row(U2Bo, ldh, B), by_row(A3, ldh, nz), B, nz, h, kEpsbar),
                             product(by_col(EPS, ldz, nz), by_col(U2Bo, ldh, h), nz, h, B, kGrad,
                                     o.A3)}, stream));
  // db: the bias gradients once a call (S1 holds the slices' partial rows)
  const int chunks = 2 * ((h + 31) / 32) + (nz + 31) / 32;
  const int bias_slices = (B + kBiasRows - 1) / kBiasRows;
  wide_bias_sums<4><<<dim3(chunks, bias_slices), dim3(32, 32), 0, stream>>>(
      e.ZS1, e.ZS2, YBS, e.S1, grads, B, h, nz, o);
  CNF_WIDE_TRY(cudaGetLastError());
  if (bias_slices > 1) {
    wide_bias_add<4><<<(2 * h + nz + 255) / 256, 256, 0, stream>>>(e.S1, bias_slices, h, nz, o,
                                                                   grads);
    CNF_WIDE_TRY(cudaGetLastError());
  }
  return cudaSuccess;
}

}  // namespace wide
}  // namespace cnf
