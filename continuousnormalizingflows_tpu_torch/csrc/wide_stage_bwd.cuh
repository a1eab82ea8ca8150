// K2's wide path: the backward of one dynamics stage as a chain of dense
// products over the whole batch, for nets of h >= 64 (kWideMinH in
// fused_dynamics_bwd.cu, with the measurement behind it).
//
// Replaces continuousnormalizingflows_tpu/ops/pallas_kernels.py _bwd_kernel
// (:182, the custom-VJP rule of _fwd_kernel) at these widths.  It computes
// what the plain version fused_dynamics_vjp_bwd_reference computes, with
// the chain of stage_bwd.cuh's header: the forward recomputed with its
// intermediates, the merged cotangents, the probe-VJP path with its
// second-order gate terms, the forward path, xbar, and the weight gradients
// in nn.Linear layout.
//
// What bounds it on an H100: operations.  At the image model (785 -> 1024 ->
// 1024 -> 784, B = 256) the function is 4.08 G FMA, 15 products of about
// 256 x 1024 x 1024: 8.2 us at the 989 TFLOP/s bf16 tensor-core peak, 0.122
// ms at the 67 TFLOP/s fp32 peak, against ~12 MB of inputs and outputs.
//
// The tiled path it replaces (stage_bwd.cuh) took 13 ms there, for four
// reasons, and the design answers each:
//   1. One row a tile: a row's shared buffers at h = 1024 filled the block,
//      so every product was a matrix-vector product.  Here every product
//      takes the whole batch as its M and is split over 64 x 32 output
//      tiles, one block each (wide_gemm.cuh): 128 blocks for a 256 x 1024
//      output, 1,328 for the three weight gradients.
//   2. The weights were not staged: each row re-read all 21 MB of them from
//      L2.  Here a weight tile is read once for every 64 rows of the batch.
//   3. Weight gradients were rank-1 updates of a (grid, P) buffer in device
//      memory (2.7 GB a launch), then added by a second kernel.  Here each
//      is one product of depth 2B over the batch (the two outer-product
//      terms' row sets joined), whose output tile one block owns and sums in
//      a fixed order.  Where the three have fewer tiles than kTargetBlocks
//      (small h at a large batch), the batch is cut into slices whose
//      partial gradients one more kernel adds in order of slice.
//   4. No tensor cores: bf16 rounded operands on the CUDA cores.  Here bf16
//      runs on mma.sync (bf16 in, fp32 accumulate) from bf16 copies of the
//      operands, which the epilogues write as they make them (and one
//      conversion launch for x, eps and the weights); fp32 stays true fp32
//      on the CUDA cores, as the "highest" contract asks.
// The intermediates (s1, h1, s2, h2, u1/z1_t, d1, u2/z2_t, d2, u1bar, u2bar,
// y, e_z, ybar_t, ebar_t) live in a scratch that the caller allocates
// (scratch_floats): fp32, and in bf16 the operands' copies beside the fp32
// values the epilogues and sums read; 17.7 MB at the image shape, inside L2.
// Measured there (PERF.md section 6): 0.23 ms in bf16 against 12.65 for the
// tiled path, 28.6 MB of device memory a call against 2.6 GB.  A product at
// M = 256 takes 16-21 us, four to five times torch.matmul's bf16 kernel.
//
// The phases, one launch each on the caller's stream (names as in
// stage_bwd.cuh; A1 (h, n_in), A2 (h, h), A3 (n_out, h)):
//   C, F1-F5  the forward (wide_stage_fwd.cuh), keeping u2 and u1 beside
//       s1, h1, s2, h2, y, d2, d1, e_z
//   R   |y|, |e_z| (32-256 threads a row)    -> ybar_t, ebar_t
//   B1  d1bar = ebar_t A1[:, :nz]^T          -> u1bar, z1_b (over u1)
//   B2  d2bar = u1bar A2^T                   -> u2bar, z2_b (over u2)
//   B3  epsbar = divbar e_z + u2bar A3^T;  z2_t = (ybar_t A3) s2 + z2_b
//   B4  z1_t = (z2_t A2) s1 + z1_b
//   B5  xbar = z1_t A1, and the weight gradients
//         dA1 = z1_t^T x + d1^T [ebar_t, 0]
//         dA2 = z2_t^T h1 + d2^T u1bar
//         dA3 = ybar_t^T h2 + eps^T u2bar
//   (the slices' partial gradients added in order, where cut)
//   db  db1, db2, db3: column sums of z1_t, z2_t, ybar_t in fp32, unrounded,
//       in slices of kBiasRows rows added in order of slice
// C and F1-F5 are K1's wide path too (wide_stage_fwd.cuh, with K1's own
// epilogue), and R's row sums its div and norms.
//
// precision: BF16 rounds both operands of every product to bfloat16, the
// weight-gradient products included, and accumulates in fp32; fp32 is true
// fp32.  The epilogues and the bias sums are fp32.
#pragma once

#include "wide_stage_fwd.cuh"

namespace cnf {
namespace wide {

// Weight-gradient tiles below which the batch is cut into slices: two blocks
// on each of the card's 132 SMs.
constexpr int kTargetBlocks = 2 * kSMs;
// The least depth of a slice.
constexpr int kMinSlice = 4 * kSliceK;
// Batch rows a block of the bias sums takes.
constexpr int kBiasRows = 1024;

// Scratch floats of the fp32 chain: z1_t, z2_t, s1, s2, h1, h2, d1, d2,
// u1bar, u2bar (B x h), ybar_t, y (B x n_out), e_z, ebar_t (B x nz).
inline long scratch_fp32(const Dims& d, int B) {
  return (long)B * (10L * d.h + 2L * d.n_out + 2L * d.nz);
}

// The bf16 chain keeps in fp32 only what an epilogue or a sum reads: z1_t,
// z2_t, s1, s2 (B x h), ybar_t, y (B x n_out), e_z (B x nz), rounded up to 16
// bytes; then the bf16 operands, rows padded to 8 elements: h1, h2, d1, d2,
// u1bar, u2bar, z1_t, z2_t (B x pad8(h)), ybar_t, ebar_t, eps (B x
// pad8(nz)), x (B x pad8(n_in)), A1 (h x pad8(n_in)), A2, A3 (h, n_out x
// pad8(h)).
inline long scratch_fp32_part_of_bf16(const Dims& d, int B) {
  return ((long)B * (4L * d.h + 2L * d.n_out + d.nz) + 3) & ~3L;
}

inline long scratch_bf16(const Dims& d, int B) {
  const long halves = (long)B * (8L * pad8(d.h) + 2L * pad8(d.nz)) + input_copy_halves(d, B);
  return scratch_fp32_part_of_bf16(d, B) + (halves + 1) / 2;
}

// Scratch floats the wrapper allocates: the larger of the two layouts.
inline long scratch_floats(const Dims& d, int B) {
  const long a = scratch_fp32(d, B), b = scratch_bf16(d, B);
  return a > b ? a : b;
}

// The parameters' offsets in the flat gradient (nn.Linear layout).
struct Offsets {
  long A1, b1, A2, b2, A3, b3, P;
};

__host__ __device__ inline Offsets offsets(const Dims& d) {
  Offsets o;
  o.A1 = 0;
  o.b1 = (long)d.h * d.n_in;
  o.A2 = o.b1 + d.h;
  o.b2 = o.A2 + (long)d.h * d.h;
  o.A3 = o.b2 + d.h;
  o.b3 = o.A3 + (long)d.n_out * d.h;
  o.P = o.b3 + d.n_out;
  return o;
}

// Slices of the weight-gradient products at these widths and batch (depth
// 2B), on the tile their launch takes: enough that their blocks come to
// kTargetBlocks, each at least kMinSlice deep.  bf16 takes 64 x 32 tiles;
// fp32 the tile of choose_f32's rule for the launch they share with the
// input cotangent's product (B x n_out x h; K2's is B x n_in x h), sliced.
inline int wgrad_slices(const Dims& d, int B, bool bf16) {
  const int K = 2 * B;
  const Operand none{};
  Launch<int> L{};
  L.p[0] = product(none, none, d.h, d.n_in, K, 0);
  L.p[1] = product(none, none, d.h, d.h, K, 0);
  L.p[2] = product(none, none, d.n_out, d.h, K, 0);
  L.p[3] = product(none, none, B, d.n_out, d.h, 0);
  const int first = kF32Tiles - 1;
  int best = 1;
  double limit = 0.0;
  for (int i = first; i >= (bf16 ? first : 0); --i) {
    L.count = 3;  // the weight gradients' tiles alone
    const long tiles = blocks_on(L, i);
    int s = 1;
    if (tiles < kTargetBlocks) {
      const int most = (K + kMinSlice - 1) / kMinSlice;
      const int want = (int)((kTargetBlocks + tiles - 1) / tiles);
      s = product(none, none, d.h, d.h, K, 0, 0, want < most ? want : most).slices;
    }
    L.count = 4;
    double cost;
    const long blocks = blocks_on(L, i, &cost) + tiles * (s - 1);
    if (i == first) {
      best = s;
      limit = 0.9 * cost;
    } else if (fills(blocks, min(B, d.h)) && cost < limit) {
      best = s;
      limit = cost;
    }
  }
  return best;
}

// Rows of the partial gradients a plan asks the caller for: the larger of
// the two precisions' slices.
inline int wgrad_rows(const Dims& d, int B) {
  const int a = wgrad_slices(d, B, true), b = wgrad_slices(d, B, false);
  return a > b ? a : b;
}

enum BwdCase : int { kB1 = kFwdCases, kB2, kEpsbar, kZ2, kZ1, kXbar, kGrad };

// The epilogues of the chain's products: element (m, n) of product p, m a
// batch row (a gradient row for kGrad).  T: the type of the arrays that only
// products read, h1, h2, d1, d2, u1bar, u2bar (rows of ldt), and, in bf16,
// the copies of z1_t and z2_t the products read.
template <bool BF16>
struct BwdEpi {
  using T = std::conditional_t<BF16, bf16, float>;
  int h, n_out, nz, n_in, ldt;
  long P;
  const float *b1, *b2, *b3, *divbar;
  float *S1, *S2, *U1, *U2;   // (B, h)
  T *H1, *H2, *D1, *D2, *G1, *G2, *Z1, *Z2;  // (B, ldt); Z1, Z2 in bf16 only
  float *Y, *YB;              // (B, n_out)
  float* E;                   // (B, nz)
  float *xbar, *epsbar, *grads, *partial;

  __device__ __forceinline__ void operator()(const Product& p, int slice, int m, int n,
                                             float a) const {
    const long i = (long)m * h + n, it = (long)m * ldt + n;
    switch (p.epi) {
      case kF1: gate_into(a + b1[n], S1, i, H1, it); break;
      case kF2: gate_into(a + b2[n], S2, i, H2, it); break;
      case kY: Y[(long)m * n_out + n] = a + b3[n]; break;
      case kU2: U2[i] = a; put(D2, it, S2[i] * a); break;
      case kU1: U1[i] = a; put(D1, it, S1[i] * a); break;
      case kE: E[(long)m * nz + n] = a; break;
      case kB1: {
        const float sg = S1[i];
        put(G1, it, a * sg);
        U1[i] = a * U1[i] * sg * (1.0f - sg);
        break;
      }
      case kB2: {
        const float sg = S2[i];
        put(G2, it, a * sg);
        U2[i] = a * U2[i] * sg * (1.0f - sg);
        break;
      }
      case kEpsbar: {
        const long j = (long)m * nz + n;
        epsbar[j] = divbar[m] * E[j] + a;
        break;
      }
      case kZ2: {
        const float z = a * S2[i] + U2[i];
        U2[i] = z;
        if constexpr (BF16) put(Z2, it, z);
        break;
      }
      case kZ1: {
        const float z = a * S1[i] + U1[i];
        U1[i] = z;
        if constexpr (BF16) put(Z1, it, z);
        break;
      }
      case kXbar: xbar[(long)m * n_in + n] = a; break;
      default:  // kGrad
        (p.slices > 1 ? partial + slice * P : grads)[p.out + (long)m * p.N + n] = a;
    }
  }
};

namespace {

// R: tpr threads a row (32 ... 256, a power of two), 256 / tpr rows a block.
// |y| and |e_z| (floored at 1e-20 under the root), then
// ybar_t = ybar + rzbar y / |y| and ebar_t = ebar + divbar eps + rjbar e_z / |e_z|.
// The sums: each thread's strided terms, then row_sums.
__global__ void __launch_bounds__(256)
wide_merge(const float* __restrict__ ybar, const float* __restrict__ ezbar,
           const float* __restrict__ eps, const float* __restrict__ divbar,
           const float* __restrict__ rzbar, const float* __restrict__ rjbar,
           const float* __restrict__ Y, const float* __restrict__ E, float* __restrict__ YB,
           float* __restrict__ EB, bf16* __restrict__ YB16, bf16* __restrict__ EB16, int ldz,
           int B, int n_out, int nz, int tpr) {
  __shared__ float part[2][8];
  const int lt = threadIdx.x % tpr;  // the thread within its row
  const long row = (long)blockIdx.x * (256 / tpr) + threadIdx.x / tpr;
  const bool in = row < B;
  const float* y = Y + row * n_out;
  const float* e = E + row * nz;
  float ss[2] = {0.0f, 0.0f};  // sum y^2, sum e_z^2
  if (in) {
    for (int o = lt; o < n_out; o += tpr) ss[0] = fmaf(y[o], y[o], ss[0]);
    for (int k = lt; k < nz; k += tpr) ss[1] = fmaf(e[k], e[k], ss[1]);
  }
  row_sums(ss, part, tpr);
  if (!in) return;
  const float ry = sqrtf(ss[0] + 1e-20f), re = sqrtf(ss[1] + 1e-20f);
  const float dv = divbar[row], rz = rzbar[row], rj = rjbar[row];
  for (int o = lt; o < n_out; o += tpr) {
    const float v = ybar[row * n_out + o] + rz * y[o] / ry;
    YB[row * n_out + o] = v;
    if (YB16) YB16[row * ldz + o] = __float2bfloat16_rn(v);
  }
  for (int k = lt; k < nz; k += tpr) {
    const float v = ezbar[row * nz + k] + dv * eps[row * nz + k] + rj * e[k] / re;
    if (EB16)
      EB16[row * ldz + k] = __float2bfloat16_rn(v);
    else
      EB[row * nz + k] = v;
  }
  if (EB16)  // the rows' padding, zero (wide_gemm.cuh reads it)
    for (int k = (n_out > nz ? n_out : nz) + lt; k < ldz; k += tpr) {
      YB16[row * ldz + k] = __float2bfloat16_rn(0.0f);
      EB16[row * ldz + k] = __float2bfloat16_rn(0.0f);
    }
}

// db1, db2, db3, the column sums of z1_t, z2_t, ybar_t over the batch:
// block (c, s) sums 32 columns over kBiasRows rows of slice s, 32 rows apart
// a thread, then the 32 partial sums in order.  With one slice it writes the
// gradients; with more, row s of part (2h + n_out floats), which
// wide_bias_add then adds in order of slice.  Owner: the kernel that
// launches it (2: K2, 4: K4's wide solve), so that a profile tells them apart.
template <int Owner>
__global__ void __launch_bounds__(1024)
wide_bias_sums(const float* __restrict__ z1t, const float* __restrict__ z2t,
               const float* __restrict__ ybt, float* __restrict__ part,
               float* __restrict__ grads, int B, int h, int n_out, Offsets o) {
  __shared__ float sums[32][33];
  const int chunks = (h + 31) / 32;
  int chunk = blockIdx.x;
  const float* src = z1t;
  int w = h, col = 0;
  long off = o.b1;
  if (chunk >= 2 * chunks) {
    chunk -= 2 * chunks;
    src = ybt;
    w = n_out;
    col = 2 * h;
    off = o.b3;
  } else if (chunk >= chunks) {
    chunk -= chunks;
    src = z2t;
    col = h;
    off = o.b2;
  }
  const int c = chunk * 32 + threadIdx.x;
  const long r0 = (long)blockIdx.y * kBiasRows, r1 = min((long)B, r0 + kBiasRows);
  float s = 0.0f;
  if (c < w)
    for (long r = r0 + threadIdx.y; r < r1; r += 32) s += src[r * w + c];
  sums[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < w) {
    float t = 0.0f;
    for (int j = 0; j < 32; ++j) t += sums[j][threadIdx.x];
    if (gridDim.y == 1)
      grads[off + c] = t;
    else
      part[(long)blockIdx.y * (2 * h + n_out) + col + c] = t;
  }
}

// The bias gradients from wide_bias_sums' rows of part, in order of slice.
template <int Owner>
__global__ void __launch_bounds__(256)
wide_bias_add(const float* __restrict__ part, int S, int h, int n_out, Offsets o,
              float* __restrict__ grads) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x, w = 2 * h + n_out;
  if (c >= w) return;
  float s = 0.0f;
  for (int q = 0; q < S; ++q) s += part[(long)q * w + c];
  grads[c < h ? o.b1 + c : c < 2 * h ? o.b2 + c - h : o.b3 + c - 2 * h] = s;
}

// grads[p] = sum over slices s of partial[s][p], in order of s, for the
// entries of the three weight matrices (the bias sums are wide_bias_sums').
__global__ void __launch_bounds__(256)
wide_add_slices(const float* __restrict__ partial, int S, Offsets o, float* __restrict__ grads) {
  const long p = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= o.P) return;
  if ((p >= o.b1 && p < o.A2) || (p >= o.b2 && p < o.A3) || p >= o.b3) return;
  float s = 0.0f;
  for (int q = 0; q < S; ++q) s += partial[(long)q * o.P + p];
  grads[p] = s;
}

}  // namespace

// The whole chain on the caller's stream.  scratch: scratch_floats(d, B)
// floats; partial: slices * P floats when wgrad_slices(d, B, BF16) > 1.
template <bool BF16>
cudaError_t stage_bwd(const float* x, const float* eps, const Weights& w, const Dims& d,
                      const float* ybar, const float* ezbar, const float* divbar,
                      const float* rzbar, const float* rjbar, float* xbar, float* epsbar,
                      float* partial, float* scratch, float* grads, int B,
                      cudaStream_t stream) {
  const int h = d.h, n_in = d.n_in, n_out = d.n_out, nz = d.nz;
  const Offsets o = offsets(d);
  const int slices = wgrad_slices(d, B, BF16);
  using T = typename BwdEpi<BF16>::T;
  // the forward's operands (fp32: the inputs themselves) and the rows of the
  // arrays the products read: h, nz, n_in wide, padded in bf16
  FwdOperands f{x, eps, w.A1, w.A2, w.A3, nullptr, nullptr, nullptr, nullptr, n_in, nz, h};
  BwdEpi<BF16> t{h, n_out, nz, n_in, BF16 ? pad8(h) : h, o.P, w.b1, w.b2, w.b3, divbar};
  t.xbar = xbar;
  t.epsbar = epsbar;
  t.grads = grads;
  t.partial = partial;
  // z1_t, z2_t and ybar_t first: what follows is dead once the weight
  // gradients are taken, and holds the bias sums' partial rows
  float* p = scratch;
  auto take = [&](long n) {
    float* q = p;
    p += n;
    return q;
  };
  const long Bh = (long)B * h;
  t.U1 = take(Bh);
  t.U2 = take(Bh);
  t.YB = take((long)B * n_out);
  t.S1 = take(Bh);
  t.S2 = take(Bh);
  t.Y = take((long)B * n_out);
  t.E = take((long)B * nz);
  float* EB = nullptr;  // fp32 ebar_t (the fp32 chain's operand)
  bf16 *YB16 = nullptr, *EB16 = nullptr;
  const void *YB = t.YB, *EBo;
  T** hs[8] = {&t.H1, &t.H2, &t.D1, &t.D2, &t.G1, &t.G2, &t.Z1, &t.Z2};
  if constexpr (BF16) {
    bf16* q = reinterpret_cast<bf16*>(scratch + scratch_fp32_part_of_bf16(d, B));
    auto take16 = [&](long n) {
      bf16* r = q;
      q += n;
      return r;
    };
    for (T** a : hs) *a = take16((long)B * t.ldt);
    YB16 = take16((long)B * pad8(nz));
    EB16 = take16((long)B * pad8(nz));
    // the bf16 operands the chain does not write itself, rows padded with zeros
    CNF_WIDE_TRY(convert_inputs<2>(x, eps, w, d, B, q, f, stream));
    if (h & 7)  // the padding of the rows the epilogues write, zero
      CNF_WIDE_TRY(cudaMemsetAsync(t.H1, 0, 8L * B * t.ldt * sizeof(bf16), stream));
    YB = YB16;
    EBo = EB16;
  } else {
    for (int j = 0; j < 6; ++j) *hs[j] = take(Bh);  // h1 ... u2bar; z_t are U1, U2
    EB = take((long)B * nz);
    EBo = EB;
  }
  f.H1 = t.H1;
  f.H2 = t.H2;
  f.D1 = t.D1;
  f.D2 = t.D2;
  const int ldh = f.ldh, ldz = f.ldz, ldi = f.ldi;
  const void *A1 = f.A1, *A2 = f.A2, *A3 = f.A3, *X = f.X, *EPS = f.EPS;
  // the operands z1_t and z2_t: fp32 U1, U2, or their bf16 copies
  const void* Z1 = BF16 ? static_cast<const void*>(t.Z1) : t.U1;
  const void* Z2 = BF16 ? static_cast<const void*>(t.Z2) : t.U2;

  // C and F1-F5: the forward with its intermediates
  CNF_WIDE_TRY(forward_products<BF16>(f, d, B, t, stream));
  // R: the merged cotangents
  const int tpr = row_threads(n_out > nz ? n_out : nz);
  const int rows = 256 / tpr;
  wide_merge<<<(B + rows - 1) / rows, 256, 0, stream>>>(ybar, ezbar, eps, divbar, rzbar, rjbar,
                                                        t.Y, t.E, t.YB, EB, YB16, EB16, ldz, B,
                                                        n_out, nz, tpr);
  CNF_WIDE_TRY(cudaGetLastError());
  // B1-B4: the probe-VJP path, then the forward path
  CNF_WIDE_TRY(run<BF16>(t, {product(by_row(EBo, ldz, B), by_row(A1, ldi, h), B, h, nz, kB1)},
                         stream));
  CNF_WIDE_TRY(run<BF16>(t, {product(by_row(t.G1, ldh, B), by_row(A2, ldh, h), B, h, h, kB2)},
                         stream));
  CNF_WIDE_TRY(run<BF16>(t, {product(by_row(t.G2, ldh, B), by_row(A3, ldh, nz), B, nz, h, kEpsbar),
                             product(by_row(YB, ldz, B), by_col(A3, ldh, h), B, h, n_out, kZ2)},
                         stream));
  CNF_WIDE_TRY(run<BF16>(t, {product(by_row(Z2, ldh, B), by_col(A2, ldh, h), B, h, h, kZ1)},
                         stream));
  // B5: xbar and the weight gradients, each of depth 2B
  CNF_WIDE_TRY(run<BF16>(t, {
      product(by_row(Z1, ldh, B), by_col(A1, ldi, n_in), B, n_in, h, kXbar),
      product(by_col2(Z1, ldh, h, t.D1, ldh, h, B), by_col2(X, ldi, n_in, EBo, ldz, nz, B), h,
              n_in, 2 * B, kGrad, o.A1, slices),
      product(by_col2(Z2, ldh, h, t.D2, ldh, h, B), by_col2(t.H1, ldh, h, t.G1, ldh, h, B), h,
              h, 2 * B, kGrad, o.A2, slices),
      product(by_col2(YB, ldz, n_out, EPS, ldz, nz, B), by_col2(t.H2, ldh, h, t.G2, ldh, h, B),
              n_out, h, 2 * B, kGrad, o.A3, slices)}, stream));
  if (slices > 1) {
    wide_add_slices<<<(unsigned)((o.P + 255) / 256), 256, 0, stream>>>(partial, slices, o, grads);
    CNF_WIDE_TRY(cudaGetLastError());
  }
  const int chunks = 2 * ((h + 31) / 32) + (n_out + 31) / 32;
  const int bias_slices = (B + kBiasRows - 1) / kBiasRows;
  wide_bias_sums<2><<<dim3(chunks, bias_slices), dim3(32, 32), 0, stream>>>(
      t.U1, t.U2, t.YB, t.S1, grads, B, h, n_out, o);
  CNF_WIDE_TRY(cudaGetLastError());
  if (bias_slices > 1) {
    wide_bias_add<2><<<(2 * h + n_out + 255) / 256, 256, 0, stream>>>(t.S1, bias_slices, h,
                                                                      n_out, o, grads);
    CNF_WIDE_TRY(cudaGetLastError());
  }
  return cudaSuccess;
}

}  // namespace wide
}  // namespace cnf
