// The fp32 product core of the wide paths (wide_gemm.cuh) on its own: the
// tally of products each fp32 tile has run, which K1-K4's wrappers add to
// the program's counters, and one product on a named tile, for the tests
// that hold every tile to the first design's bits and for chip_profile.py
// wide-f32.  The port's public API does not reach the product entry.
#include "wide_gemm.cuh"

namespace {

using cnf::wide::Launch;
using cnf::wide::Operand;
using cnf::wide::Product;

// Each slice's C into out (slices x M x N, row-major).
struct StoreEpi {
  float* out;
  __device__ __forceinline__ void operator()(const Product& p, int slice, int m, int n,
                                             float v) const {
    out[((long)slice * p.M + m) * p.N + n] = v;
  }
};

Operand operand(const void* const* ptrs, const int* ints, int kseg) {
  return Operand{{ptrs[0], ptrs[1]}, {ints[0], ints[1]}, {ints[2], ints[3]}, kseg, ints[4]};
}

}  // namespace

// One fp32 product C = A B^T, each of its slices' C into out (slices x M x
// N floats), on fp32 tile `tile` (an index of cnf_wide_f32_tally's shapes;
// -1: the tile the wide paths' rule picks).  ptrs: A's two row sets, then
// B's; ints: A's ld0, ld1, ext0, ext1, kmajor, then B's, then kseg, M, N,
// K, slices (Operand and product() in wide_gemm.cuh).
extern "C" int cnf_wide_f32_product(int tile, const void* const* ptrs, const int* ints,
                                    float* out, void* stream) {
  const int kseg = ints[10];
  Launch<StoreEpi> L{};
  L.p[0] = cnf::wide::product(operand(ptrs, ints, kseg), operand(ptrs + 2, ints + 5, kseg),
                              ints[11], ints[12], ints[13], 0, 0, ints[14]);
  L.count = 1;
  L.epi = StoreEpi{out};
  if (tile < 0) tile = cnf::wide::choose_f32(L);
  if (tile >= cnf::wide::kF32Tiles) return cudaErrorInvalidValue;
  return cnf::wide::launch_f32(L, tile, static_cast<cudaStream_t>(stream));
}

// Products the wide paths have launched on each fp32 tile since the library
// loaded: counts[i] on tiles of shapes[2 i] x shapes[2 i + 1] rows x columns,
// for i below the return value (at most n).
extern "C" int cnf_wide_f32_tally(long long* counts, int* shapes, int n) {
  const int tiles = n < cnf::wide::kF32Tiles ? n : cnf::wide::kF32Tiles;
  for (int i = 0; i < tiles; ++i) {
    counts[i] = cnf::wide::f32_tally[i].load();
    shapes[2 * i] = cnf::wide::kF32Shape[i][0];
    shapes[2 * i + 1] = cnf::wide::kF32Shape[i][1];
  }
  return tiles;
}
