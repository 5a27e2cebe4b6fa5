// Launch geometry and inner loop shared by the popcount GEMMs with int32
// out at wide N (popcount_gemm.cu: kernels B and C) and kernel G
// (gemm_formulations.cu).
//
// One lane owns one output column, one warp 32 consecutive columns, and each
// thread kDenseRows rows: per packed word it loads one weight word (the warp's
// loads are coalesced), kDenseRows activation words (the same address across
// the warp, a broadcast) and issues kDenseRows popcounts.
#pragma once
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kDenseRows = 4;  // rows of the dense GEMM per thread
constexpr int kRowsPerBlock = kDenseRows * kWarpsPerBlock;

// The grid of a dense kernel: (row blocks, column groups of 32).
inline dim3 dense_grid(int m, int n) {
  return dim3((m + kRowsPerBlock - 1) / kRowsPerBlock, (n + kWarp - 1) / kWarp);
}

// acc[r] = sum over the kw words of popc(x ^ w) (binary) or
// popc(m & (x ^ s)) (ternary: wp is the mask plane, sp the sign plane) for
// the thread's rows row0 .. row0 + kDenseRows - 1 and column col < n.  A
// ragged tail re-reads row m - 1; the caller stores no result for it.
template <bool kTernary>
__device__ __forceinline__ void dense_popcount(const unsigned* __restrict__ xp,
                                               const unsigned* __restrict__ wp,
                                               const unsigned* __restrict__ sp,
                                               int row0, int m, int kw, int n,
                                               int col, int (&acc)[kDenseRows]) {
  const unsigned* xrow[kDenseRows];
#pragma unroll
  for (int r = 0; r < kDenseRows; ++r) {
    xrow[r] = xp + static_cast<size_t>(min(row0 + r, m - 1)) * kw;
    acc[r] = 0;
  }
  for (int i = 0; i < kw; ++i) {
    const size_t at = static_cast<size_t>(i) * n + col;
    const unsigned w = __ldg(wp + at);
    if constexpr (kTernary) {
      const unsigned s = __ldg(sp + at);
#pragma unroll
      for (int r = 0; r < kDenseRows; ++r) acc[r] += __popc(w & (__ldg(xrow[r] + i) ^ s));
    } else {
#pragma unroll
      for (int r = 0; r < kDenseRows; ++r) acc[r] += __popc(__ldg(xrow[r] + i) ^ w);
    }
  }
}

}  // namespace
