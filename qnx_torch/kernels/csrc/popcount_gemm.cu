// Packed binary and ternary popcount GEMMs with int32 output, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernels qnx/kernels/xnor_gemm.py:_xnor_gemm_kernel
// (xnor_gemm_popcount, kernel B) and qnx/kernels/ternary_gemm.py:
// _ternary_gemm_kernel (ternary_gemm, kernel C):
//
//   s[m, n] = k - 2 * sum_words popc(x[m] ^ w[n])                  (binary)
//   s[m, n] = nnz[n] - 2 * sum_words popc(mask[n] & (x[m] ^ sign[n]))  (ternary)
//
// Pad bits are 0 in both binary operands, so they XOR to 0; ternary pad words
// are 0 in the mask plane.  So k is the true reduction length and nothing is
// corrected.  They serve the measurement path at wide N (the shootout's
// baseline, the accumulator scan, the roofline); the models' logit heads
// (PackedDenseLogits, TernaryDenseLogits), at N = 10, run popcount_head.cu.
//
// Layout: popcount_rows.cuh's: one lane per output column, 4 rows per
// thread, 8 warps per block.  At wide N (1024 x 4096 x 4096) it is bound
// by popc issue, 16 per clock per SM at compute capability 9.0, with one
// coalesced weight load and four broadcast activation loads per four
// popcounts (0.71-0.83 of that bound on an H100 SXM at 700 W); at N = 10
// it leaves 22 of 32 lanes idle, hence popcount_head.cu's warp per row.
// Shared-memory tiles and the b1 tensor-core MMA are later work.  Lanes
// with column >= N return at once: these kernels have no ballot, so any N,
// down to 1, is allowed.
#include <cuda_runtime.h>

#include "popcount_rows.cuh"

namespace {

// grid dense_grid(m, n), block (32, kWarpsPerBlock).  Binary: wp is the packed
// sign plane, sp and nnz are unused, the base is k.  Ternary: wp is the mask
// plane, sp the sign plane, the base is nnz[col].
template <bool kTernary>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
popcount_gemm_kernel(const unsigned* __restrict__ xp,
                     const unsigned* __restrict__ wp,
                     const unsigned* __restrict__ sp,
                     const int* __restrict__ nnz,
                     int* __restrict__ out,
                     int m, int kw, int n, int k) {
  const int col = blockIdx.y * kWarp + threadIdx.x;
  const int row0 = (blockIdx.x * kWarpsPerBlock + threadIdx.y) * kDenseRows;
  if (row0 >= m || col >= n) return;

  int acc[kDenseRows];
  dense_popcount<kTernary>(xp, wp, sp, row0, m, kw, n, col, acc);
  int base = k;
  if constexpr (kTernary) base = __ldg(nnz + col);
#pragma unroll
  for (int r = 0; r < kDenseRows; ++r) {
    if (row0 + r < m) out[static_cast<size_t>(row0 + r) * n + col] = base - 2 * acc[r];
  }
}

}  // namespace

extern "C" {

// Plain C entry points, bound with ctypes by qnx_torch/kernels/_build.py.
// Each launches on the given stream, does not synchronise, and returns
// cudaGetLastError() so a refused launch is reported at once.

int qnx_xnor_gemm_popcount(const void* xp, const void* wp, void* out, int m,
                           int kw, int n, int k, void* stream) {
  popcount_gemm_kernel<false><<<dense_grid(m, n), dim3(kWarp, kWarpsPerBlock), 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(xp), static_cast<const unsigned*>(wp), nullptr,
      nullptr, static_cast<int*>(out), m, kw, n, k);
  return static_cast<int>(cudaGetLastError());
}

int qnx_ternary_gemm(const void* xp, const void* mask, const void* sign,
                     const void* nnz, void* out, int m, int kw, int n,
                     void* stream) {
  popcount_gemm_kernel<true><<<dense_grid(m, n), dim3(kWarp, kWarpsPerBlock), 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(xp), static_cast<const unsigned*>(mask),
      static_cast<const unsigned*>(sign), static_cast<const int*>(nnz),
      static_cast<int*>(out), m, kw, n, 0);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
