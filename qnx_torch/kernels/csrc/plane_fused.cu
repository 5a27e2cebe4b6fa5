// The int32 bit-plane GEMM of kernel D's integer head, by popcount, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel qnx/kernels/plane_gemm.py:_plane_gemm_kernel
// (kernel D) at the integer head, and the plane sum that the JAX bit-plane
// head (qnx/nn/inference.py's PlaneDenseLogits) leaves to XLA around it.
// D's conv and dense layers run on the int8 tensor cores
// (expand_mma_conv.cu, expand_mma_dense.cu).  The JAX path runs one GEMM
// per plane; here one launch covers every plane.
//
//   t_j  = 2 * popc(b_j & msign) - popc(b_j & mask)   per {0,1} plane j
//   s    = sum_j 2^j t_j                              (M, N) int32
//
// Layout: planes-major, (P, M, Kw); weights (Kw, N).  One lane owns one
// column at kDenseRows rows (popcount_rows.cuh's geometry).
//
// What limits this kernel on an H100: per 32 MACs of one plane the inner
// loop issues two AND and two POPC on the CUDA cores, at 16 popc per clock
// per SM, and P planes cost P times one; the head's N = 10 leaves 22 of a
// warp's lanes idle.  The card's least time for the same product is the
// int8 tensor cores' on the levels; this version keeps the simple form.
#include <cuda_runtime.h>

#include "popcount_rows.cuh"

namespace {

// acc[r] = sum_j 2^j (2 popc(b_j & msign) - popc(b_j & mask)) for rows
// row0 .. row0 + kDenseRows - 1 of the planes (P, M, Kw) and column col < n.
// A ragged tail re-reads row m - 1; the caller stores no result for it.
__device__ __forceinline__ void plane_rows(const unsigned* __restrict__ xp,
                                           const unsigned* __restrict__ mask,
                                           const unsigned* __restrict__ msign,
                                           int p, int row0, int m, int kw, int n,
                                           int col, int (&acc)[kDenseRows]) {
#pragma unroll
  for (int r = 0; r < kDenseRows; ++r) acc[r] = 0;
  for (int j = 0; j < p; ++j) {
    const unsigned* xrow[kDenseRows];
    int pos[kDenseRows], tot[kDenseRows];
#pragma unroll
    for (int r = 0; r < kDenseRows; ++r) {
      xrow[r] = xp + (static_cast<size_t>(j) * m + min(row0 + r, m - 1)) * kw;
      pos[r] = 0;
      tot[r] = 0;
    }
    for (int i = 0; i < kw; ++i) {
      const size_t at = static_cast<size_t>(i) * n + col;
      const unsigned wm = __ldg(mask + at);
      const unsigned ws = __ldg(msign + at);
#pragma unroll
      for (int r = 0; r < kDenseRows; ++r) {
        const unsigned x = __ldg(xrow[r] + i);
        pos[r] += __popc(x & ws);
        tot[r] += __popc(x & wm);
      }
    }
#pragma unroll
    for (int r = 0; r < kDenseRows; ++r) acc[r] += (2 * pos[r] - tot[r]) * (1 << j);
  }
}

// grid dense_grid(m, n), block (32, kWarpsPerBlock): int32 s (M, N).
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
plane_gemm_kernel(const unsigned* __restrict__ xp,
                  const unsigned* __restrict__ mask,
                  const unsigned* __restrict__ msign,
                  int* __restrict__ out, int p, int m, int kw, int n) {
  const int col = blockIdx.y * kWarp + threadIdx.x;
  const int row0 = (blockIdx.x * kWarpsPerBlock + threadIdx.y) * kDenseRows;
  if (row0 >= m || col >= n) return;
  int acc[kDenseRows];
  plane_rows(xp, mask, msign, p, row0, m, kw, n, col, acc);
#pragma unroll
  for (int r = 0; r < kDenseRows; ++r) {
    if (row0 + r < m) out[static_cast<size_t>(row0 + r) * n + col] = acc[r];
  }
}

}  // namespace

extern "C" {

// Plain C entry points, bound with ctypes by qnx_torch/kernels/_build.py.
// Each launches on the given stream, does not synchronise, and returns
// cudaGetLastError() so a refused launch is reported at once.

int qnx_plane_gemm(const void* xp, const void* mask, const void* msign,
                   void* out, int p, int m, int kw, int n, void* stream) {
  plane_gemm_kernel<<<dense_grid(m, n), dim3(kWarp, kWarpsPerBlock), 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(xp), static_cast<const unsigned*>(mask),
      static_cast<const unsigned*>(msign), static_cast<int*>(out), p, m, kw, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
