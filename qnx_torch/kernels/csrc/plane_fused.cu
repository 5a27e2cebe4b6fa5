// Fused bit-plane popcount dense with the multi-level threshold epilogue
// and the plane repack, and the int32 bit-plane GEMM, for Hopper (sm_90a).
//
// Replaces the Pallas kernel qnx/kernels/plane_gemm.py:_plane_gemm_kernel
// (kernel D) at the dense layers and the integer head, and what the JAX
// bit-plane layers leave to XLA around it (qnx/nn/inference.py's
// PlaneDenseTernary and PlaneDenseLogits: the plane sum, the multi-level
// thresholds and the plane packing).  D's conv (plane_conv) runs on the int8
// tensor cores in expand_mma_conv.cu.  The JAX path runs one GEMM per plane
// and sends int32 back to XLA; here one launch per layer covers every plane.
//
//   t_j  = 2 * popc(b_j & msign) - popc(b_j & mask)   per {0,1} plane j
//   s    = sum_j 2^j t_j
//   lvl  = sum_v [sgn[n] * s >= tau[v, n]]           (fold_bn_levels)
//   word j = __ballot_sync of bit j of lvl over 32 consecutive channels
//
// Layout: planes-major, (P, M, Kw), output planes likewise; weights (Kw,
// N), thresholds (n_thresh, N).  One warp owns 32 consecutive channels at
// kDenseRows rows (popcount_rows.cuh's geometry); lanes past N read no
// weight or threshold and vote 0, so the pad bits of the last word are 0.
//
// What limits these kernels on an H100: per 32 MACs of one plane the inner
// loop issues two AND, two POPC and the adds on the CUDA cores, so at 16
// popc per clock per SM (xnor_fused.cu) a plane costs twice a binary
// kernel's word loop, and P planes cost P times one.  Weights stay in L2
// and are re-read for each plane.  The card's least time for the same
// products is the int8 tensor cores' on the levels, one MAC per MAC
// whatever P, as expand_mma_conv.cu does for the conv; this version keeps
// the binary kernels' simple form: no shared-memory staging, TMA or MMA.
#include <cuda_runtime.h>

#include "popcount_rows.cuh"

namespace {

// The level of s for channel col < n: sum_v [sgn[col] * s >= tau[v, col]].
__device__ __forceinline__ int level_of(int s, const int* __restrict__ sgn,
                                        const int* __restrict__ tau,
                                        int n_thresh, int n, int col) {
  const int u = __ldg(sgn + col) * s;
  int lvl = 0;
  for (int v = 0; v < n_thresh; ++v) {
    lvl += u >= __ldg(tau + static_cast<size_t>(v) * n + col);
  }
  return lvl;
}

// Write the p planes of one row's levels: word j of plane j at
// out + j * plane + at.  Every lane takes part in each ballot.
__device__ __forceinline__ void store_planes(int lvl, bool live, int p,
                                             int* __restrict__ out,
                                             size_t plane, size_t at) {
  for (int j = 0; j < p; ++j) {
    const unsigned word = __ballot_sync(kFull, live && ((lvl >> j) & 1));
    if (threadIdx.x == 0) out[j * plane + at] = static_cast<int>(word);
  }
}

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

// grid dense_grid(m, n), block (32, kWarpsPerBlock): the levels of each row
// repacked into p planes (P, M, ceil(n/32)).
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
plane_dense_fused_kernel(const unsigned* __restrict__ xp,
                         const unsigned* __restrict__ mask,
                         const unsigned* __restrict__ msign,
                         const int* __restrict__ sgn,
                         const int* __restrict__ tau,
                         int* __restrict__ out,
                         int p, int m, int kw, int n, int n_thresh) {
  const int lane = threadIdx.x;
  const int group = blockIdx.y;
  const int col = group * kWarp + lane;
  const bool live = col < n;
  const int row0 = (blockIdx.x * kWarpsPerBlock + threadIdx.y) * kDenseRows;
  if (row0 >= m) return;  // uniform across the warp

  int acc[kDenseRows] = {};
  if (live) plane_rows(xp, mask, msign, p, row0, m, kw, n, col, acc);
  const int nw = (n + kWarp - 1) / kWarp;
#pragma unroll
  for (int r = 0; r < kDenseRows; ++r) {
    const bool row = row0 + r < m;  // uniform across the warp
    if (row) {
      const int lvl = live ? level_of(acc[r], sgn, tau, n_thresh, n, col) : 0;
      store_planes(lvl, live, p, out, static_cast<size_t>(m) * nw,
                   static_cast<size_t>(row0 + r) * nw + group);
    }
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

int qnx_plane_dense_fused(const void* xp, const void* mask, const void* msign,
                          const void* sgn, const void* tau, void* out, int p,
                          int m, int kw, int n, int n_thresh, void* stream) {
  plane_dense_fused_kernel<<<dense_grid(m, n), dim3(kWarp, kWarpsPerBlock), 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(xp), static_cast<const unsigned*>(mask),
      static_cast<const unsigned*>(msign), static_cast<const int*>(sgn),
      static_cast<const int*>(tau), static_cast<int*>(out), p, m, kw, n,
      n_thresh);
  return static_cast<int>(cudaGetLastError());
}

int qnx_plane_gemm(const void* xp, const void* mask, const void* msign,
                   void* out, int p, int m, int kw, int n, void* stream) {
  plane_gemm_kernel<<<dense_grid(m, n), dim3(kWarp, kWarpsPerBlock), 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(xp), static_cast<const unsigned*>(mask),
      static_cast<const unsigned*>(msign), static_cast<int*>(out), p, m, kw, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
