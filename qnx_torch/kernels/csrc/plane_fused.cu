// Fused bit-plane popcount conv and dense with the multi-level threshold
// epilogue and the plane repack, and the int32 bit-plane GEMM, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel qnx/kernels/plane_gemm.py:_plane_gemm_kernel
// (kernel D) and what the JAX bit-plane layers leave to XLA around it
// (plane_conv's patch gather and plane loop, qnx/nn/inference.py's
// PlaneConvTernary, PlaneDenseTernary and PlaneDenseLogits: the plane sum,
// the multi-level thresholds, the pool of the levels and the plane packing).
// The JAX path runs one GEMM per plane and sends int32 back to XLA; here one
// launch per layer covers every plane.
//
//   t_j  = 2 * popc(b_j & msign) - popc(b_j & mask)   per {0,1} plane j
//   s    = sum_j 2^j t_j
//   s    = max over the 2x2 window                   (conv with pool)
//   lvl  = sum_v [sgn[n] * s >= tau[v, n]]           (fold_bn_levels)
//   word j = __ballot_sync of bit j of lvl over 32 consecutive channels
//
// Zero pads read the all-zero word, b = 0, and add nothing: the 'SAME' conv
// over planes needs no correction in relu mode, the only mode ported.  The
// level is nondecreasing in sgn * s, so the level of the window's max of s
// equals the JAX order, threshold then pool of the levels (the window's min
// where sgn < 0).
//
// Layout: planes-major, (P, B, H, W, Cw) for the conv and (P, M, Kw) for the
// dense entries, output planes likewise; weights (9*Cw, N) tap-major or
// (Kw, N), thresholds (n_thresh, N).  One warp owns 32 consecutive channels
// at a 2x2 quad of conv outputs (as xnor_fused.cu's conv kernel) or at
// kDenseRows rows (popcount_rows.cuh's geometry); lanes past N read no
// weight or threshold and vote 0, so the pad bits of the last word are 0.
// A channel's thresholds are read through L1 at each level test: one test
// per pooled output, after 9 * Cw * P word steps of the inner loop.
//
// What limits these kernels on an H100: per 32 MACs of one plane the inner
// loop issues two AND, two POPC and the adds on the CUDA cores, so at 16
// popc per clock per SM (xnor_fused.cu) a plane costs twice a binary
// kernel's word loop, and P planes cost P times one.  Weights stay in L2
// (the largest plane pair is 2 x 295 KB) and are re-read for each plane.
// The card's least time for the same products is the int8 tensor cores'
// on the levels, one MAC per MAC whatever P; this first version keeps the
// binary kernels' simple form: no shared-memory staging, TMA or MMA.
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

// Write the p planes of one output position's levels: word j of plane j at
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

// One warp per 2x2 quad of conv output positions and 32 channels, as
// xnor_conv3x3_fused_kernel: grid (ceil(b * ceil(h/2) * ceil(w/2) /
// kWarpsPerBlock), ceil(n / 32)), block (32, kWarpsPerBlock).  Each plane's
// 4x4 input window of word c is loaded once and feeds the four outputs of
// the quad for all 9 taps.  kRagged (N % 32 != 0) compiles the lane masking
// of the weight loads in.
template <bool kRagged>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
plane_conv3x3_fused_kernel(const unsigned* __restrict__ xp,
                           const unsigned* __restrict__ mask,
                           const unsigned* __restrict__ msign,
                           const int* __restrict__ sgn,
                           const int* __restrict__ tau,
                           int* __restrict__ out,
                           int p, int b, int h, int w, int cw, int n,
                           int n_thresh, int pool) {
  const int lane = threadIdx.x;
  const int group = blockIdx.y;
  const int col = group * kWarp + lane;
  const bool live = !kRagged || col < n;
  const int qh = (h + 1) / 2;
  const int qw = (w + 1) / 2;
  const long long quad =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.y;
  if (quad >= static_cast<long long>(b) * qh * qw) return;  // warp-uniform
  const int qx = static_cast<int>(quad % qw);
  const int qy = static_cast<int>((quad / qw) % qh);
  const int bi = static_cast<int>(quad / (static_cast<long long>(qw) * qh));
  const int y0 = 2 * qy;
  const int x0 = 2 * qx;

  int s[4] = {};  // (y0,x0) (y0,x0+1) (y0+1,x0) (y0+1,x0+1)
  for (int j = 0; j < p; ++j) {
    const unsigned* img = xp + (static_cast<size_t>(j) * b + bi) * h * w * cw;
    int pos[4] = {}, tot[4] = {};
    for (int c = 0; c < cw; ++c) {
      // input rows y0-1..y0+2 and columns x0-1..x0+2 of word c; outside -> 0
      unsigned win[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int iy = y0 - 1 + r;
          const int ix = x0 - 1 + q;
          win[r][q] = (iy >= 0 && iy < h && ix >= 0 && ix < w)
                          ? __ldg(img + (static_cast<size_t>(iy) * w + ix) * cw + c)
                          : 0u;
        }
      }
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const size_t at = (static_cast<size_t>(dy * 3 + dx) * cw + c) * n + col;
          const unsigned wm = live ? __ldg(mask + at) : 0u;
          const unsigned ws = live ? __ldg(msign + at) : 0u;
#pragma unroll
          for (int o = 0; o < 4; ++o) {
            const unsigned x = win[dy + (o >> 1)][dx + (o & 1)];
            pos[o] += __popc(x & ws);
            tot[o] += __popc(x & wm);
          }
        }
      }
    }
#pragma unroll
    for (int o = 0; o < 4; ++o) s[o] += (2 * pos[o] - tot[o]) * (1 << j);
  }

  const int nw = (n + kWarp - 1) / kWarp;
  if (pool) {  // h and w are even here (the wrapper checks it)
    const int mx = max(max(s[0], s[1]), max(s[2], s[3]));
    const size_t plane = static_cast<size_t>(b) * (h / 2) * (w / 2) * nw;
    const size_t at = ((static_cast<size_t>(bi) * (h / 2) + qy) * (w / 2) + qx) * nw;
    const int lvl = live ? level_of(mx, sgn, tau, n_thresh, n, col) : 0;
    store_planes(lvl, live, p, out, plane, at + group);
    return;
  }
  const size_t plane = static_cast<size_t>(b) * h * w * nw;
#pragma unroll
  for (int o = 0; o < 4; ++o) {
    const int y = y0 + (o >> 1);
    const int x = x0 + (o & 1);
    if (y < h && x < w) {  // uniform across the warp
      const size_t at = ((static_cast<size_t>(bi) * h + y) * w + x) * nw;
      const int lvl = live ? level_of(s[o], sgn, tau, n_thresh, n, col) : 0;
      store_planes(lvl, live, p, out, plane, at + group);
    }
  }
}

}  // namespace

extern "C" {

// Plain C entry points, bound with ctypes by qnx_torch/kernels/_build.py.
// Each launches on the given stream, does not synchronise, and returns
// cudaGetLastError() so a refused launch is reported at once.

int qnx_plane_conv3x3_fused(const void* xp, const void* mask, const void* msign,
                            const void* sgn, const void* tau, void* out, int p, int b, int h, int w, int cw, int n,
                            int n_thresh, int pool, void* stream) {
  const dim3 block(kWarp, kWarpsPerBlock);
  const long long quads =
      static_cast<long long>(b) * ((h + 1) / 2) * ((w + 1) / 2);
  const dim3 grid(static_cast<unsigned>((quads + kWarpsPerBlock - 1) / kWarpsPerBlock),
                  (n + kWarp - 1) / kWarp);
  auto kernel = n % kWarp ? plane_conv3x3_fused_kernel<true>
                          : plane_conv3x3_fused_kernel<false>;
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(xp), static_cast<const unsigned*>(mask),
      static_cast<const unsigned*>(msign), static_cast<const int*>(sgn),
      static_cast<const int*>(tau), static_cast<int*>(out), p, b, h, w, cw, n,
      n_thresh, pool);
  return static_cast<int>(cudaGetLastError());
}

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
