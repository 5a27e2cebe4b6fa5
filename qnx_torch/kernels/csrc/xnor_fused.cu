// Fused packed XNOR-popcount dense and 3x3 conv kernels with the integer
// threshold epilogue and the 1-bit repack, for Hopper (sm_90a).
//
// Replaces the Pallas kernel qnx/kernels/xnor_conv_fused.py:_gemm_epi_kernel:
// its binary branch, reached there through xnor_gemm_fused (dense) and
// xnor_conv_fused (conv), and its ternary branch reached through
// ternary_gemm_fused (dense).  The ternary conv (ternary_conv_fused) runs on
// the int8 tensor cores in expand_mma_conv.cu.  Each kernel also does what
// the JAX path leaves to XLA around that kernel: the 3x3 patch gather
// (implicit GEMM, no 9x patch tensor), the whole 2x2 max pool, and the
// repack of the +-1 codes into int32 words (pack_bits_mxu).
//
//   s    = k - 2 * sum_words popc(x ^ w)        (+-1 dot product)
//   s    = nnz[n] - 2 * sum_words popc(m & (x ^ sgnw))   (ternary dense)
//   s   += corr[h, w, n]                        (conv: zero-pad correction)
//   s    = max over the 2x2 window              (conv with pool)
//   bit  = sgn[n] * s >= tau[n]                 (folded BN + sign, int32)
//   word = __ballot_sync of the 32 bits of 32 consecutive channels
//
// One warp owns 32 consecutive output channels at one output position (or a
// few), so lane j's threshold bit is bit j of the ballot: exactly the
// LSB-first packing contract of qnx/ops/packing.py.  Any N is allowed: the
// last group's lanes with channel >= N read no weight, sgn, tau or corr and
// vote 0, so the pad bits of the last word are 0, as pack_bits_mxu makes
// them; every lane still takes part in the full-warp ballot.  Ternary pad
// words are 0 in the mask plane and add nothing.
//
// Zero padding: a tap outside the image reads the all-zero word, which
// decodes to -1 bits, exactly like the JAX path's zero-word padded patches;
// corr (qnx/kernels/xnor_conv.py:padding_correction) then restores the true
// zero-pad conv.  Skipping those taps instead would double-count corr.
//
// What bounds these kernels on an H100: per 32 binary MACs the inner loop
// issues one XOR, one POPC and one IADD on the CUDA cores (one more AND for
// ternary weights).  POPC is the slowest of them: the CUDA C++ Programming
// Guide's table of native arithmetic instruction throughput lists 16 results
// per clock per SM for 32-bit population count at compute capability 9.0,
// against 64 for 32-bit bitwise ops and IADD; a dependent xor+popc probe on
// an H100 SXM measured 15.83 per clock per SM.  That caps the card at 132 SMs
// x 16 popc x 32 MAC per clock (about 1.34e14 binary MAC/s at the 1.98 GHz
// maximum SM clock).  The bytes are small beside that: the largest weight
// plane (9 taps x 16 words x 512 channels) is 295 KB and stays in L2,
// activations are 1 bit per value.  This first version is the simple form:
// operands come straight from L1/L2 with no shared-memory staging, and
// register reuse is the only blocking (the dense kernels keep 4 rows per
// thread on one weight word, popcount_rows.cuh; the conv kernel keeps a 4x4
// input window per word and updates the four outputs of a 2x2 quad from it,
// 36 popc per 16 activation and 9 weight loads).  The int8 tensor cores
// (expand_mma_conv.cu's mainloop) are the next step for these too.
#include <cuda_runtime.h>

#include "popcount_rows.cuh"

namespace {

// grid dense_grid(m, n), block (32, kWarpsPerBlock).  Binary: wp is the
// packed sign plane, sp and nnz are unused and the popcount base is k.
// Ternary: wp is the mask plane, sp the sign plane, the base is nnz[col].
template <bool kTernary>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
dense_fused_kernel(const unsigned* __restrict__ xp,
                   const unsigned* __restrict__ wp,
                   const unsigned* __restrict__ sp,
                   const int* __restrict__ nnz,
                   const int* __restrict__ sgn,
                   const int* __restrict__ tau,
                   int* __restrict__ out,
                   int m, int kw, int n, int k) {
  const int lane = threadIdx.x;
  const int group = blockIdx.y;
  const int col = group * kWarp + lane;
  const bool live = col < n;
  const int row0 = (blockIdx.x * kWarpsPerBlock + threadIdx.y) * kDenseRows;
  if (row0 >= m) return;  // uniform across the warp

  int acc[kDenseRows] = {};
  int sg = 0, t = 0, base = k;
  if (live) {
    dense_popcount<kTernary>(xp, wp, sp, row0, m, kw, n, col, acc);
    sg = __ldg(sgn + col);
    t = __ldg(tau + col);
    if constexpr (kTernary) base = __ldg(nnz + col);
  }
  const int nw = (n + kWarp - 1) / kWarp;
#pragma unroll
  for (int r = 0; r < kDenseRows; ++r) {
    const int s = base - 2 * acc[r];
    const unsigned word = __ballot_sync(kFull, live && sg * s >= t);
    if (lane == 0 && row0 + r < m) {
      out[static_cast<size_t>(row0 + r) * nw + group] = static_cast<int>(word);
    }
  }
}

// One warp per 2x2 quad of conv output positions and 32 channels.
// grid (ceil(b * ceil(h/2) * ceil(w/2) / kWarpsPerBlock), ceil(n / 32)),
// block (32, kWarpsPerBlock).  kRagged (N % 32 != 0) compiles the lane
// masking in; without it every lane is live and the 9 weight loads of each
// input word carry no predicate (with it, the conv layers of cifar10-bnn
// took 12% longer on an H100 SXM at 700 W).
template <bool kRagged>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
xnor_conv3x3_fused_kernel(const unsigned* __restrict__ xp,
                          const unsigned* __restrict__ wp,
                          const int* __restrict__ corr,
                          const int* __restrict__ sgn,
                          const int* __restrict__ tau,
                          int* __restrict__ out,
                          int b, int h, int w, int cw, int n, int k, int pool) {
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

  const unsigned* img = xp + static_cast<size_t>(bi) * h * w * cw;
  int acc[4] = {};  // (y0,x0) (y0,x0+1) (y0+1,x0) (y0+1,x0+1)
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
        const unsigned wv = live ? __ldg(wp + at) : 0u;
        acc[0] += __popc(win[dy][dx] ^ wv);
        acc[1] += __popc(win[dy][dx + 1] ^ wv);
        acc[2] += __popc(win[dy + 1][dx] ^ wv);
        acc[3] += __popc(win[dy + 1][dx + 1] ^ wv);
      }
    }
  }

  const int sg = live ? __ldg(sgn + col) : 0;
  const int t = live ? __ldg(tau + col) : 0;
  const int nw = (n + kWarp - 1) / kWarp;
  int s[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int y = y0 + (p >> 1);
    const int x = x0 + (p & 1);
    s[p] = k - 2 * acc[p];
    if (live && y < h && x < w) {
      s[p] += __ldg(corr + (static_cast<size_t>(y) * w + x) * n + col);
    }
  }
  if (pool) {  // h and w are even here (the wrapper checks it)
    // BinaryNet order: pool the integer conv output, then BN + sign
    const int mx = max(max(s[0], s[1]), max(s[2], s[3]));
    const unsigned word = __ballot_sync(kFull, live && sg * mx >= t);
    if (lane == 0) {
      const size_t pos = (static_cast<size_t>(bi) * (h / 2) + qy) * (w / 2) + qx;
      out[pos * nw + group] = static_cast<int>(word);
    }
    return;
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int y = y0 + (p >> 1);
    const int x = x0 + (p & 1);
    if (y < h && x < w) {  // uniform across the warp
      const unsigned word = __ballot_sync(kFull, live && sg * s[p] >= t);
      if (lane == 0) {
        const size_t pos = (static_cast<size_t>(bi) * h + y) * w + x;
        out[pos * nw + group] = static_cast<int>(word);
      }
    }
  }
}

}  // namespace

extern "C" {

// Plain C entry points, bound with ctypes by qnx_torch/kernels/_build.py.
// Each launches on the given stream, does not synchronise, and returns
// cudaGetLastError() so a refused launch is reported at once.

int qnx_xnor_dense_fused(const void* xp, const void* wp, const void* sgn,
                         const void* tau, void* out, int m, int kw, int n,
                         int k, void* stream) {
  dense_fused_kernel<false><<<dense_grid(m, n), dim3(kWarp, kWarpsPerBlock), 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(xp), static_cast<const unsigned*>(wp), nullptr,
      nullptr, static_cast<const int*>(sgn), static_cast<const int*>(tau),
      static_cast<int*>(out), m, kw, n, k);
  return static_cast<int>(cudaGetLastError());
}

int qnx_ternary_dense_fused(const void* xp, const void* mask, const void* sign,
                            const void* nnz, const void* sgn, const void* tau,
                            void* out, int m, int kw, int n, void* stream) {
  dense_fused_kernel<true><<<dense_grid(m, n), dim3(kWarp, kWarpsPerBlock), 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(xp), static_cast<const unsigned*>(mask),
      static_cast<const unsigned*>(sign), static_cast<const int*>(nnz),
      static_cast<const int*>(sgn), static_cast<const int*>(tau),
      static_cast<int*>(out), m, kw, n, 0);
  return static_cast<int>(cudaGetLastError());
}

int qnx_xnor_conv3x3_fused(const void* xp, const void* wp, const void* corr,
                           const void* sgn, const void* tau, void* out, int b,
                           int h, int w, int cw, int n, int k, int pool,
                           void* stream) {
  const dim3 block(kWarp, kWarpsPerBlock);
  const long long quads =
      static_cast<long long>(b) * ((h + 1) / 2) * ((w + 1) / 2);
  const dim3 grid(static_cast<unsigned>((quads + kWarpsPerBlock - 1) / kWarpsPerBlock),
                  (n + kWarp - 1) / kWarp);
  auto kernel = n % kWarp ? xnor_conv3x3_fused_kernel<true>
                          : xnor_conv3x3_fused_kernel<false>;
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(xp), static_cast<const unsigned*>(wp),
      static_cast<const int*>(corr), static_cast<const int*>(sgn),
      static_cast<const int*>(tau), static_cast<int*>(out), b, h, w, cw, n, k,
      pool);
  return static_cast<int>(cudaGetLastError());
}

const char* qnx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
