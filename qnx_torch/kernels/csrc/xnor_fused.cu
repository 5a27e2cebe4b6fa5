// Fused packed XNOR-popcount dense kernels with the integer threshold
// epilogue and the 1-bit repack, for Hopper (sm_90a).
//
// Replaces the dense entries of the Pallas kernel
// qnx/kernels/xnor_conv_fused.py:_gemm_epi_kernel: its binary branch,
// reached there through xnor_gemm_fused, and its ternary branch reached
// through ternary_gemm_fused.  The convs of both branches (xnor_conv_fused,
// ternary_conv_fused) run on the int8 tensor cores in expand_mma_conv.cu.
// Each kernel also does what the JAX path leaves to XLA around that
// kernel: the repack of the +-1 codes into int32 words (pack_bits_mxu).
//
//   s    = k - 2 * sum_words popc(x ^ w)        (+-1 dot product)
//   s    = nnz[n] - 2 * sum_words popc(m & (x ^ sgnw))   (ternary dense)
//   bit  = sgn[n] * s >= tau[n]                 (folded BN + sign, int32)
//   word = __ballot_sync of the 32 bits of 32 consecutive channels
//
// One warp owns 32 consecutive output channels of a few rows, so lane j's
// threshold bit is bit j of the ballot: exactly the LSB-first packing
// contract of qnx/ops/packing.py.  Any N is allowed: the last group's lanes
// with channel >= N read no weight, sgn or tau and vote 0, so the pad bits
// of the last word are 0, as pack_bits_mxu makes them; every lane still
// takes part in the full-warp ballot.  Ternary pad words are 0 in the mask
// plane and add nothing.
//
// What bounds these kernels on an H100: per 32 binary MACs the inner loop
// issues one XOR, one POPC and one IADD on the CUDA cores (one more AND for
// ternary weights).  POPC is the slowest of them: the CUDA C++ Programming
// Guide's table of native arithmetic instruction throughput lists 16 results
// per clock per SM for 32-bit population count at compute capability 9.0,
// against 64 for 32-bit bitwise ops and IADD; a dependent xor+popc probe on
// an H100 SXM measured 15.83 per clock per SM.  That caps the card at 132 SMs
// x 16 popc x 32 MAC per clock (about 1.34e14 binary MAC/s at the 1.98 GHz
// maximum SM clock).  The bytes are small beside that: activations are 1 bit
// per value and a layer's weight plane stays in L2.  This first version is
// the simple form: operands come straight from L1/L2 with no shared-memory
// staging, and register reuse is the only blocking (4 rows per thread on
// one weight word, popcount_rows.cuh).  The int8 tensor cores
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

const char* qnx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
