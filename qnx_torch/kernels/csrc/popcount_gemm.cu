// Packed binary and ternary popcount GEMMs with int32 output on Hopper's
// single-bit tensor cores (sm_90a): kernels B and C at wide N.
//
// Replaces the Pallas kernels qnx/kernels/xnor_gemm.py:_xnor_gemm_kernel
// (:73; entry xnor_gemm_popcount :91, pallas_call :127; kernel B) and
// qnx/kernels/ternary_gemm.py:_ternary_gemm_kernel (:29; entry ternary_gemm
// :41, pallas_call :71; kernel C):
//
//   s[m, n] = k - 2 * sum_words popc(x[m] ^ w[n])                      (binary)
//   s[m, n] = nnz[n] - 2 * sum_words popc(mask[n] & (x[m] ^ sign[n]))  (ternary)
//
// They serve the TP ring's chunks (qnx_torch/parallel/tp_forward.py, B)
// and the measurement path at wide N (the shootout's baseline, the
// accumulator scan, the roofline); the models' logit heads, at N = 10, run
// popcount_head.cu.
//
// The mainloop, its algebra (XOR as AND products and operand popcounts) and
// its design are popcount_gemm.cuh's, shared with F4 and G
// (gemm_formulations.cu).  B and C fill its tiles by cp.async, the (Kw, N)
// weights staged by a word transpose, 128 columns a block, a ring of three
// stages with one wgmma group in flight across the barrier.
//
// What bounds it on an H100: the single-bit wgmma runs at 7.9e15 MAC/s,
// 7.95x the int8 one (qnx_torch/bench/tc_probe.py; PERF.md §6), so at
// 1024 x 4096 x 4096 B's MACs take 0.0022 ms and C's two products 0.0043,
// under the bytes (the 16.8 MB int32 output, 0.0058 and 0.0064 ms at 3.35
// TB/s with the operands): the output bytes bound both.  The CUDA-core
// layout this replaces issued a __popc per word pair and ran at 0.81-0.90
// of the popc ceiling, 3x one torch._int_mm.  This kernel runs a step's
// copies, barrier, wgmma, popcounts and, at the end, its stores in series
// in each block (each 1.3-3.7 us of B's 17 at that shape), and at one K
// step on 4-8 blocks (the TP ring's smallest chunks) that chain takes
// 4 us where the old layout's 64-128 small blocks took 2.  Measured
// against it (PERF.md §6): copies two steps ahead with each step's wgmma
// waited before its end, and C's ms made in place after a cp.async of both
// planes; B unchanged, C 30% slower.  B takes two blocks a SM, C (two
// product tiles, 128 accumulators a thread) one.
#include "popcount_gemm.cuh"

extern "C" {

// Plain C entry points, bound with ctypes by qnx_torch/kernels/_build.py.
// Each launches on the given stream, does not synchronise, and returns
// cudaGetLastError() so a refused launch is reported at once.

int qnx_xnor_gemm_popcount(const void* xp, const void* wp, void* out, int m,
                           int kw, int n, int k, void* stream) {
  return qnx::launch_staged<false, 1, 128, 3>(
      qnx::GemmArgs{static_cast<const unsigned*>(xp), static_cast<const unsigned*>(wp),
                    nullptr, nullptr, static_cast<int*>(out), m, kw, n, k},
      stream);
}

int qnx_ternary_gemm(const void* xp, const void* mask, const void* sign,
                     const void* nnz, void* out, int m, int kw, int n,
                     void* stream) {
  return qnx::launch_staged<true, 1, 128, 3>(
      qnx::GemmArgs{static_cast<const unsigned*>(xp), static_cast<const unsigned*>(mask),
                    static_cast<const unsigned*>(sign), static_cast<const int*>(nnz),
                    static_cast<int*>(out), m, kw, n, 0},
      stream);
}

}  // extern "C"
