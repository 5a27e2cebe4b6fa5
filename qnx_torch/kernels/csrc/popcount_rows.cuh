// Launch geometry of kernel G (gemm_formulations.cu): the
// CUDA-core layout kernels B and C had at wide N until they moved to the
// single-bit tensor cores (popcount_gemm.cu); G with one accumulator is
// that layout, the accumulator scan's CUDA-core baseline.
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

}  // namespace
