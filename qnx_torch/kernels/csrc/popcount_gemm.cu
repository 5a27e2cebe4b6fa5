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
// The algebra.  wgmma takes single-bit operands only with AND
// (wgmma.mma_async m64n128k256 .s32.b1.b1.and.popc), so each XOR becomes AND
// products and operand popcounts, exact for any bits:
//   popc(x ^ w) = popc(x) + popc(w) - 2 popc(x & w), so
//     s = k - 2 (rx[m] + cw[n]) + 4 P[m, n],          P = sum popc(x & w),
//   with rx, cw the popcounts of x's row and w's column;
//   popc(m & (x ^ s)) = popc(x & m) + popc(m & s) - 2 popc(x & m & s), so
//     s = nnz[n] - 2 P_m[m, n] - 2 c_ms[n] + 4 P_ms[m, n],
//   with P_m and P_ms the AND products of x against mask and against
//   ms = mask & sign, and c_ms the popcount of ms's column.
// Words past Kw, rows past M and columns past N are zero-filled, which AND
// to 0 and leave rx, cw and c_ms as they are.  4 P is at most 128 Kw: the
// entry points refuse Kw >= 2^24, so every term fits an int32.
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
// 4 us where the old layout's 64-128 small blocks took 2.
//
// Design: a block of two warpgroups owns 128 rows x 128 columns, each
// warpgroup its 64 rows.  A K step is 32 words (1024 bits): one 128-byte
// K-major row of each tile in the 128-byte swizzle (wgmma_conv.cuh), four
// k256 wgmma a warpgroup (eight for C, against mask and against ms); a step
// past the last word issues only the k256 that hold words.  x (M, Kw) is
// K-major and copies by cp.async, 16 bytes where Kw % 4 == 0 and x is
// 16-byte aligned, else 4.  The weights (Kw, N) are N-major, as the JAX
// kernel and the TP ring's row shards take them, so each weight tile is
// staged by a word transpose: a thread copies word i of column n into word
// i of tile row n, its warp's loads coalesced along n (B: 4-byte cp.async;
// C: mask and sign loaded into registers, mask and ms = mask & sign stored,
// made visible to wgmma by fence.proxy.async before the step's barrier), so
// no caller makes a K-major copy.  rx and cw (B) or c_ms (C) are summed from
// the staged tiles while the step's wgmma run: one 16-byte shared load and
// four __popc per 128 bits of a tile row, (BM + BN) 32 (B) or BN 32 (C) popc
// a block a step, against the old layout's 128 x 128 x 32 per step.  The
// tiles form a ring of kStages: copies run one step ahead, and one wgmma
// group stays in flight across the barrier (wgmma.wait_group 1), as in
// kernel E (i8_conv_fused.cu).  Measured against it (PERF.md §6):
// copies two steps ahead with each step's wgmma waited before its end, and
// C's ms made in place after a cp.async of both planes; B unchanged, C 30%
// slower.  B takes two blocks a SM, C (two product tiles, 128 accumulators
// a thread) one.  Epilogue: the int32 s from the accumulator fragments, the
// row and column terms from shared memory, stores masked at M and N, two
// columns at a time where N is even.
#include "wgmma_conv.cuh"

namespace {

using namespace qnx;

constexpr int kBM = 128;               // rows of a block: two warpgroups of 64
constexpr int kBN = 128;               // columns of a block
constexpr int kKW = 32;                // words of K a step: a 128-byte tile row
constexpr int kRowBytes = kKW * 4;
constexpr int kK256 = kKW / 8;         // k256 wgmma a step
constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kTileBytes = kBM * kRowBytes;  // every tile is 128 rows
constexpr int kChunks = kRowBytes / 16;      // 16-byte chunks of a tile row
constexpr int kRowStride = kThreads / kChunks;
constexpr int kWordsPerThread = kBN * kKW / kThreads;  // of a weight tile
static_assert(kBM == kBN && kChunks == 8, "square tiles of 128-byte rows");

struct GemmArgs {
  const unsigned* x;     // (M, Kw)
  const unsigned* w;     // (Kw, N): the binary weights, or C's mask plane
  const unsigned* sign;  // (Kw, N): C's sign plane
  const int* nnz;        // (N,): C's base
  int* out;              // (M, N)
  int m, kw, n, k;
};

template <bool kTernary>
constexpr int kWeightTiles = kTernary ? 2 : 1;  // w; or mask and ms

template <bool kTernary>
constexpr size_t kStageBytes = static_cast<size_t>(1 + kWeightTiles<kTernary>) * kTileBytes;

// the tile ring, then each thread's popcount share, the column and row terms
template <bool kTernary>
constexpr size_t kSmemBytes = kSwizzleAlign + kStages * kStageBytes<kTernary> +
                              sizeof(int) * (kThreads + kBN + kBM);

// Byte offset of word i of row r in a swizzled tile.
__device__ __forceinline__ int word_at(int r, int i) {
  return r * kRowBytes + ((((i >> 2) ^ (r & 7))) << 4) + ((i & 3) << 2);
}

// The popcount of 16-byte chunks [c0, c0 + kCount) of row r of a swizzled
// tile; eight consecutive rows read eight distinct bank groups.
template <int kCount>
__device__ __forceinline__ int row_popc(const unsigned char* tile, int r, int c0) {
  int sum = 0;
#pragma unroll
  for (int c = c0; c < c0 + kCount; ++c) {
    const uint4 v = *reinterpret_cast<const uint4*>(tile + r * kRowBytes +
                                                    ((c ^ (r & 7)) << 4));
    sum += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
  }
  return sum;
}

// grid (ceil(m / kBM), ceil(n / kBN)), block kThreads, dynamic shared
// memory kSmemBytes<kTernary>.  kVec: the activation copies' bytes.
template <bool kTernary, int kVec>
__global__ void __launch_bounds__(kThreads, kTernary ? 1 : 2)
popcount_gemm_kernel(const GemmArgs a) {
  constexpr int kPlanes = kWeightTiles<kTernary>;
  constexpr int kRows = kBM / kRowStride;  // activation rows a thread copies
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // stage s: the x tile [kBM][128 bytes], then the weight tiles [kBN][128
  // bytes] (w; or mask, then ms), all swizzled (swizzle128)
  unsigned char* smem = align_smem(smem_raw);
  int* part_s = reinterpret_cast<int*>(smem + kStages * kStageBytes<kTernary>);
  int* col_base = part_s + kThreads;  // [kBN]
  int* row_base = col_base + kBN;     // [kBM]

  const int tid = threadIdx.x;
  __builtin_assume(tid < kThreads);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;   // groupID
  const int t = lane & 3;    // threadID_in_group
  const int wg = warp >> 2;  // the warpgroup's 64 rows
  const int wrow = wg * 64 + (warp & 3) * 16 + g;  // and wrow + 8
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // x copies: chunk ch of rows r0 + i kRowStride, copy u = tid + i kThreads
  // at swizzle128(u); weight copies: column wc, words wi0 + 2 j
  const int ch = (tid >> 3) % kChunks;
  const int r0 = tid / (8 * kChunks) * 8 + (tid & 7);
  const int wc = tid % kBN;
  const int wi0 = tid / kBN;
  const bool wlive = n0 + wc < a.n;

  const int steps = (a.kw + kKW - 1) / kKW;
  int i_step = 0, i_stage = 0;  // the next step to copy, its stage
  auto issue = [&]() {
    if (i_step < steps) {
      const int k0 = i_step * kKW;
      unsigned char* tx = smem + i_stage * kStageBytes<kTernary>;
      unsigned char* tw = tx + kTileBytes;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int m = m0 + r0 + i * kRowStride;
        const int w0 = k0 + ch * 4;
        unsigned char* dst = tx + swizzle128(tid + i * kThreads);
        const unsigned* src = a.x + static_cast<size_t>(m < a.m ? m : 0) * a.kw + w0;
        if constexpr (kVec == 16) {
          const bool valid = m < a.m && w0 < a.kw;
          cp_async<16>(dst, valid ? src : a.x, valid);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool valid = m < a.m && w0 + j < a.kw;
            cp_async<4>(dst + 4 * j, valid ? src + j : a.x, valid);
          }
        }
      }
      const size_t col = static_cast<size_t>(wlive ? n0 + wc : 0);
      if constexpr (kTernary) {
        unsigned mv[kWordsPerThread], sv[kWordsPerThread];
#pragma unroll
        for (int j = 0; j < kWordsPerThread; ++j) {
          const int kword = k0 + wi0 + 2 * j;
          const bool valid = wlive && kword < a.kw;
          const size_t at = static_cast<size_t>(kword) * a.n + col;
          mv[j] = valid ? __ldg(a.w + at) : 0u;
          sv[j] = valid ? __ldg(a.sign + at) : 0u;
        }
#pragma unroll
        for (int j = 0; j < kWordsPerThread; ++j) {
          const int off = word_at(wc, wi0 + 2 * j);
          *reinterpret_cast<unsigned*>(tw + off) = mv[j];
          *reinterpret_cast<unsigned*>(tw + kTileBytes + off) = mv[j] & sv[j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < kWordsPerThread; ++j) {
          const int kword = k0 + wi0 + 2 * j;
          const bool valid = wlive && kword < a.kw;
          cp_async<4>(tw + word_at(wc, wi0 + 2 * j),
                      valid ? a.w + static_cast<size_t>(kword) * a.n + col : a.w,
                      valid);
        }
      }
      ++i_step;
      i_stage = i_stage + 1 == kStages ? 0 : i_stage + 1;
    }
    cp_async_commit();
  };

  int acc[kPlanes][64];  // n8 tile j: columns 8j + 2t, +1 of row wrow, then wrow + 8
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) {
#pragma unroll
    for (int r = 0; r < 64; ++r) acc[p][r] = 0;
  }
  int part = 0;  // B: rx of row tid or cw of column tid - kBM; C: half of c_ms

#pragma unroll
  for (int s = 0; s < kStages - 2; ++s) issue();

  int stage = 0;  // step's
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 3>();  // this thread's copies of step have landed
    fence_proxy_async();           // ... and its stores: visible to wgmma
    // every thread's copies of step are visible, and every warpgroup is
    // done with step - 2's wgmma (it waited for them in step - 1)
    __syncthreads();
    const unsigned char* tx = smem + stage * kStageBytes<kTernary>;
    const unsigned char* tw = tx + kTileBytes;
    stage = stage + 1 == kStages ? 0 : stage + 1;
    const int k256 = min(kK256, (a.kw - step * kKW + 7) / 8);  // uniform
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kK256; ++kc) {
      if (kc < k256) {
        const uint64_t da = tile_desc_sw128(tx + wg * 64 * kRowBytes + kc * 32);
#pragma unroll
        for (int p = 0; p < kPlanes; ++p) {
          wgmma_b1_k256(acc[p], da, tile_desc_sw128(tw + p * kTileBytes + kc * 32));
        }
      }
    }
    wgmma_commit();
    issue();  // step + kStages - 2, into the stage step - 2 read
    // the operand popcounts of this step's tiles, while its wgmma run
    if constexpr (kTernary) {
      part += row_popc<kChunks / 2>(tw + kTileBytes, tid % kBN, tid / kBN * (kChunks / 2));
    } else {
      part += row_popc<kChunks>(tid < kBM ? tx : tw, tid % kBM, 0);
    }
    wgmma_wait<1>();  // step - 1's group is done; step's stays in flight
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
#pragma unroll
      for (int r = 0; r < 64; ++r) hold(acc[p][r]);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) {
#pragma unroll
    for (int r = 0; r < 64; ++r) hold(acc[p][r]);
  }

  // the row and column terms: B's k - 2 rx and -2 cw, C's nnz - 2 c_ms
  part_s[tid] = part;
  __syncthreads();
  if (tid < kBN) {
    const int col = n0 + tid;
    if constexpr (kTernary) {
      const int nnz = col < a.n ? __ldg(a.nnz + col) : 0;
      col_base[tid] = static_cast<int>(static_cast<unsigned>(nnz) -
                                       2u * (part_s[tid] + part_s[tid + kBN]));
    } else {
      col_base[tid] = -2 * part_s[kBM + tid];
      row_base[tid] = static_cast<int>(static_cast<unsigned>(a.k) - 2u * part_s[tid]);
    }
  }
  __syncthreads();

  // epilogue: each of this thread's two rows, two columns of an n8 tile at
  // a time; unsigned sums, exact where s fits an int32
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + 8 * r;
    const int m = m0 + row;
    if (m >= a.m) continue;
    const unsigned rb = kTernary ? 0u : static_cast<unsigned>(row_base[row]);
    int* orow = a.out + static_cast<size_t>(m) * a.n + n0;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      if (n0 + 8 * j >= a.n) break;  // uniform: no column of this tile is real
      const int c = 8 * j + 2 * t;   // the block's column of e = 0
      int s[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * r + e;
        unsigned v = rb + static_cast<unsigned>(col_base[c + e]);
        if constexpr (kTernary) {
          v += 4u * static_cast<unsigned>(acc[1][i]) - 2u * static_cast<unsigned>(acc[0][i]);
        } else {
          v += 4u * static_cast<unsigned>(acc[0][i]);
        }
        s[e] = static_cast<int>(v);
      }
      const bool live1 = n0 + c + 1 < a.n;
      if (n0 + c < a.n) {
        if (live1 && (a.n & 1) == 0) {  // 8-byte aligned: n and c even
          *reinterpret_cast<int2*>(orow + c) = make_int2(s[0], s[1]);
        } else {
          orow[c] = s[0];
          if (live1) orow[c + 1] = s[1];
        }
      }
    }
  }
}

template <bool kTernary, int kVec>
int launch(const GemmArgs& a, cudaStream_t stream) {
  auto kernel = popcount_gemm_kernel<kTernary, kVec>;
  constexpr size_t bytes = kSmemBytes<kTernary>;
  // once per instance: the dynamic shared memory, and the SM's shared
  // memory split towards shared
  static const cudaError_t configured = [&] {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    }
    return e;
  }();
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const dim3 grid((a.m + kBM - 1) / kBM, (a.n + kBN - 1) / kBN);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kTernary>
int launch_gemm(const GemmArgs& a, void* stream) {
  // 4 P <= 128 Kw must fit an int32 (the wrappers refuse it first)
  if (a.kw >= (1 << 24) || a.m < 0 || a.n < 0 || a.kw < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (a.kw % 4 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0) {
    return launch<kTernary, 16>(a, s);
  }
  return launch<kTernary, 4>(a, s);
}

}  // namespace

extern "C" {

// Plain C entry points, bound with ctypes by qnx_torch/kernels/_build.py.
// Each launches on the given stream, does not synchronise, and returns
// cudaGetLastError() so a refused launch is reported at once.

int qnx_xnor_gemm_popcount(const void* xp, const void* wp, void* out, int m,
                           int kw, int n, int k, void* stream) {
  return launch_gemm<false>(
      GemmArgs{static_cast<const unsigned*>(xp), static_cast<const unsigned*>(wp),
               nullptr, nullptr, static_cast<int*>(out), m, kw, n, k},
      stream);
}

int qnx_ternary_gemm(const void* xp, const void* mask, const void* sign,
                     const void* nnz, void* out, int m, int kw, int n,
                     void* stream) {
  return launch_gemm<true>(
      GemmArgs{static_cast<const unsigned*>(xp), static_cast<const unsigned*>(mask),
               static_cast<const unsigned*>(sign), static_cast<const int*>(nnz),
               static_cast<int*>(out), m, kw, n, 0},
      stream);
}

}  // extern "C"
