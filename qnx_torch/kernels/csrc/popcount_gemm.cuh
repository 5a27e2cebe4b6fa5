// The packed binary (and two-plane ternary) popcount GEMM with int32 output
// on Hopper's single-bit tensor cores (sm_90a): one mainloop for kernels B
// and C at wide N (popcount_gemm.cu) and for F2, F4 and G, the measurement
// path's K-step scan, dot form and accumulator scan (gemm_formulations.cu;
// F1 there stages all of K once and shares the tiles and helpers below).
//
// The algebra.  wgmma takes single-bit operands only with AND
// (wgmma.mma_async m64nNk256 .s32.b1.b1.and.popc), so each XOR becomes AND
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
// Design: a block of two warpgroups owns 128 rows x kBN columns (128 or
// 64), each warpgroup its 64 rows.  A K step is 32 words (1024 bits): one
// 128-byte K-major row of each tile in the 128-byte swizzle (wgmma_conv.cuh),
// four k256 wgmma a warpgroup (eight for C, against mask and against ms); a
// step past the last word issues only the k256 that hold words.  F2 steps
// through K kStepW = 16 or 8 words at a time instead: 64- or 32-byte tile
// rows in the swizzle of that width, two or one k256 a step (Step<>).  The
// tiles form a ring of kStages.  Two ways to fill it:
//   * staged (B, C, F2, G): x (M, Kw) is K-major and copies by cp.async, 16
//     bytes where Kw % 4 == 0 and x is 16-byte aligned, else 4.  The weights
//     (Kw, N) are N-major, as the JAX kernels and the TP ring's row shards
//     take them, so each weight tile is staged by a word transpose: a thread
//     copies word i of column n into word i of tile row n, its warp's loads
//     coalesced along n (B, G: 4-byte cp.async; C: mask and sign loaded into
//     registers, mask and ms = mask & sign stored, made visible to wgmma by
//     fence.proxy.async before the step's barrier), so no caller makes a
//     K-major copy.
//   * TMA (kTma, F4): both operands K-major, x (M, Kw) and wt (N, Kw), so a
//     tile is one 2-D box of 32 words x its rows, which the Tensor Memory
//     Accelerator writes in the 128-byte swizzle itself, zeros past the
//     tensor's edge; one thread arms the stage's mbarrier with the stage's
//     bytes and issues both boxes, and every thread waits on the barrier.
//     No word transpose and no register staging.  The tensor maps need
//     16-byte-aligned rows: Kw % 4 == 0 (the wrapper pads the others).
// rx and cw (B, F2, F4, G) or c_ms (C) are summed from the staged tiles
// while the step's wgmma run: one 16-byte shared load and four __popc per
// 128 bits of a tile row, (BM + BN) 32 (B) or BN 32 (C) popc a block a step.
// kNacc fragment sets (G): K step i accumulates into set i % kNacc, and
// after committing a step the loop waits until kNacc groups are in flight
// (wgmma.wait_group kNacc), each on its own set, so no group waits on the
// one before it; the sets are summed in registers before the epilogue.
// kNacc = 1 is B's schedule: one group in flight across the barrier, as in
// kernel E (i8_conv_fused.cu).  A stage is refilled once the group that read
// it is done: copies run kStages - 1 - kNacc steps ahead, and the barrier at
// the top of each step holds the refill until every warpgroup has waited.
// Epilogue (store_tile, F1's too): the int32 s from the accumulator
// fragments, the row and column terms from shared memory, stores masked at M
// and N, two columns at a time where N is even.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; libcuda is not linked

#include <cstddef>
#include <cstdint>

#include "wgmma_conv.cuh"

namespace qnx {
namespace {

constexpr int kBM = 128;               // rows of a block: two warpgroups of 64
constexpr int kKW = 32;                // words of K a step: a 128-byte tile row
constexpr int kRowBytes = kKW * 4;
constexpr int kK256 = kKW / 8;         // k256 wgmma a step
constexpr int kThreads = 256;
constexpr int kChunks = kRowBytes / 16;  // 16-byte chunks of a tile row
constexpr size_t kSmemPerSm = 233472;  // 228 KiB, 1 KiB of it reserved a block
static_assert(kChunks == 8, "128-byte rows");

// The tiles of a K step of kStepW words: rows of 4 kStepW bytes in the
// swizzle of that width, whose phase (the chunk index a row XORs in)
// advances every kRowsAPhase rows.
template <int kStepW>
struct Step {
  static_assert(kStepW == 32 || kStepW == 16 || kStepW == 8, "128-, 64- or 32-byte rows");
  static constexpr int kRowBytes = 4 * kStepW;
  static constexpr int kK256 = kStepW / 8;             // k256 wgmma a step
  static constexpr int kTileBytes = kBM * kRowBytes;   // the x tile
  static constexpr int kChunks = kRowBytes / 16;       // 16-byte chunks of a row
  static constexpr int kRowStride = kThreads / kChunks;
  static constexpr int kPhaseShift = kStepW == 32 ? 0 : kStepW == 16 ? 1 : 2;
};

struct GemmArgs {
  const unsigned* x;     // (M, Kw)
  const unsigned* w;     // (Kw, N), or (N, Kw) where kTma: B's, F4's or G's
                         // weights, or C's mask plane
  const unsigned* sign;  // (Kw, N): C's sign plane
  const int* nnz;        // (N,): C's base
  int* out;              // (M, N)
  int m, kw, n, k;
};

// The tensor maps of F4's x (M, Kw) and wt (N, Kw).
struct TmaMaps {
  CUtensorMap x, w;
};

// The bytes of one ring stage: the x tile, then the weight tiles (w; or
// mask, then ms) of kBN rows each, at K steps of step_w words.
__host__ __device__ constexpr size_t stage_bytes(bool ternary, int bn, int step_w = kKW) {
  return static_cast<size_t>(kBM + (ternary ? 2 : 1) * bn) * 4 * step_w;
}

// The tile ring, a barrier a stage (kTma), then each thread's popcount
// share, the column and row terms.
__host__ __device__ constexpr size_t smem_bytes(bool ternary, bool tma, int bn, int stages,
                                                int step_w = kKW) {
  return kSwizzleAlign + stages * stage_bytes(ternary, bn, step_w) +
         (tma ? sizeof(uint64_t) * stages : 0) + sizeof(int) * (kThreads + bn + kBM);
}

// Two blocks a SM where both their accumulators (64 a thread) and their
// shared memory fit twice, else one.
__host__ __device__ constexpr int min_blocks(bool ternary, bool tma, int nacc, int bn,
                                             int stages, int step_w = kKW) {
  return (ternary ? 2 : 1) * nacc * bn / 2 <= 64 &&
                 2 * (smem_bytes(ternary, tma, bn, stages, step_w) + 1024) <= kSmemPerSm
             ? 2
             : 1;
}

// Byte offset of word i of row r in a swizzled tile of kStepW-word rows.
template <int kStepW = kKW>
__device__ __forceinline__ int word_at(int r, int i) {
  using S = Step<kStepW>;
  return r * S::kRowBytes +
         ((((i >> 2) ^ ((r >> S::kPhaseShift) & (S::kChunks - 1)))) << 4) + ((i & 3) << 2);
}

// The popcount of 16-byte chunks [c0, c0 + kCount) of row r of a swizzled
// tile of kStepW-word rows; eight consecutive rows read eight distinct bank
// groups.
template <int kCount, int kStepW = kKW>
__device__ __forceinline__ int row_popc(const unsigned char* tile, int r, int c0) {
  using S = Step<kStepW>;
  int sum = 0;
#pragma unroll
  for (int c = c0; c < c0 + kCount; ++c) {
    const uint4 v = *reinterpret_cast<const uint4*>(
        tile + r * S::kRowBytes + ((c ^ ((r >> S::kPhaseShift) & (S::kChunks - 1))) << 4));
    sum += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
  }
  return sum;
}

// Byte offset of 16-byte copy unit u of a swizzled x tile of kStepW-word
// rows: unit u is chunk (u / 8) % kChunks of row (u / (8 kChunks)) 8 + u % 8,
// so eight consecutive units, one chunk of eight rows, land in eight
// distinct bank groups (swizzle128 at 128-byte rows).
template <int kStepW>
__device__ __forceinline__ int copy_unit_at(int u) {
  using S = Step<kStepW>;
  if constexpr (kStepW == kKW) {
    return swizzle128(u);
  } else {
    return word_at<kStepW>(u / (8 * S::kChunks) * 8 + (u & 7), (u >> 3) % S::kChunks * 4);
  }
}

// The wgmma descriptor of a tile of kStepW-word rows.
template <int kStepW>
__device__ __forceinline__ uint64_t step_desc(const void* tile) {
  if constexpr (kStepW == 32) {
    return tile_desc_sw128(tile);
  } else if constexpr (kStepW == 16) {
    return tile_desc_sw64(tile);
  } else {
    return tile_desc_sw32(tile);
  }
}

// The epilogue of a 128 x kBN tile at (m0, n0): each of this thread's two
// rows (wrow, wrow + 8 of the tile), two columns of an n8 tile at a time;
// unsigned sums, exact where s fits an int32.  B's s is row_base[row] +
// col_base[col] + 4 acc[0] (k - 2 rx, -2 cw, P); C's col_base[col] + 4 acc[1]
// - 2 acc[0] (nnz - 2 c_ms, P_ms, P_m).  Stores masked at M and N, two
// columns at a time where N is even.
template <bool kTernary, int kBN, int kSets>
__device__ __forceinline__ void store_tile(const GemmArgs& a, int m0, int n0, int wrow, int t,
                                           const int* row_base, const int* col_base,
                                           int (&acc)[kSets][kBN / 2]) {
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

// One block's tile: grid (ceil(m / kBM), ceil(n / kBN)), block kThreads,
// dynamic shared memory smem_bytes(...).  kVec: the staged activation
// copies' bytes; maps: the TMA fill's tensor maps (kTma), in param space;
// kStepW: the words of a K step (F2: 16 or 8; the others 32).
template <bool kTernary, int kVec, bool kTma, int kNacc, int kBN, int kStages,
          int kStepW = kKW>
__device__ __forceinline__ void popcount_gemm_tile(const GemmArgs& a,
                                                   const TmaMaps* maps) {
  static_assert(!(kTernary && (kTma || kNacc > 1)), "C: staged, one set");
  static_assert(kBN == 128 || (kBN == 64 && !kTernary), "n128, or n64 for B's product");
  static_assert(kStepW == kKW || !(kTernary || kTma || kNacc > 1),
                "narrow K steps: F2, B's staged product with one set");
  using S = Step<kStepW>;
  constexpr int kPlanes = kTernary ? 2 : 1;
  constexpr int kRegs = kBN / 2;          // accumulators of a set, a thread
  constexpr int kWTile = kBN * S::kRowBytes;  // a weight tile
  constexpr size_t kStage = stage_bytes(kTernary, kBN, kStepW);
  constexpr int kAhead = kStages - 1 - kNacc;  // steps the copies run ahead
  static_assert(kAhead >= 1, "a ring of at least kNacc + 2 stages");
  constexpr int kRows = kBM / S::kRowStride;   // activation rows a thread copies
  constexpr int kWStride = kThreads / kBN;     // words between a thread's
  constexpr int kWords = kBN * kStepW / kThreads;  // kWords weight copies
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // stage s: the x tile [kBM][4 kStepW bytes], then the weight tiles
  // [kBN][4 kStepW bytes] (w; or mask, then ms), all swizzled
  unsigned char* smem = align_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStage);  // kTma
  int* part_s = reinterpret_cast<int*>(full + (kTma ? kStages : 0));
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

  // staged x copies: chunk ch of rows r0 + i kRowStride, copy u = tid + i
  // kThreads at copy_unit_at(u); weight copies: column wc, words wi0 +
  // kWStride j
  [[maybe_unused]] const int ch = (tid >> 3) % S::kChunks;
  [[maybe_unused]] const int r0 = tid / (8 * S::kChunks) * 8 + (tid & 7);
  [[maybe_unused]] const int wc = tid % kBN;
  [[maybe_unused]] const int wi0 = tid / kBN;
  [[maybe_unused]] const bool wlive = n0 + wc < a.n;

  const int steps = (a.kw + kStepW - 1) / kStepW;
  int i_step = 0, i_stage = 0;  // the next step to copy, its stage
  auto issue = [&]() {
    if (i_step < steps) {
      const int k0 = i_step * kStepW;
      unsigned char* tx = smem + i_stage * kStage;
      unsigned char* tw = tx + S::kTileBytes;
      if constexpr (kTma) {
        if (tid == 0) {
          mbar_arrive_expect_tx(full + i_stage, static_cast<unsigned>(kStage));
          tma_load_2d(tx, &maps->x, k0, m0, full + i_stage);
          tma_load_2d(tw, &maps->w, k0, n0, full + i_stage);
        }
      } else {
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int m = m0 + r0 + i * S::kRowStride;
          const int w0 = k0 + ch * 4;
          unsigned char* dst = tx + copy_unit_at<kStepW>(tid + i * kThreads);
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
          unsigned mv[kWords], sv[kWords];
#pragma unroll
          for (int j = 0; j < kWords; ++j) {
            const int kword = k0 + wi0 + kWStride * j;
            const bool valid = wlive && kword < a.kw;
            const size_t at = static_cast<size_t>(kword) * a.n + col;
            mv[j] = valid ? __ldg(a.w + at) : 0u;
            sv[j] = valid ? __ldg(a.sign + at) : 0u;
          }
#pragma unroll
          for (int j = 0; j < kWords; ++j) {
            const int off = word_at<kStepW>(wc, wi0 + kWStride * j);
            *reinterpret_cast<unsigned*>(tw + off) = mv[j];
            *reinterpret_cast<unsigned*>(tw + kWTile + off) = mv[j] & sv[j];
          }
        } else {
#pragma unroll
          for (int j = 0; j < kWords; ++j) {
            const int kword = k0 + wi0 + kWStride * j;
            const bool valid = wlive && kword < a.kw;
            cp_async<4>(tw + word_at<kStepW>(wc, wi0 + kWStride * j),
                        valid ? a.w + static_cast<size_t>(kword) * a.n + col : a.w,
                        valid);
          }
        }
      }
      ++i_step;
      i_stage = i_stage + 1 == kStages ? 0 : i_stage + 1;
    }
    if constexpr (!kTma) cp_async_commit();
  };

  // set q, n8 tile j: columns 8j + 2t, +1 of row wrow, then wrow + 8; C's
  // two products are sets 0 (mask) and 1 (ms)
  int acc[kNacc * kPlanes][kRegs];
#pragma unroll
  for (int p = 0; p < kNacc * kPlanes; ++p) {
#pragma unroll
    for (int r = 0; r < kRegs; ++r) acc[p][r] = 0;
  }
  int part = 0;  // B: rx of row tid or cw of column tid - kBM; C: half of c_ms

  if constexpr (kTma) {
    if (tid == 0) {
#pragma unroll
      for (int s = 0; s < kStages; ++s) mbar_init(full + s, 1);
      fence_mbarrier_init();
    }
    __syncthreads();
  }
#pragma unroll
  for (int s = 0; s < kAhead; ++s) issue();

  int stage = 0;        // step's
  unsigned phase = 0;  // kTma: the parity of stage's next completion
  for (int step0 = 0; step0 < steps; step0 += kNacc) {
#pragma unroll
    for (int q = 0; q < kNacc; ++q) {  // step step0 + q into set q
      const int step = step0 + q;
      if (step < steps) {  // uniform
        if constexpr (kTma) {
          mbar_wait(full + stage, phase);  // step's boxes have landed
        } else {
          cp_async_wait<kAhead - 1>();  // this thread's copies of step have landed
          fence_proxy_async();          // ... and its stores: visible to wgmma
        }
        // every thread's copies of step are visible, and every warpgroup
        // is done with the wgmma of step - kNacc - 1, which read the stage
        // the copies below refill (it waited for them in step - 1)
        __syncthreads();
        const unsigned char* tx = smem + stage * kStage;
        const unsigned char* tw = tx + S::kTileBytes;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1u;
        }
        const int k256 = min(S::kK256, (a.kw - step * kStepW + 7) / 8);  // uniform
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < S::kK256; ++kc) {
          if (kc < k256) {
            const uint64_t da = step_desc<kStepW>(tx + wg * 64 * S::kRowBytes + kc * 32);
#pragma unroll
            for (int p = 0; p < kPlanes; ++p) {
              wgmma_b1_k256(acc[q * kPlanes + p], da,
                            step_desc<kStepW>(tw + p * kWTile + kc * 32));
            }
          }
        }
        wgmma_commit();
        issue();  // step + kAhead, into the stage step - kNacc - 1 read
        // the operand popcounts of this step's tiles, while its wgmma run
        if constexpr (kTernary) {
          part += row_popc<kChunks / 2>(tw + kWTile, tid % kBN, tid / kBN * (kChunks / 2));
        } else if (kBM + kBN == kThreads || tid < kBM + kBN) {
          part += row_popc<S::kChunks, kStepW>(tid < kBM ? tx : tw, tid % kBM, 0);
        }
        wgmma_wait<kNacc>();  // kNacc groups, one a set, stay in flight
#pragma unroll
        for (int p = 0; p < kNacc * kPlanes; ++p) {
#pragma unroll
          for (int r = 0; r < kRegs; ++r) hold(acc[p][r]);
        }
      }
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int p = 0; p < kNacc * kPlanes; ++p) {
#pragma unroll
    for (int r = 0; r < kRegs; ++r) hold(acc[p][r]);
  }
  // the sets' sum (G): into set 0 (and C's ms product stays set 1)
#pragma unroll
  for (int q = 1; q < kNacc; ++q) {
#pragma unroll
    for (int r = 0; r < kRegs; ++r) acc[0][r] += acc[q * kPlanes][r];
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
    }
  }
  if (!kTernary && tid < kBM) {
    row_base[tid] = static_cast<int>(static_cast<unsigned>(a.k) - 2u * part_s[tid]);
  }
  __syncthreads();

  store_tile<kTernary, kBN>(a, m0, n0, wrow, t, row_base, col_base, acc);
}

// The staged fill (B, C, G) and the TMA fill (F4): the tensor maps are a
// __grid_constant__ parameter of the latter only.
template <bool kTernary, int kVec, int kNacc, int kBN, int kStages>
__global__ void __launch_bounds__(kThreads,
                                  min_blocks(kTernary, false, kNacc, kBN, kStages))
popcount_gemm_kernel(const GemmArgs a) {
  popcount_gemm_tile<kTernary, kVec, false, kNacc, kBN, kStages>(a, nullptr);
}

template <int kBN, int kStages>
__global__ void __launch_bounds__(kThreads, min_blocks(false, true, 1, kBN, kStages))
popcount_gemm_tma_kernel(const GemmArgs a, const __grid_constant__ TmaMaps maps) {
  popcount_gemm_tile<false, 16, true, 1, kBN, kStages>(a, &maps);
}

// F2: B's staged fill and product at K steps of kStepW = 16 or 8 words.
template <int kVec, int kStepW, int kBN, int kStages>
__global__ void __launch_bounds__(kThreads,
                                  min_blocks(false, false, 1, kBN, kStages, kStepW))
popcount_gemm_steps_kernel(const GemmArgs a) {
  popcount_gemm_tile<false, kVec, false, 1, kBN, kStages, kStepW>(a, nullptr);
}

// Launch kernel instance kKernel, with kBytes of dynamic shared memory and
// kBN columns a block.
template <auto kKernel, size_t kBytes, int kBN, class... Args>
int launch(const GemmArgs& a, cudaStream_t stream, const Args&... args) {
  // once per instance: the dynamic shared memory, and the SM's shared
  // memory split towards shared
  static const cudaError_t configured = [] {
    cudaError_t e = cudaFuncSetAttribute(
        kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kBytes));
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(kKernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    }
    return e;
  }();
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const dim3 grid((a.m + kBM - 1) / kBM, (a.n + kBN - 1) / kBN);
  kKernel<<<grid, kThreads, kBytes, stream>>>(a, args...);
  return static_cast<int>(cudaGetLastError());
}

// 4 P <= 128 Kw must fit an int32 (the wrappers refuse it first)
inline bool sizes_ok(const GemmArgs& a) {
  return a.kw < (1 << 24) && a.m >= 0 && a.n >= 0 && a.kw >= 0;
}

// The staged fill (B, C, G): 16-byte activation copies where x allows.
template <bool kTernary, int kNacc, int kBN, int kStages>
int launch_staged(const GemmArgs& a, void* stream) {
  if (!sizes_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  constexpr size_t bytes = smem_bytes(kTernary, false, kBN, kStages);
  if (a.kw % 4 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0) {
    return launch<popcount_gemm_kernel<kTernary, 16, kNacc, kBN, kStages>, bytes, kBN>(a, s);
  }
  return launch<popcount_gemm_kernel<kTernary, 4, kNacc, kBN, kStages>, bytes, kBN>(a, s);
}

// F2: the staged fill at K steps of kStepW words.
template <int kStepW, int kBN, int kStages>
int launch_steps(const GemmArgs& a, void* stream) {
  if (!sizes_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  constexpr size_t bytes = smem_bytes(false, false, kBN, kStages, kStepW);
  if (a.kw % 4 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0) {
    return launch<popcount_gemm_steps_kernel<16, kStepW, kBN, kStages>, bytes, kBN>(a, s);
  }
  return launch<popcount_gemm_steps_kernel<4, kStepW, kBN, kStages>, bytes, kBN>(a, s);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found through the runtime: the
// library is not linked against libcuda.  Null where the driver lacks it.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a K-major (rows, kw) word matrix read in boxes of 32 words x
// box_rows rows, 128-byte swizzled, zeros outside it.
inline bool encode_rows(EncodeTiled encode, CUtensorMap* map, const unsigned* base,
                        int rows, int kw, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kw), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kw) * 4};
  const cuuint32_t box[2] = {kKW, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2, const_cast<unsigned*>(base),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The TMA fill (F4): a.w is wt (N, Kw), K-major.  Both operands must be
// 16-byte aligned with Kw % 4 == 0 (16-byte row strides).
template <int kBN, int kStages>
int launch_tma(const GemmArgs& a, void* stream) {
  if (!sizes_ok(a) || a.kw % 4 != 0 || reinterpret_cast<uintptr_t>(a.x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a.w) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TmaMaps maps{};
  if (a.kw > 0 && a.m > 0 && a.n > 0) {  // else no K step reads them
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
    if (!encode_rows(encode, &maps.x, a.x, a.m, a.kw, kBM) ||
        !encode_rows(encode, &maps.w, a.w, a.n, a.kw, kBN)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return launch<popcount_gemm_tma_kernel<kBN, kStages>, smem_bytes(false, true, kBN, kStages),
                kBN>(a, static_cast<cudaStream_t>(stream), maps);
}

}  // namespace
}  // namespace qnx
