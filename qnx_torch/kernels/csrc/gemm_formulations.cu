// Five schedules of the packed binary popcount GEMM with int32 output, for
// Hopper (sm_90a).  Each computes kernel B's function (popcount_gemm.cu):
//
//   s[m, n] = k - 2 * sum_kw popc(xp[m, kw] ^ wp[kw, n])
//
// and replaces one Pallas kernel of the JAX package's formulation
// experiments.  None carries the TPU blocks over; each is the Hopper form of
// the schedule the TPU variant tests:
//
//   outer<BM, BN>          experiments/gemm_shootout.py:v_outer (F1): a block
//                          stages its whole (BM, Kw) and (Kw, BN) strips in
//                          shared memory in one fill behind one barrier, x
//                          as TMA boxes, the weights by B's word transpose;
//                          then each warpgroup issues every k256 wgmma of
//                          its 64 rows in one commit group, with no barrier
//                          or refill between K steps, for each 128 x BN'
//                          sub-tile of the block in turn (BN' = min(BN, 128)).
//   outer_acc<BN, BK, S>   v_outer_acc (F2): B's mainloop (popcount_gemm.cuh)
//                          at K steps of BK = 16 or 8 words, 64- or 32-byte
//                          tile rows in the swizzle of that width, through a
//                          ring of S stages, BN columns a block.
//   chunk3d<BM, BN, KC>    v_chunk3d (F3): K in slabs of 32 words in shared
//                          memory; per step a thread takes KC consecutive
//                          words of each of its rows and columns as uint4
//                          loads and adds the chunk's popcount sum.
//   lanered<BN, STAGES>    v_lanered (F4): the dot form, x (M, Kw) against
//                          wt (N, Kw), both K-major, on the single-bit tensor
//                          cores: B's mainloop with both tiles filled by TMA
//                          boxes into a ring of STAGES, BN columns a block;
//                          no word transpose.
//   multiacc<NACC>         experiments/xnor_sol_variants.py:xnor_multiacc
//                          (G): B's mainloop on B's N-major weights with NACC
//                          accumulator fragment sets, K step i into set
//                          i % NACC, NACC independent wgmma groups in flight;
//                          NACC = 1 is B's schedule.
//
// F3 stays on the CUDA cores, bound by popc issue, one popc per 32 MACs, at
// 16 popc per clock per SM (compute capability 9.0); xor and add issue
// beside it; what it varies is what feeds the popc unit (2 uint4 shared
// loads per 16 KC popc) and the occupancy its shared memory and registers
// leave.  Pad bits are 0 in both operands, so they XOR to 0; words past Kw,
// rows past M and columns past N stage as 0 and are never stored.  F1, F2,
// F4 and G run the AND-popcount wgmma at B's rate (s = k - 2 (rx + cw) +
// 4 P, popcount_gemm.cuh); their least time is B's, bound by the int32
// output's bytes (0.0058 ms at 1024 x 4096 x 4096).  F1 measures what B's
// per-step barriers and refills cost, F2 what narrower K steps cost, F4
// what B's transposing weight copies cost against TMA boxes, G whether
// independent wgmma groups shorten B's step chain.
#include <cuda_runtime.h>

#include "popcount_gemm.cuh"

namespace {

constexpr int kSide = 16;              // threads along each side of a block tile
constexpr int kThreads = kSide * kSide;
constexpr int kSlab = 32;              // chunk3d: words of K per shared-memory slab
constexpr int kSlabStride = kSlab + 4; // keeps rows 16-byte aligned, spreads banks
constexpr int kMaxGridY = 65535;

// The row blocks of a tiled kernel go in grid.y, which holds at most 65535.
inline bool rows_fit(int m, int bm) { return (m + bm - 1) / bm <= kMaxGridY; }

}  // namespace

namespace qnx {
namespace {

// ---------------------------------------------------------------- F1 outer

constexpr size_t kMaxSmem = 232448;  // 227 KiB, what one block may opt in to

// An F1 block's dynamic shared memory at kw words: the x strip [kt][bm
// rows][128 bytes] and the weight strip [kt][bn rows][128 bytes], kt =
// ceil(kw / 32) tiles in B's 128-byte swizzle, then the barrier and the row
// and column terms (gemm_formulations.outer_smem_bytes).
constexpr size_t outer_smem_bytes(int bm, int bn, int kw) {
  return kSwizzleAlign + static_cast<size_t>(bm + bn) * ((kw + kKW - 1) / kKW) * kRowBytes +
         sizeof(uint64_t) + sizeof(int) * (bm + bn);
}

// grid (ceil(m / BM), ceil(n / BN)), kThreads (256) threads, dynamic shared
// memory outer_smem_bytes(BM, BN, kw).  xmap: x (M, Kw4) in boxes of 32
// words x 128 rows, Kw4 = Kw rounded up to 4 (the wrapper pads x's rows).
template <int BM, int BN>
__global__ void __launch_bounds__(kThreads, 2)
popcount_outer_kernel(const GemmArgs a, const __grid_constant__ CUtensorMap xmap) {
  static_assert(BM % kBM == 0 && (BN == 64 || BN % 128 == 0) && BN <= kThreads,
                "128-row sub-tiles of 64 or 128 columns");
  constexpr int kSub = BN < 128 ? BN : 128;  // columns of a sub-tile, the wgmma's N
  constexpr int kRegs = kSub / 2;            // accumulators a thread
  constexpr int kWStride = kThreads / BN;    // words between a thread's
  constexpr int kWords = BN * kKW / kThreads;  // kWords weight copies a K tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  const int kt_n = (a.kw + kKW - 1) / kKW;  // K tiles of 32 words
  unsigned char* xs = smem;                                              // [kt][BM][128 B]
  unsigned char* ws = xs + static_cast<size_t>(kt_n) * BM * kRowBytes;   // [kt][BN][128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(ws + static_cast<size_t>(kt_n) * BN * kRowBytes);
  int* row_base = reinterpret_cast<int*>(full + 1);  // [BM]: k - 2 rx
  int* col_base = row_base + BM;                     // [BN]: -2 cw

  const int tid = threadIdx.x;
  __builtin_assume(tid < kThreads);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wg = warp >> 2;
  const int wrow = wg * 64 + (warp & 3) * 16 + g;  // and wrow + 8, of a sub-tile
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  // the 128-row sub-strips that hold rows of x: only they are filled
  const int row_blocks = min(BM / kBM, (a.m - m0 + kBM - 1) / kBM);

  // the fill: every x box on one barrier, every weight word by cp.async
  if (tid == 0) {
    mbar_init(full, 1);
    fence_mbarrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(full, static_cast<unsigned>(kt_n * row_blocks * kBM * kRowBytes));
    for (int kt = 0; kt < kt_n; ++kt) {
      for (int i = 0; i < row_blocks; ++i) {
        tma_load_2d(xs + (static_cast<size_t>(kt) * BM + i * kBM) * kRowBytes, &xmap,
                    kt * kKW, m0 + i * kBM, full);
      }
    }
  }
  // word i of column wc of a K tile to word i of its tile row wc (B's word
  // transpose), a warp's loads coalesced along n
  const int wc = tid % BN;
  const int wi0 = tid / BN;
  const bool wlive = n0 + wc < a.n;
  const size_t col = static_cast<size_t>(wlive ? n0 + wc : 0);
  for (int kt = 0; kt < kt_n; ++kt) {
    unsigned char* tw = ws + static_cast<size_t>(kt) * BN * kRowBytes;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const int i = wi0 + kWStride * j;
      const int kword = kt * kKW + i;
      const bool valid = wlive && kword < a.kw;
      cp_async<4>(tw + word_at(wc, i),
                  valid ? a.w + static_cast<size_t>(kword) * a.n + col : a.w, valid);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();  // this thread's copies: visible to wgmma
  mbar_wait(full, 0);   // every box has landed
  __syncthreads();      // ... and every thread's copies

  // the product: each 128 x kSub sub-tile in turn, all of K in one group
  int acc[1][kRegs];
  for (int i = 0; i < row_blocks; ++i) {
    for (int j = 0; j < BN / kSub; ++j) {
      const int nj = n0 + j * kSub;
      if (nj >= a.n) break;  // uniform
      // zeros pinned before the fence: an accumulator a plain instruction
      // defines inside the group would serialize its wgmma
#pragma unroll
      for (int r = 0; r < kRegs; ++r) {
        acc[0][r] = 0;
        hold(acc[0][r]);
      }
      wgmma_fence();
      for (int kt = 0; kt < kt_n; ++kt) {
        const unsigned char* tx =
            xs + (static_cast<size_t>(kt) * BM + i * kBM + wg * 64) * kRowBytes;
        const unsigned char* tw = ws + (static_cast<size_t>(kt) * BN + j * kSub) * kRowBytes;
        const int k256 = min(kK256, (a.kw - kt * kKW + 7) / 8);  // uniform
#pragma unroll
        for (int kc = 0; kc < kK256; ++kc) {
          if (kc < k256) {
            wgmma_b1_k256(acc[0], tile_desc_sw128(tx + kc * 32),
                          tile_desc_sw128(tw + kc * 32));
          }
        }
      }
      wgmma_commit();
      if (i == 0 && j == 0) {
        // the row and column terms from the staged strips, while the first
        // group runs: k - 2 rx of the filled rows, -2 cw of every column
        for (int r = tid; r < row_blocks * kBM + BN; r += kThreads) {
          const bool is_x = r < row_blocks * kBM;
          const int rr = is_x ? r : r - row_blocks * kBM;
          const unsigned char* strip = is_x ? xs : ws;
          const size_t tile = static_cast<size_t>(is_x ? BM : BN) * kRowBytes;
          int sum = 0;
          for (int kt = 0; kt < kt_n; ++kt) sum += row_popc<kChunks>(strip + kt * tile, rr, 0);
          if (is_x) {
            row_base[rr] = static_cast<int>(static_cast<unsigned>(a.k) - 2u * sum);
          } else {
            col_base[rr] = -2 * sum;
          }
        }
        __syncthreads();
      }
      wgmma_wait<0>();
#pragma unroll
      for (int r = 0; r < kRegs; ++r) hold(acc[0][r]);
      store_tile<false, kSub>(a, m0 + i * kBM, nj, wrow, t, row_base + i * kBM,
                              col_base + j * kSub, acc);
    }
  }
}

// F1's launch: x rows of Kw rounded up to 4 words at a 16-byte aligned
// address (the wrapper pads them), a.w (Kw, N).
template <int BM, int BN>
int launch_outer(const GemmArgs& a, void* stream) {
  if (!sizes_ok(a) || reinterpret_cast<uintptr_t>(a.x) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = outer_smem_bytes(BM, BN, a.kw);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t configured = [] {
    cudaError_t e = cudaFuncSetAttribute(popcount_outer_kernel<BM, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kMaxSmem));
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(popcount_outer_kernel<BM, BN>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    }
    return e;
  }();
  if (configured != cudaSuccess) return static_cast<int>(configured);
  CUtensorMap xmap{};
  if (a.kw > 0 && a.m > 0 && a.n > 0) {  // else no box is issued
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
    if (!encode_rows(encode, &xmap, a.x, a.m, (a.kw + 3) / 4 * 4, kBM)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const dim3 grid((a.m + BM - 1) / BM, (a.n + BN - 1) / BN);
  popcount_outer_kernel<BM, BN>
      <<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(a, xmap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace qnx

namespace {

// -------------------------------------------------------------- F3 chunk3d

__device__ __forceinline__ int popc_xor4(uint4 a, uint4 b) {
  return __popc(a.x ^ b.x) + __popc(a.y ^ b.y) + __popc(a.z ^ b.z) +
         __popc(a.w ^ b.w);
}

// grid (ceil(n / BN), ceil(m / BM)), kThreads threads; a thread owns
// TM = BM / 16 rows (ty + 16 i) and TN = BN / 16 columns (tx + 16 j).  The
// slab holds x as [BM][kSlabStride] and w transposed, [BN][kSlabStride], so
// a thread's KC words of a row or a column are contiguous.
template <int BM, int BN, int KC>
__global__ void __launch_bounds__(kThreads)
chunk3d_kernel(const unsigned* __restrict__ xp, const unsigned* __restrict__ wp,
               int* __restrict__ out, int m, int kw, int n, int k) {
  static_assert(KC % 4 == 0 && kSlab % KC == 0, "KC: 4, 8, 16 or 32");
  constexpr int TM = BM / kSide, TN = BN / kSide;
  __shared__ __align__(16) unsigned xs[BM * kSlabStride];
  __shared__ __align__(16) unsigned ws[BN * kSlabStride];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, tx = tid % kSide, ty = tid / kSide;

  int acc[TM][TN] = {};
  for (int kw0 = 0; kw0 < kw; kw0 += kSlab) {
    for (int i = tid; i < BM * kSlab; i += kThreads) {
      const int r = i / kSlab, c = i % kSlab;
      xs[r * kSlabStride + c] = m0 + r < m && kw0 + c < kw
          ? __ldg(xp + static_cast<size_t>(m0 + r) * kw + kw0 + c) : 0u;
    }
    for (int i = tid; i < kSlab * BN; i += kThreads) {
      const int c = i / BN, col = i % BN;
      ws[col * kSlabStride + c] = kw0 + c < kw && n0 + col < n
          ? __ldg(wp + static_cast<size_t>(kw0 + c) * n + n0 + col) : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int c0 = 0; c0 < kSlab; c0 += KC) {
      uint4 a[TM][KC / 4];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int q = 0; q < KC / 4; ++q)
          a[i][q] = *reinterpret_cast<const uint4*>(
              &xs[(ty + i * kSide) * kSlabStride + c0 + 4 * q]);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        uint4 b[KC / 4];
#pragma unroll
        for (int q = 0; q < KC / 4; ++q)
          b[q] = *reinterpret_cast<const uint4*>(
              &ws[(tx + j * kSide) * kSlabStride + c0 + 4 * q]);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          int chunk = 0;
#pragma unroll
          for (int q = 0; q < KC / 4; ++q) chunk += popc_xor4(a[i][q], b[q]);
          acc[i][j] += chunk;
        }
      }
    }
    __syncthreads();  // the next slab overwrites this one
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty + i * kSide;
    if (row >= m) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx + j * kSide;
      if (col < n) out[static_cast<size_t>(row) * n + col] = k - 2 * acc[i][j];
    }
  }
}

template <int BM, int BN, int KC>
cudaError_t launch_chunk3d(const unsigned* xp, const unsigned* wp, int* out,
                           int m, int kw, int n, int k, cudaStream_t stream) {
  if (!rows_fit(m, BM)) return cudaErrorInvalidValue;
  chunk3d_kernel<BM, BN, KC><<<dim3((n + BN - 1) / BN, (m + BM - 1) / BM), kThreads,
                               0, stream>>>(xp, wp, out, m, kw, n, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Plain C entry points, bound with ctypes by qnx_torch/kernels/_build.py.
// Each launches on the given stream, does not synchronise, and returns
// cudaGetLastError() (cudaErrorInvalidValue for a geometry that is not
// compiled in or does not fit), so a refused launch is reported at once.
// The geometries are those of qnx_torch/kernels/gemm_formulations.py.

#define QNX_ARGS                                                            \
  static_cast<const unsigned*>(xp), static_cast<const unsigned*>(wp),       \
      static_cast<int*>(out), m, kw, n, k, static_cast<cudaStream_t>(stream)

// F1: xp's rows hold Kw rounded up to 4 words (zeros past Kw) at a 16-byte
// aligned address; wp is (Kw, N).
int qnx_gemm_outer(const void* xp, const void* wp, void* out, int m, int kw, int n,
                   int k, int bm, int bn, void* stream) {
  const qnx::GemmArgs a{static_cast<const unsigned*>(xp), static_cast<const unsigned*>(wp),
                        nullptr, nullptr, static_cast<int*>(out), m, kw, n, k};
  if (bm == 128 && bn == 128) return qnx::launch_outer<128, 128>(a, stream);
  if (bm == 256 && bn == 128) return qnx::launch_outer<256, 128>(a, stream);
  if (bm == 256 && bn == 256) return qnx::launch_outer<256, 256>(a, stream);
  if (bm == 512 && bn == 256) return qnx::launch_outer<512, 256>(a, stream);
  if (bm == 1024 && bn == 128) return qnx::launch_outer<1024, 128>(a, stream);
  if (bm == 128 && bn == 64) return qnx::launch_outer<128, 64>(a, stream);
  return cudaErrorInvalidValue;
}

// F2: bn columns a block, K steps of bk words, a ring of `stages`.
int qnx_gemm_outer_acc(const void* xp, const void* wp, void* out, int m, int kw,
                       int n, int k, int bn, int bk, int stages, void* stream) {
  const qnx::GemmArgs a{static_cast<const unsigned*>(xp), static_cast<const unsigned*>(wp),
                        nullptr, nullptr, static_cast<int*>(out), m, kw, n, k};
  if (bn == 128 && bk == 16 && stages == 6) return qnx::launch_steps<16, 128, 6>(a, stream);
  if (bn == 128 && bk == 8 && stages == 12) return qnx::launch_steps<8, 128, 12>(a, stream);
  if (bn == 128 && bk == 16 && stages == 3) return qnx::launch_steps<16, 128, 3>(a, stream);
  if (bn == 64 && bk == 16 && stages == 9) return qnx::launch_steps<16, 64, 9>(a, stream);
  return cudaErrorInvalidValue;
}

int qnx_gemm_chunk3d(const void* xp, const void* wp, void* out, int m, int kw,
                     int n, int k, int bm, int bn, int kc, void* stream) {
  if (bm == 64 && bn == 64 && kc == 4) return launch_chunk3d<64, 64, 4>(QNX_ARGS);
  if (bm == 64 && bn == 64 && kc == 8) return launch_chunk3d<64, 64, 8>(QNX_ARGS);
  if (bm == 64 && bn == 64 && kc == 16) return launch_chunk3d<64, 64, 16>(QNX_ARGS);
  if (bm == 128 && bn == 128 && kc == 4) return launch_chunk3d<128, 128, 4>(QNX_ARGS);
  if (bm == 128 && bn == 128 && kc == 8) return launch_chunk3d<128, 128, 8>(QNX_ARGS);
  return cudaErrorInvalidValue;
}

// F4: wp is wt here, the weights transposed, (N, Kw) row-major.  Kw % 4 ==
// 0 and both operands 16-byte aligned (the TMA boxes' row strides).
int qnx_gemm_lanered(const void* xp, const void* wp, void* out, int m, int kw,
                     int n, int k, int bn, int stages, void* stream) {
  const qnx::GemmArgs a{static_cast<const unsigned*>(xp), static_cast<const unsigned*>(wp),
                        nullptr, nullptr, static_cast<int*>(out), m, kw, n, k};
  if (bn == 128 && stages == 3) return qnx::launch_tma<128, 3>(a, stream);
  if (bn == 128 && stages == 4) return qnx::launch_tma<128, 4>(a, stream);
  if (bn == 64 && stages == 4) return qnx::launch_tma<64, 4>(a, stream);
  return cudaErrorInvalidValue;
}

// G: a ring of NACC + 2 stages; four sets of 64 accumulators do not fit a
// thread, so NACC = 4 takes 64 columns a block.
int qnx_xnor_multiacc(const void* xp, const void* wp, void* out, int m, int kw,
                      int n, int k, int nacc, void* stream) {
  const qnx::GemmArgs a{static_cast<const unsigned*>(xp), static_cast<const unsigned*>(wp),
                        nullptr, nullptr, static_cast<int*>(out), m, kw, n, k};
  if (nacc == 1) return qnx::launch_staged<false, 1, 128, 3>(a, stream);
  if (nacc == 2) return qnx::launch_staged<false, 2, 128, 4>(a, stream);
  if (nacc == 4) return qnx::launch_staged<false, 4, 64, 6>(a, stream);
  return cudaErrorInvalidValue;
}

#undef QNX_ARGS

}  // extern "C"
