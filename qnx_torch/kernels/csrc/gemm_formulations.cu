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
//   chunk3d<BM, BN, KC>    v_chunk3d (F3), on the CUDA cores: K in slabs of
//                          32 words through a cp.async ring in shared
//                          memory; per KC-word chunk a thread XORs its rows'
//                          and columns' words and reduces each output's KC
//                          words by a carry-save tree of full adders (LOP3)
//                          to 3, 4 or 5 counter words, one POPC each.
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
// F3 stays on the CUDA cores, the measurement path's one witness of them.
// POPC issues at 16 a clock an SM against 64 for LOP3 and IADD3 (compute
// capability 9.0), so a chunk's popcount sum is mostly LOP3: KC XORs and two
// LOP3 a full adder, then L + 1 POPC for KC words (L = floor(log2 KC))
// where a POPC a word would take KC; its least time is the larger of its
// integer issue, its POPC issue and its shared-memory bytes
// (roofline.chunk3d_unit_bound): POPC at KC = 4, integer issue at 8 and 16.
// Pad bits are 0 in both operands, so they XOR to 0; words past Kw, rows
// past M and columns past N stage as 0 and are never stored.  F1, F2, F4 and
// G run the AND-popcount wgmma at B's rate (s = k - 2 (rx + cw) + 4 P,
// popcount_gemm.cuh); their least time is B's, bound by the int32 output's
// bytes (0.0058 ms at 1024 x 4096 x 4096).  F1 measures what B's
// per-step barriers and refills cost, F2 what narrower K steps cost, F4
// what B's transposing weight copies cost against TMA boxes, G whether
// independent wgmma groups shorten B's step chain.
#include <cuda_runtime.h>

#include "popcount_gemm.cuh"

namespace {

constexpr int kSide = 16;              // threads along each side of a block tile
constexpr int kThreads = kSide * kSide;
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

using qnx::cp_async;
using qnx::cp_async_commit;
using qnx::cp_async_wait;

constexpr int kSlab = 32;               // words of K a slab
constexpr int kSlabStride = kSlab + 4;  // 16-byte aligned rows; 8 rows' uint4 span 32 banks
constexpr int kRing = 3;                // slabs in the cp.async ring

// An F3 block's dynamic shared memory: kRing stages, each a slab of x
// [BM][kSlabStride] and of w transposed [BN][kSlabStride]
// (gemm_formulations.chunk3d_smem_bytes).
constexpr size_t chunk3d_smem_bytes(int bm, int bn) {
  return sizeof(unsigned) * kRing * (bm + bn) * kSlabStride;
}

// One full adder a bit lane, a + b + c = sum + 2 carry: one LOP3 each, the
// sum a ^ b ^ c (truth table 0x96) and the carry maj(a, b, c) (0xe8).  As
// C expressions ptxas issued 19 LOP3 for kc = 8's four adders and eight
// XORs, not 16.
__device__ __forceinline__ void full_add(unsigned a, unsigned b, unsigned c,
                                         unsigned& sum, unsigned& carry) {
  asm("lop3.b32 %0, %1, %2, %3, 0x96;" : "=r"(sum) : "r"(a), "r"(b), "r"(c));
  asm("lop3.b32 %0, %1, %2, %3, 0xe8;" : "=r"(carry) : "r"(a), "r"(b), "r"(c));
}

// sum_c popc(z[c]) of a KC-word chunk through a carry-save tree of full
// adders (gemm_formulations.chunk3d_tree, the same adders in the same
// order): each weight's words are added three at a time, oldest first, the
// sum kept at that weight and the carry sent up one, until fewer than three
// are left; the counter words left take one POPC each, weighted by a shift,
// which ptxas folds into the accumulator as one IMAD a counter (the FMA
// pipe, beside the LOP3 pipe).  A half adder would leave as many words, so
// as many POPC, and is not used.  KC = 4: 1 full adder, 3 POPC; 8: 4, 4;
// 16: 11, 5.
template <int KC>
__device__ __forceinline__ int chunk_popc(const unsigned (&z)[KC]) {
  if constexpr (KC == 4) {
    unsigned s, c;
    full_add(z[0], z[1], z[2], s, c);
    return __popc(z[3]) + __popc(s) + (__popc(c) << 1);
  } else if constexpr (KC == 8) {
    unsigned s0, c0, s1, c1, s2, c2, s3, c3;
    full_add(z[0], z[1], z[2], s0, c0);
    full_add(z[3], z[4], z[5], s1, c1);
    full_add(z[6], z[7], s0, s2, c2);
    full_add(c0, c1, c2, s3, c3);
    return __popc(s1) + __popc(s2) + (__popc(s3) << 1) + (__popc(c3) << 2);
  } else {
    static_assert(KC == 16, "KC: 4, 8 or 16");
    unsigned a[7], b[7], d[3], e[3], f, g;
    full_add(z[0], z[1], z[2], a[0], b[0]);  // weight 1: 16 words -> 2
    full_add(z[3], z[4], z[5], a[1], b[1]);
    full_add(z[6], z[7], z[8], a[2], b[2]);
    full_add(z[9], z[10], z[11], a[3], b[3]);
    full_add(z[12], z[13], z[14], a[4], b[4]);
    full_add(z[15], a[0], a[1], a[5], b[5]);
    full_add(a[2], a[3], a[4], a[6], b[6]);
    full_add(b[0], b[1], b[2], d[0], e[0]);  // weight 2: 7 words -> 1
    full_add(b[3], b[4], b[5], d[1], e[1]);
    full_add(b[6], d[0], d[1], d[2], e[2]);
    full_add(e[0], e[1], e[2], f, g);        // weight 4: 3 words -> 1
    return __popc(a[5]) + __popc(a[6]) + (__popc(d[2]) << 1) + (__popc(f) << 2) +
           (__popc(g) << 3);
  }
}

// grid (ceil(n / BN), ceil(m / BM)), kThreads threads, dynamic shared memory
// chunk3d_smem_bytes(BM, BN); x's rows hold Kw rounded up to 4 words (zeros
// past Kw) at a 16-byte aligned address.  A thread owns TM = BM / 16 rows
// (ty + 16 i) and TN = BN / 16 columns (tx + 16 j).  K goes in slabs of 32
// words through a ring of kRing stages filled by cp.async, one barrier a
// slab: the barrier that makes slab t visible also retires slab t - 1's
// stage, which the copies of slab t + kRing - 1 then refill while slab t is
// reduced.  x's slab rows copy as 16-byte units, a warp's loads 4 rows of
// 128 bytes; w's slab is stored transposed, [BN][kSlabStride], by 4-byte
// copies, 4 lanes on 4 words of a column and 8 columns a warp (32-byte
// sectors, the 32 lanes on 32 banks), so a thread's KC words of a row or a
// column are contiguous.  Words past Kw, rows past M and columns past N stage
// as 0.  Each KC-word chunk: a thread holds its TM rows' words, and for each
// of its TN columns XORs them into KC words per output and reduces them by
// chunk_popc into the output's one int32 accumulator.
template <int BM, int BN, int KC>
__global__ void __launch_bounds__(kThreads, 2)
chunk3d_kernel(const unsigned* __restrict__ xp, const unsigned* __restrict__ wp,
               int* __restrict__ out, int m, int kw, int n, int k) {
  static_assert(BM % kSide == 0 && BN % kSide == 0 && kSlab % KC == 0, "tiling");
  constexpr int TM = BM / kSide, TN = BN / kSide;
  constexpr int kUnits = kSlab / 4;                       // 16-byte units of an x row
  constexpr int kXCopies = BM * kUnits / kThreads;        // a thread's, a slab
  constexpr int kWCopies = BN * kSlab / kThreads;
  static_assert(BM * kUnits % kThreads == 0 && BN * kSlab % kThreads == 0, "copies");
  extern __shared__ __align__(16) unsigned smem[];
  unsigned* xs = smem;                                 // [kRing][BM][kSlabStride]
  unsigned* ws = smem + kRing * BM * kSlabStride;      // [kRing][BN][kSlabStride]
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, tx = tid % kSide, ty = tid / kSide;
  const int kw4 = (kw + 3) & ~3;  // x's row length
  const int slabs = (kw + kSlab - 1) / kSlab;

  auto fill = [&](int slab) {
    const int kw0 = slab * kSlab;
    unsigned* sx = xs + (slab % kRing) * BM * kSlabStride;
    unsigned* sw = ws + (slab % kRing) * BN * kSlabStride;
#pragma unroll
    for (int j = 0; j < kXCopies; ++j) {
      const int u = tid + j * kThreads;
      const int r = u / kUnits, c = 4 * (u % kUnits);
      const bool valid = m0 + r < m && kw0 + c < kw4;
      cp_async<16>(sx + r * kSlabStride + c,
                   valid ? xp + static_cast<size_t>(m0 + r) * kw4 + kw0 + c : xp, valid);
    }
#pragma unroll
    for (int j = 0; j < kWCopies; ++j) {
      const int u = tid + j * kThreads;
      const int c = u % 4 + 4 * (u / (4 * BN)), col = (u / 4) % BN;
      const bool valid = kw0 + c < kw && n0 + col < n;
      cp_async<4>(sw + col * kSlabStride + c,
                  valid ? wp + static_cast<size_t>(kw0 + c) * n + n0 + col : wp, valid);
    }
  };

  int acc[TM][TN] = {};
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {  // the ring's first kRing - 1 slabs
    if (s < slabs) fill(s);
    cp_async_commit();
  }
  for (int slab = 0; slab < slabs; ++slab) {
    cp_async_wait<kRing - 2>();  // this thread's copies of the slab have landed
    __syncthreads();             // ... every thread's; slab - 1's stage is free
    if (slab + kRing - 1 < slabs) fill(slab + kRing - 1);
    cp_async_commit();           // one group a slab, empty or not
    const unsigned* sx = xs + (slab % kRing) * BM * kSlabStride + ty * kSlabStride;
    const unsigned* sw = ws + (slab % kRing) * BN * kSlabStride + tx * kSlabStride;
#pragma unroll 1
    for (int c0 = 0; c0 < kSlab; c0 += KC) {  // the chunk loop
      unsigned a[TM][KC];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int q = 0; q < KC / 4; ++q) {
          const uint4 v = *reinterpret_cast<const uint4*>(
              sx + i * kSide * kSlabStride + c0 + 4 * q);
          a[i][4 * q] = v.x;
          a[i][4 * q + 1] = v.y;
          a[i][4 * q + 2] = v.z;
          a[i][4 * q + 3] = v.w;
        }
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        unsigned b[KC];
#pragma unroll
        for (int q = 0; q < KC / 4; ++q) {
          const uint4 v = *reinterpret_cast<const uint4*>(
              sw + j * kSide * kSlabStride + c0 + 4 * q);
          b[4 * q] = v.x;
          b[4 * q + 1] = v.y;
          b[4 * q + 2] = v.z;
          b[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          unsigned z[KC];
#pragma unroll
          for (int c = 0; c < KC; ++c) z[c] = a[i][c] ^ b[c];
          acc[i][j] += chunk_popc<KC>(z);
        }
      }
    }
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
  if (!rows_fit(m, BM) || reinterpret_cast<uintptr_t>(xp) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  static const cudaError_t configured = [] {
    cudaError_t e = cudaFuncSetAttribute(chunk3d_kernel<BM, BN, KC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(chunk3d_smem_bytes(BM, BN)));
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(chunk3d_kernel<BM, BN, KC>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    }
    return e;
  }();
  if (configured != cudaSuccess) return configured;
  chunk3d_kernel<BM, BN, KC><<<dim3((n + BN - 1) / BN, (m + BM - 1) / BM), kThreads,
                               chunk3d_smem_bytes(BM, BN), stream>>>(xp, wp, out, m, kw,
                                                                     n, k);
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

// F3: xp's rows hold Kw rounded up to 4 words (zeros past Kw) at a 16-byte
// aligned address, as F1's; wp is (Kw, N).
int qnx_gemm_chunk3d(const void* xp, const void* wp, void* out, int m, int kw,
                     int n, int k, int bm, int bn, int kc, void* stream) {
  if (bm == 64 && bn == 64 && kc == 4) return launch_chunk3d<64, 64, 4>(QNX_ARGS);
  if (bm == 64 && bn == 64 && kc == 8) return launch_chunk3d<64, 64, 8>(QNX_ARGS);
  if (bm == 32 && bn == 64 && kc == 16) return launch_chunk3d<32, 64, 16>(QNX_ARGS);
  if (bm == 64 && bn == 128 && kc == 4) return launch_chunk3d<64, 128, 4>(QNX_ARGS);
  if (bm == 64 && bn == 128 && kc == 8) return launch_chunk3d<64, 128, 8>(QNX_ARGS);
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
