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
//                          shared memory once; each thread keeps an 8x8
//                          register tile over all Kw words, one 128x128
//                          sub-tile of the block tile after another.
//   outer_acc<BM, BN, BK>  v_outer_acc (F2): the 8x8 register tile over K
//                          steps of BK words through a double-buffered
//                          shared-memory ring filled by cp.async.
//   chunk3d<BM, BN, KC>    v_chunk3d (F3): K in slabs of 32 words in shared
//                          memory; per step a thread takes KC consecutive
//                          words of each of its rows and columns as uint4
//                          loads and adds the chunk's popcount sum.
//   lanered<BN, STAGES>    v_lanered (F4): the dot form, x (M, Kw) against
//                          wt (N, Kw), both K-major, on the single-bit tensor
//                          cores: B's mainloop (popcount_gemm.cuh) with both
//                          tiles filled by TMA boxes into a ring of STAGES,
//                          BN columns a block; no word transpose.
//   multiacc<NACC>         experiments/xnor_sol_variants.py:xnor_multiacc
//                          (G): B's mainloop on B's N-major weights with NACC
//                          accumulator fragment sets, K step i into set
//                          i % NACC, NACC independent wgmma groups in flight;
//                          NACC = 1 is B's schedule.
//
// F1-F3 stay on the CUDA cores, bound by popc issue, one popc per 32 MACs,
// at 16 popc per clock per SM (compute capability 9.0); xor and add issue
// beside it.  They differ in what feeds the popc unit: shared-memory loads
// per popc (outer: 2 per 8x8 = 64 popc per word step; chunk3d: 2 uint4 per
// 16 KC popc) and the occupancy their shared memory and registers leave.
// Pad bits are 0 in both operands, so they XOR to 0; words past Kw, rows
// past M and columns past N stage as 0 and are never stored.  F4 and G run
// the AND-popcount wgmma at B's rate; their least time is B's, bound by
// the int32 output's bytes (0.0058 ms at 1024 x 4096 x 4096).  F4 measures
// what B's transposing weight copies cost and what a TMA-fed mainloop
// gives; G whether independent wgmma groups shorten B's step chain.
#include <cuda_runtime.h>

#include "popcount_gemm.cuh"

namespace {

constexpr int kTile = 8;               // rows and columns of a thread's register tile
constexpr int kSide = 16;              // threads along each side of a sub-tile
constexpr int kThreads = kSide * kSide;
constexpr int kSub = kSide * kTile;    // 128: the sub-tile 256 threads cover
constexpr int kSlab = 32;              // chunk3d: words of K per shared-memory slab
constexpr int kSlabStride = kSlab + 4; // keeps rows 16-byte aligned, spreads banks
constexpr size_t kMaxSmem = 232448;    // 227 KiB, what one block may opt in to
constexpr int kMaxGridY = 65535;

// The row blocks of a tiled kernel go in grid.y, which holds at most 65535.
inline bool rows_fit(int m, int bm) { return (m + bm - 1) / bm <= kMaxGridY; }

// ---------------------------------------------------------------- F1 outer

// grid (ceil(n / BN), ceil(m / BM)), kThreads threads, dynamic shared memory
// BM * (kw | 1) + kw * BN words.  x rows are kept at an odd stride so the two
// rows a warp reads at once fall in different banks.
template <int BM, int BN>
__global__ void __launch_bounds__(kThreads)
outer_kernel(const unsigned* __restrict__ xp, const unsigned* __restrict__ wp,
             int* __restrict__ out, int m, int kw, int n, int k) {
  extern __shared__ unsigned smem[];
  const int xs_stride = kw | 1;
  unsigned* xs = smem;                                          // [BM][xs_stride]
  unsigned* ws = smem + static_cast<size_t>(BM) * xs_stride;    // [kw][BN]
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  for (int i = tid; i < BM * kw; i += kThreads) {
    const int r = i / kw, c = i - r * kw;
    xs[r * xs_stride + c] =
        m0 + r < m ? __ldg(xp + static_cast<size_t>(m0 + r) * kw + c) : 0u;
  }
  for (int i = tid; i < kw * BN; i += kThreads) {
    const int r = i / BN, c = i % BN;
    ws[i] = n0 + c < n ? __ldg(wp + static_cast<size_t>(r) * n + n0 + c) : 0u;
  }
  __syncthreads();

  const int tx = tid % kSide, ty = tid / kSide;
  for (int sm = 0; sm < BM && m0 + sm < m; sm += kSub) {
    for (int sn = 0; sn < BN && n0 + sn < n; sn += kSub) {
      int acc[kTile][kTile] = {};
      const unsigned* xr = xs + (sm + ty) * xs_stride;
      const unsigned* wr = ws + sn + tx;
#pragma unroll 2
      for (int c = 0; c < kw; ++c) {
        unsigned a[kTile], b[kTile];
#pragma unroll
        for (int i = 0; i < kTile; ++i) a[i] = xr[i * kSide * xs_stride + c];
#pragma unroll
        for (int j = 0; j < kTile; ++j) b[j] = wr[c * BN + j * kSide];
#pragma unroll
        for (int i = 0; i < kTile; ++i)
#pragma unroll
          for (int j = 0; j < kTile; ++j) acc[i][j] += __popc(a[i] ^ b[j]);
      }
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        const int row = m0 + sm + ty + i * kSide;
        if (row >= m) break;
#pragma unroll
        for (int j = 0; j < kTile; ++j) {
          const int col = n0 + sn + tx + j * kSide;
          if (col < n) out[static_cast<size_t>(row) * n + col] = k - 2 * acc[i][j];
        }
      }
    }
  }
}

template <int BM, int BN>
cudaError_t launch_outer(const unsigned* xp, const unsigned* wp, int* out, int m,
                         int kw, int n, int k, cudaStream_t stream) {
  const size_t smem =
      sizeof(unsigned) * (static_cast<size_t>(BM) * (kw | 1) + static_cast<size_t>(kw) * BN);
  if (smem > kMaxSmem || !rows_fit(m, BM)) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      outer_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  outer_kernel<BM, BN><<<dim3((n + BN - 1) / BN, (m + BM - 1) / BM), kThreads, smem,
                         stream>>>(xp, wp, out, m, kw, n, k);
  return cudaGetLastError();
}

// ------------------------------------------------------------ F2 outer_acc

__device__ __forceinline__ void cp_async4(unsigned* dst, const unsigned* src,
                                          bool ok) {
  // 4-byte copy, or 4 zero bytes (source size 0) past the operand's edge
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// grid (ceil(n / BN), ceil(m / BM)), (BM / 8) * (BN / 8) threads.  Each ring
// stage holds x transposed, [BK][BM + 1] (the + 1 keeps the transposing
// stores conflict-free), and w as [BK][BN].  Copies are 4 bytes wide, so any
// Kw and N are allowed.
template <int BM, int BN, int BK>
__global__ void __launch_bounds__((BM / kTile) * (BN / kTile))
outer_acc_kernel(const unsigned* __restrict__ xp, const unsigned* __restrict__ wp,
                 int* __restrict__ out, int m, int kw, int n, int k) {
  constexpr int kTx = BN / kTile, kTy = BM / kTile, kNt = kTx * kTy;
  constexpr int kXs = BK * (BM + 1), kWs = BK * BN;
  __shared__ unsigned xs[2][kXs];
  __shared__ unsigned ws[2][kWs];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, tx = tid % kTx, ty = tid / kTx;

  auto load = [&](int stage, int kw0) {
    for (int i = tid; i < BM * BK; i += kNt) {
      const int r = i / BK, kk = i % BK;
      const bool ok = m0 + r < m && kw0 + kk < kw;
      cp_async4(&xs[stage][kk * (BM + 1) + r],
                ok ? xp + static_cast<size_t>(m0 + r) * kw + kw0 + kk : xp, ok);
    }
    for (int i = tid; i < BK * BN; i += kNt) {
      const int kk = i / BN, c = i % BN;
      const bool ok = kw0 + kk < kw && n0 + c < n;
      cp_async4(&ws[stage][i],
                ok ? wp + static_cast<size_t>(kw0 + kk) * n + n0 + c : wp, ok);
    }
    cp_async_commit();
  };

  int acc[kTile][kTile] = {};
  const int steps = (kw + BK - 1) / BK;
  load(0, 0);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      load((s + 1) & 1, (s + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned* xb = xs[s & 1] + ty;
    const unsigned* wb = ws[s & 1] + tx;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      unsigned a[kTile], b[kTile];
#pragma unroll
      for (int i = 0; i < kTile; ++i) a[i] = xb[kk * (BM + 1) + i * kTy];
#pragma unroll
      for (int j = 0; j < kTile; ++j) b[j] = wb[kk * BN + j * kTx];
#pragma unroll
      for (int i = 0; i < kTile; ++i)
#pragma unroll
        for (int j = 0; j < kTile; ++j) acc[i][j] += __popc(a[i] ^ b[j]);
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }
#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    const int row = m0 + ty + i * kTy;
    if (row >= m) break;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const int col = n0 + tx + j * kTx;
      if (col < n) out[static_cast<size_t>(row) * n + col] = k - 2 * acc[i][j];
    }
  }
}

template <int BM, int BN, int BK>
cudaError_t launch_outer_acc(const unsigned* xp, const unsigned* wp, int* out,
                             int m, int kw, int n, int k, cudaStream_t stream) {
  if (!rows_fit(m, BM)) return cudaErrorInvalidValue;
  outer_acc_kernel<BM, BN, BK>
      <<<dim3((n + BN - 1) / BN, (m + BM - 1) / BM), (BM / kTile) * (BN / kTile), 0,
         stream>>>(xp, wp, out, m, kw, n, k);
  return cudaGetLastError();
}

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

int qnx_gemm_outer(const void* xp, const void* wp, void* out, int m, int kw, int n,
                   int k, int bm, int bn, void* stream) {
  if (bm == 128 && bn == 128) return launch_outer<128, 128>(QNX_ARGS);
  if (bm == 256 && bn == 128) return launch_outer<256, 128>(QNX_ARGS);
  if (bm == 256 && bn == 256) return launch_outer<256, 256>(QNX_ARGS);
  if (bm == 512 && bn == 256) return launch_outer<512, 256>(QNX_ARGS);
  if (bm == 1024 && bn == 128) return launch_outer<1024, 128>(QNX_ARGS);
  return cudaErrorInvalidValue;
}

int qnx_gemm_outer_acc(const void* xp, const void* wp, void* out, int m, int kw,
                       int n, int k, int bm, int bn, int bk, void* stream) {
  if (bm == 64 && bn == 128 && bk == 16) return launch_outer_acc<64, 128, 16>(QNX_ARGS);
  if (bm == 128 && bn == 128 && bk == 8) return launch_outer_acc<128, 128, 8>(QNX_ARGS);
  if (bm == 128 && bn == 128 && bk == 16) return launch_outer_acc<128, 128, 16>(QNX_ARGS);
  if (bm == 256 && bn == 128 && bk == 8) return launch_outer_acc<256, 128, 8>(QNX_ARGS);
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
