// Packed dense layers on the int8 tensor cores, for Hopper (sm_90a): the
// dense entries of kernel A, binary (A) and ternary (A'), and kernel D's
// bit-plane dense layer, as GEMMs whose packed operands are expanded to
// int8 on their way from global memory to the tensor cores, with the K
// split over the blocks of a thread-block cluster.
//
// Replaces the dense entries of the Pallas kernel
// qnx/kernels/xnor_conv_fused.py:_gemm_epi_kernel (:54): its binary branch
// reached through xnor_gemm_fused (:177) and its ternary branch reached
// through ternary_gemm_fused (:199); and qnx/kernels/plane_gemm.py:
// _plane_gemm_kernel (:32) looped over the planes by the JAX
// PlaneDenseTernary (qnx/nn/inference.py:368); with what the JAX layers
// leave to XLA around them (the plane sum, the thresholds and the repack):
//
//   A:  x[m,k], w[k,n] = 2 bit - 1      (s8: +-1)
//       s     = sum_k x w + (k - 32 Kw)
//             (= k - 2 popc(x ^ w): over the 32 Kw bit positions, pad bits
//              included, each adds 1 - 2 [x != w] to the +-1 product and
//              -2 [x != w] to the popcount form, whatever the pad bits hold)
//   A': x[m,k]   = 2 bit - 1            (s8)
//       w[k,n]   = mask ? (sign ? +1 : -1) : 0
//       s     = sum_k x w + (nnz - popc of mask's column)   (any nnz)
//   A, A': bit = sgn * s >= tau
//   D:  lvl[m,k] = sum_j 2^j b_j[m,k]   (u8, P <= 8 planes)
//       w[k,n]   = 2 msign - mask       (s8)
//       s     = sum_k lvl w             (one product whatever P)
//       level = sum_v [sgn * s >= tau[v]]; plane j of the output = bit j
//
// The accumulators are int32 and exact; the compares are int32 and tau is
// never negated (it may be INT32_MIN).  The words are packed LSB-first, 32
// channels a word, the pad bits of the last word 0.
//
// What bounds these layers on an H100: their popcount forms issue a POPC
// per 32 MACs (two per plane for D) on the CUDA cores, at 16 per clock per
// SM: the MNIST hidden layer (256 x 4096 x 4096) cannot run under 32 us
// that way.  On the int8 tensor cores (1,979 TOP/s dense at 700 W) its
// bound is 4.3 us, and D's planes cost one product whatever P.  The packed
// operands stay packed in HBM and L2, and the block expands them in shared
// memory (expand_operands.cuh, the convs' operand classes).
//
// The served shapes are short and wide: M is the engine's batch of 256,
// and a 128 x 128 tile gives 16 tiles for each VGG dense layer (8192 ->
// 1024, 1024 -> 1024) and 64 for each MNIST hidden layer (4096 -> 4096),
// against 132 SMs.  So the K of a tile is split over the `splits` blocks
// of one cluster (1, 2, 4 or 8: the most that keep to one block a SM and
// two K steps a block; the wrapper picks it,
// kernels/xnor_conv_fused.py:dense_splits): each block runs the
// mainloop over its share of the K steps and writes its int32 partial sums
// into its own shared memory (the tiles and the ring are free by then);
// after a cluster barrier block r sums rows r 128 / splits .. of every
// block's partials through distributed shared memory and runs the epilogue
// for them.  One launch per layer, no global workspace, counter or memset;
// integer sums are exact in any order, so the words are the same whatever
// the split.  A''s column count is folded into each block's partials over
// its own K slice, so it is summed the same way.  Measured against (PERF.md
// §6): no split; the partials pushed into the summing block instead
// (fragment stores, or one bulk copy a block onto its mbarrier); a lane's
// loads all in flight at once; a wgmma group in flight over three tile
// buffers; a 6-stage ring; the 128-byte swizzle; two blocks a SM.  None
// was faster.  The remote loads and the epilogue take about as long as the
// VGG layers' mainloop, so 1024 -> 1024 runs slower than the popcount
// kernel it replaced.
//
// Mainloop: the convs' (expand_mma_conv.cu), on plain rows.  A block of two
// warpgroups owns 128 rows x 128 channels; each warpgroup issues
// wgmma.mma_async m64n128k32 (u8 x s8 for D, s8 x s8 for A and A') on its
// 64 rows from double-buffered no-swizzle K-major tiles in shared memory.
// A K step is KW words of a row: KW = 4 (128 channels, 16-byte activation
// copies) where Kw % 4 == 0, else KW = 1.  cp.async brings the packed
// words three steps ahead into a ring; the block expands the next step's
// words while this step's wgmma run.
//
// The epilogue: a warp takes one row of the tile, a lane 4 channels (16-byte
// loads of each block's partials), and 8 lanes' nibbles OR into an output
// word of 32 channels by three shuffles.  The block's sgn, nnz and first
// kSmemTau thresholds per channel are staged in shared memory with the
// first copies (the convs' epilogue waited on L2 one threshold at a time
// until they were).
#include <cooperative_groups.h>

#include "expand_operands.cuh"

namespace {

using namespace qnx;
namespace cg = cooperative_groups;

constexpr int kBM = 128;       // rows of a tile
constexpr int kBN = 128;       // output channels of a tile
constexpr int kThreads = 256;  // two warpgroups, 64 rows each
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;     // packed-word ring
constexpr int kSmemTau = 15;   // thresholds held in shared memory (more: L1)
constexpr int kMaxSplits = 8;  // blocks of a cluster (the portable size)
// int32 words between rows of the partial sums: 8 more than a row, so the
// accumulator fragments' 8-byte stores of 8 rows x 4 lanes hit distinct banks
constexpr int kPartStride = kBN + 8;

struct DenseArgs {
  const uint32_t* x;   // (P, M, Kw) packed words (P = 1 for A, A')
  const uint32_t* w0;  // (Kw, N) mask (D, A') or sign (A)
  const uint32_t* w1;  // (Kw, N) msign (D) or sign (A'); A: unused
  const int* nnz;      // (N,)      A' only
  const int* sgn;      // (N,)
  const int* tau;      // (n_thresh, N)
  uint32_t* out;       // (P, M, Nw)
  int p, m, kw, n, n_thresh;
  int k;               // A: the true reduction length
};

// The bytes of the mainloop's tiles (double-buffered) and ring, and of the
// partial sums that take their place after it.
template <int KW, int WP>
__host__ __device__ constexpr size_t loop_bytes(int p) {
  return 2 * (kBM + kBN) * 32 * KW + sizeof(uint32_t) * kStages * (WP + p) * kBM * KW;
}

template <int KW, int WP>
__host__ __device__ constexpr size_t union_bytes(int p) {
  return loop_bytes<KW, WP>(p) > sizeof(int) * kBM * kPartStride
             ? loop_bytes<KW, WP>(p)
             : sizeof(int) * kBM * kPartStride;
}

// the union, then the column constants: count [2][kBN], cols [2 + kSmemTau][kBN]
template <int KW, int WP>
size_t smem_bytes(int p) {
  return union_bytes<KW, WP>(p) + sizeof(int) * (4 + kSmemTau) * kBN;
}

// grid (splits, ceil(n / kBN), ceil(m / kBM)) in clusters of (splits, 1, 1),
// block kThreads, dynamic shared memory smem_bytes<KW, Ops::kWPlanes>(p).
template <class Ops, int KW>
__global__ void __launch_bounds__(kThreads, 2)
expand_mma_dense_kernel(const DenseArgs a) {
  constexpr int kWP = Ops::kWPlanes;
  constexpr int kKB = 32 * KW;             // k bytes of a step
  constexpr uint32_t kSbo = 2 * KW * 128;  // bytes between 8-row groups
  extern __shared__ __align__(128) unsigned char smem[];
  // tiles [2][128 / 8 row or column groups][2 KW chunks][8][16 bytes]
  unsigned char* a8 = smem;
  unsigned char* b8 = a8 + 2 * kBM * kKB;
  uint32_t* ring_b = reinterpret_cast<uint32_t*>(b8 + 2 * kBN * kKB);
  //                                             [kStages][kWP][kBN][KW]
  uint32_t* ring_a = ring_b + kStages * kWP * kBN * KW;  // [kStages][P][kBM][KW]
  // after the mainloop: this block's partial sums [kBM][kPartStride]
  int* part = reinterpret_cast<int*>(smem);
  // the two halves of this block's count of the mask's column (A'), then
  // cols [2 + kSmemTau][kBN]: sgn, nnz (A'), the first thresholds
  int* count = reinterpret_cast<int*>(smem + union_bytes<KW, kWP>(a.p));
  int* cols = count + 2 * kBN;
  const int* col_sgn = cols;
  const int* col_nnz = cols + kBN;
  const int* col_tau = cols + 2 * kBN;

  const int tid = threadIdx.x;
  __builtin_assume(tid < kThreads);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;   // groupID
  const int t = lane & 3;    // threadID_in_group
  const int wg = warp >> 2;  // the warpgroup's 64 rows
  // this thread's accumulator rows: wrow and wrow + 8
  const int wrow = wg * 64 + (warp & 3) * 16 + g;
  const int p = a.p;
  const int splits = gridDim.x;  // the cluster: this block is its rank blockIdx.x
  const int rank = blockIdx.x;
  const int n0 = blockIdx.y * kBN;
  const int m0 = blockIdx.z * kBM;
  const size_t plane_words = static_cast<size_t>(a.m) * a.kw;

  // this block's K steps of KW words: [s_begin, s_end), every block at
  // least one where splits <= the steps
  const int steps_all = a.kw / KW;
  const int s_begin = rank * steps_all / splits;
  const int s_end = (rank + 1) * steps_all / splits;

  // this thread's activation row for the copies (a row past M reads zeros)
  const int cr = tid & (kBM - 1);
  const bool row_in = m0 + cr < a.m;
  const uint32_t* xrow = a.x + static_cast<size_t>(row_in ? m0 + cr : 0) * a.kw;

  // the next step to copy and its ring stage
  int i_step = s_begin, i_stage = 0;
  auto issue = [&]() {
    if (i_step < s_end) {
      const uint32_t* src = xrow + i_step * KW;
      for (int j = tid / kBM; j < p; j += kThreads / kBM) {
        cp_async<4 * KW>(ring_a + ((i_stage * p + j) * kBM + cr) * KW,
                         row_in ? src + j * plane_words : a.x, row_in);
      }
      const size_t krow = static_cast<size_t>(i_step) * KW;
      constexpr int kWords = kWP * kBN * KW;
#pragma unroll
      for (int i = 0; i < (kWords + kThreads - 1) / kThreads; ++i) {
        const int idx = tid + i * kThreads;  // (plane, column, word)
        if (kWords % kThreads == 0 || idx < kWords) {
          const int col = (idx % (kBN * KW)) / KW;
          const bool bv = n0 + col < a.n;
          const uint32_t* wsrc = (idx / (kBN * KW) ? a.w1 : a.w0) +
                                 (krow + idx % KW) * a.n + n0 + col;
          cp_async<4>(ring_b + i_stage * kWords + idx, bv ? wsrc : a.w0, bv);
        }
      }
      ++i_step;
      i_stage = i_stage + 1 == kStages ? 0 : i_stage + 1;
    }
    cp_async_commit();
  };

  auto expand = [&](int stage, int buf) {
    expand_tiles<Ops, KW, kBM, kBN, kThreads>(ring_a, ring_b, a8, b8, stage,
                                              buf, p, tid);
  };

  int acc[64];  // n8 tile j: channels 8j + 2t, +1 of row wrow, then wrow + 8
#pragma unroll
  for (int r = 0; r < 64; ++r) acc[r] = 0;

  issue();
  issue();
  issue();
  if constexpr (Ops::kCount) {
    // the set bits of the mask's column over this block's K slice, taken
    // from its partial sums: the MMA's sum over the mask is count - 2
    // mismatches, the popcount form's nnz - 2 mismatches.  While step 0
    // lands.
    const int col = tid & (kBN - 1);
    int bits = 0;
    if (n0 + col < a.n) {
#pragma unroll 16
      for (int k = s_begin * KW + tid / kBN; k < s_end * KW; k += kThreads / kBN) {
        bits += __popc(__ldg(a.w0 + static_cast<size_t>(k) * a.n + n0 + col));
      }
    }
    count[(tid / kBN) * kBN + col] = bits;
  }
  const int smem_tau = a.n_thresh <= kSmemTau ? a.n_thresh : 0;
  for (int i = tid; i < (2 + smem_tau) * kBN; i += kThreads) {
    const int col = n0 + i % kBN;
    const int what = i / kBN;  // sgn, nnz, then the thresholds
    int v = 0;
    if (col < a.n) {
      if (what == 0) {
        v = __ldg(a.sgn + col);
      } else if (what >= 2) {
        v = __ldg(a.tau + static_cast<size_t>(what - 2) * a.n + col);
      } else if constexpr (Ops::kCount) {
        v = __ldg(a.nnz + col);
      }
    }
    cols[i] = v;
  }
  cp_async_wait<1>();
  __syncthreads();
  if (s_begin < s_end) expand(0, 0);

  int stage = 0;  // the ring stage that step's expansion read
  for (int step = s_begin; step < s_end; ++step) {
    const int buf = (step - s_begin) & 1;
    cp_async_wait<1>();  // this thread's copies of step + 1 have landed
    // every thread's copies of step + 1 and tiles of step are visible,
    // and step - 1's wgmma are done with the other buffers
    __syncthreads();
    issue();  // step + 3, into the stage that step's expansion read
    const unsigned char* ta = a8 + buf * kBM * kKB + wg * 8 * kSbo;
    const unsigned char* tb = b8 + buf * kBN * kKB;
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < KW; ++kc) {
      wgmma_k32<Ops::kU8>(acc, tile_desc(ta + kc * 256, kSbo),
                          tile_desc(tb + kc * 256, kSbo));
    }
    wgmma_commit();
    stage = stage + 1 == kStages ? 0 : stage + 1;
    if (step + 1 < s_end) expand(stage, buf ^ 1);  // while they run
    wgmma_wait<0>();
#pragma unroll
    for (int r = 0; r < 64; ++r) hold(acc[r]);
  }

  // this block's partial sums into the union, once every warp is done with
  // the tiles and the ring; A': less this block's count of the mask's column
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + 2 * t;
    int2 sub = make_int2(0, 0);
    if constexpr (Ops::kCount) {
      sub = make_int2(count[c] + count[kBN + c], count[c + 1] + count[kBN + c + 1]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // one 8-byte store
      *reinterpret_cast<int2*>(part + (wrow + 8 * r) * kPartStride + c) =
          make_int2(acc[4 * j + 2 * r] - sub.x, acc[4 * j + 2 * r + 1] - sub.y);
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  if (splits > 1) {
    cluster.sync();  // every block's partials are written and visible
  } else {
    __syncthreads();
  }

  // epilogue: this block's rows r 128 / splits .. of the tile, a warp a row,
  // a lane 4 channels, summed over the blocks' partials (distributed shared
  // memory, 16 bytes a load); each output word is the OR of 8 lanes'
  // nibbles.  A: s += k - 32 Kw (the pad bits' +-1 products, whatever they
  // hold); A': s += nnz
  const int binary_const = a.k - 32 * a.kw;
  const int nw = (a.n + 31) / 32;
  const size_t out_plane = static_cast<size_t>(a.m) * nw;
  const int rows = kBM / splits;
  const int c = 4 * lane;  // the tile's channels c .. c + 3
  const int col = n0 + c;
  // threshold v of channel col + e at tau[v * tau_stride + e]
  const int* tau = smem_tau ? col_tau + c : a.tau + col;
  const int tau_stride = smem_tau ? kBN : a.n;
  const int4 sg = *reinterpret_cast<const int4*>(col_sgn + c);
  int4 add = make_int4(binary_const, binary_const, binary_const, binary_const);
  if constexpr (Ops::kCount) add = *reinterpret_cast<const int4*>(col_nnz + c);
  if constexpr (!Ops::kCorr) add = make_int4(0, 0, 0, 0);
  for (int lr = warp; lr < rows; lr += kWarps) {
    const int r = rank * rows + lr;  // the tile's row
    const int m = m0 + r;
    if (m >= a.m) break;  // uniform across the warp, and so are later rows
    int4 s = add;
#pragma unroll
    for (int b = 0; b < kMaxSplits; ++b) {  // every load in flight
      if (b < splits) {
        const int* src = splits > 1 ? cluster.map_shared_rank(part, b) : part;
        const int4 v = *reinterpret_cast<const int4*>(src + r * kPartStride + c);
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
    }
    const int u[4] = {sg.x * s.x, sg.y * s.y, sg.z * s.z, sg.w * s.w};
    int code[4] = {0, 0, 0, 0};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (col + e < a.n) {
        for (int v = 0; v < a.n_thresh; ++v) {
          code[e] += u[e] >= tau[static_cast<size_t>(v) * tau_stride + e];
        }
      }
    }
    const size_t at = static_cast<size_t>(m) * nw + (n0 >> 5) + (lane >> 3);
    for (int plane = 0; plane < p; ++plane) {
      uint32_t word = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) word |= static_cast<uint32_t>((code[e] >> plane) & 1) << e;
      word <<= 4 * (lane & 7);
      word |= __shfl_xor_sync(kFull, word, 1);
      word |= __shfl_xor_sync(kFull, word, 2);
      word |= __shfl_xor_sync(kFull, word, 4);
      if ((lane & 7) == 0 && col < a.n) a.out[plane * out_plane + at] = word;
    }
  }
  // no block leaves while another still reads its partials
  if (splits > 1) cluster.sync();
}

template <class Ops, int KW>
int launch(const DenseArgs& a, int splits, cudaStream_t stream) {
  auto kernel = expand_mma_dense_kernel<Ops, KW>;
  // once per instance: room for the most planes, and the SM's shared memory
  // split towards shared
  static const cudaError_t configured = [&] {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<KW, Ops::kWPlanes>(kMaxPlanes)));
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    }
    return e;
  }();
  if (configured != cudaSuccess) return static_cast<int>(configured);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(splits),
                     static_cast<unsigned>((a.n + kBN - 1) / kBN),
                     static_cast<unsigned>((a.m + kBM - 1) / kBM));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes<KW, Ops::kWPlanes>(a.p);
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = static_cast<unsigned>(splits);
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

// KW = 4 words a step where the 16-byte activation copies are aligned.
// splits: 1, 2, 4 or 8 blocks a tile, at most the K steps (any splits <=
// the steps runs every block's share; one more than the steps would leave
// a block none, which is also right).
template <class Ops>
int dispatch(const DenseArgs& a, int splits, void* stream) {
  if (splits < 1 || splits > kMaxSplits || (splits & (splits - 1)) ||
      (a.m + kBM - 1) / kBM > 65535 || (a.n + kBN - 1) / kBN > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (a.kw % 4 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0) {
    return launch<Ops, 4>(a, splits, s);
  }
  return launch<Ops, 1>(a, splits, s);
}

}  // namespace

extern "C" {

// Plain C entry points, bound with ctypes by qnx_torch/kernels/_build.py.
// Each launches on the given stream, does not synchronise, and returns
// cudaGetLastError() so a refused launch is reported at once.

// Kernel A's binary dense: bits (M, Kw), sign words (Kw, N), sgn and tau
// (N,), k -> words (M, ceil(N/32)).
int qnx_xnor_dense_fused(const void* xp, const void* wp, const void* sgn,
                         const void* tau, void* out, int m, int kw, int n,
                         int k, int splits, void* stream) {
  const DenseArgs a{static_cast<const uint32_t*>(xp), static_cast<const uint32_t*>(wp),
                    nullptr, nullptr, static_cast<const int*>(sgn),
                    static_cast<const int*>(tau), static_cast<uint32_t*>(out), 1, m,
                    kw, n, 1, k};
  return dispatch<BinaryOperands>(a, splits, stream);
}

// Kernel A's ternary dense: bits (M, Kw), mask / sign (Kw, N), nnz, sgn and
// tau (N,) -> words (M, ceil(N/32)).
int qnx_ternary_dense_fused(const void* xp, const void* mask, const void* sign,
                            const void* nnz, const void* sgn, const void* tau,
                            void* out, int m, int kw, int n, int splits,
                            void* stream) {
  const DenseArgs a{static_cast<const uint32_t*>(xp), static_cast<const uint32_t*>(mask),
                    static_cast<const uint32_t*>(sign), static_cast<const int*>(nnz),
                    static_cast<const int*>(sgn), static_cast<const int*>(tau),
                    static_cast<uint32_t*>(out), 1, m, kw, n, 1, 0};
  return dispatch<TernaryOperands>(a, splits, stream);
}

// Kernel D's dense: planes (P, M, Kw), mask / msign (Kw, N), sgn (N,), tau
// (n_thresh, N) -> planes (P, M, ceil(N/32)).
int qnx_plane_dense_fused(const void* xp, const void* mask, const void* msign,
                          const void* sgn, const void* tau, void* out, int p,
                          int m, int kw, int n, int n_thresh, int splits,
                          void* stream) {
  const DenseArgs a{static_cast<const uint32_t*>(xp), static_cast<const uint32_t*>(mask),
                    static_cast<const uint32_t*>(msign), nullptr,
                    static_cast<const int*>(sgn), static_cast<const int*>(tau),
                    static_cast<uint32_t*>(out), p, m, kw, n, n_thresh, 0};
  // the served paths' one and two planes get an unrolled expander
  if (p == 1) return dispatch<PlaneOperands<1>>(a, splits, stream);
  if (p == 2) return dispatch<PlaneOperands<2>>(a, splits, stream);
  return dispatch<PlaneOperands<0>>(a, splits, stream);
}

const char* qnx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
