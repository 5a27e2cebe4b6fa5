// Packed 3x3 convs on the int8 tensor cores, for Hopper (sm_90a): kernel D's
// bit-plane conv and kernel A's conv, binary (A) and ternary (A'), all as
// implicit GEMMs whose packed operands are expanded to int8 on their way
// from global memory to the tensor cores.
//
// Replaces the Pallas kernels qnx/kernels/plane_gemm.py:_plane_gemm_kernel
// (:32, looped over the planes by plane_conv :90) and
// qnx/kernels/xnor_conv_fused.py:_gemm_epi_kernel (:54): its binary branch
// reached through xnor_conv_fused (:283) and its ternary branch reached
// through ternary_conv_fused (:316); with what the JAX layers leave to XLA
// around them (the patch gather, the plane sum, the 2x2 pool, the
// thresholds and the repack):
//
//   D:  lvl[m,k] = sum_j 2^j b_j[m,k]   (u8, P <= 8 planes)
//       w[k,n]   = 2 msign - mask       (s8: -1, 0, +1; 2 where msign is
//                                        outside mask, as the popcount form)
//       s        = sum_k lvl w          (= sum_j 2^j (2 popc(b_j & msign)
//                                                     - popc(b_j & mask)))
//       s        = s + corr[y,x,n]      (quantized_tanh's unsigned indices:
//                                        the border term; none for relu)
//       s        = max of s over the 2x2 window               (pool)
//       level    = sum_v [sgn * s >= tau[v]]; plane j of the output = bit j
//   A:  x[m,k]   = 2 bit - 1            (s8: +-1; a pad tap reads the zero
//                                        word, -1, as the JAX patches do)
//       w[k,n]   = 2 bit - 1            (s8: +-1, one weight plane)
//       s        = sum_k x w + (k - 288 Cw) + corr[y,x,n]
//                (= k - 2 popc(x ^ w) + corr: over the 32 9 Cw bit positions,
//                 pad bits included, each adds 1 - 2 [x != w] to the +-1
//                 product and -2 [x != w] to the popcount form, whatever
//                 the pad bits hold)
//   A': x[m,k]   = 2 bit - 1            (as A)
//       w[k,n]   = mask ? (sign ? +1 : -1) : 0              (s8)
//       s        = sum_k x w + (nnz - popc of mask's column) + corr[y,x,n]
//                (= nnz - 2 popc(mask & (x ^ sign)) + corr, for any nnz)
//   A, A': s     = max of s over the 2x2 window               (pool)
//       bit      = sgn * s >= tau
//   A residual (Bi-Real Net's binary conv, BinaryResidualOperands<S>):
//       s        = A's s at stride S (1 or 2: output pixel (y, x) reads
//                  input (S y - 1 + dy, S x - 1 + dx)), corr at the
//                  output grid; no pool
//       x_new    = (float(s) * scale[n] + shift[n]) + r[y,x,n]   (float32,
//                  each product and sum rounded once, no contraction)
//       out      = x_new (float32 NHWC) and bit = x_new >= 0
//
// The accumulator is int32 and exact: |s| <= 9 C 255 * 2.  The compares
// are int32 and tau is never negated (it may be INT32_MIN).
//
// Why the tensor cores: the popcount forms issue an AND (and an XOR) and a
// POPC per 32 MACs per plane on the CUDA cores, and POPC issues at 16 per
// clock per SM on an H100 (15.84 measured by vpu_probe): the five VGG convs
// at batch 256, 1.546e11 MACs, cannot run under 1.17 ms that way, and D
// pays that once per plane.  Here the planes and the weight planes become
// int8 MMA operands, so every MAC is one tensor-core MAC whatever P is, and
// the bound is the int8 rate, 1,979 TOP/s dense at 700 W (0.156 ms for the
// five convs).  The packed operands stay packed in HBM and L2, 8x fewer
// bytes from L2 per MAC than kernel E's int8 codes; the expansion costs
// ALU work per block-step instead (below).
//
// Design: rows (M) are output pixels in quad-major order (wgmma_conv.cuh's
// pixel_of), so the 2x2 pool is two __shfl_xor_sync; columns (N) are output
// channels; K = 9 C, tap-major like the (9 Cw, N) weight words.  A block of
// two warpgroups owns 128 rows x 128 channels; each warpgroup issues
// wgmma.mma_async m64n128k32 (u8 x s8 for D, s8 x s8 for A and A') on its
// 64 rows, both operands from shared memory.  A K step is KW words of one
// tap: KW = 4 (128 channels, 16-byte activation copies) where Cw % 4 == 0,
// else KW = 1.  Per step:
//   - cp.async brings the packed words three steps ahead into a ring of
//     kStages stages (zero-filled outside the image, past the rows and
//     past N; the weights' 128 columns of one word are contiguous, so the
//     copies coalesce; A copies one weight plane, D and A' two);
//   - the wgmma of this step run on its int8 tiles while the block expands
//     the next step's words, each once, into the other buffer of the
//     double-buffered A and B tiles (expand_operands.cuh: the operand
//     classes and expand_tiles, shared with the dense kernel);
//   - the warps wait for their wgmma, then one __syncthreads.
//
// The epilogue is latency: a block's two rows a thread wait on its loads
// while the tensor cores idle.  So the block's sgn, nnz and first
// kSmemTau thresholds per channel are staged in shared memory with the
// first copies, and a row's corr (A, A') is loaded in one batch; with the
// loads in the epilogue, it took about half the kernel's time.
//
// Measured against two other designs (PERF.md §6): mma.sync m16n8k32
// from swizzled tiles through ldmatrix, and wgmma with A in registers,
// each warp expanding its own rows straight into its fragments (that puts
// the expansion between the barrier and the wgmma, and spills at KW = 4).
//
// The residual conv (Bi-Real Net's binary conv; no TPU kernel, the JAX
// package has no residual model) is A's mainloop with two options of its
// Operands class, BinaryResidualOperands<S>: the stride S, which moves each
// row's taps to (S y - 1 + dy, S x - 1 + dx) and sets the output grid
// (ceil(H / S) x ceil(W / S), the quads and corr at that grid), and the
// epilogue, which stages scale and shift in place of sgn and nnz, reads
// the float32 residual two channels a float2 and writes x_new and its
// bits.  Its single-bit MACs are far under its bytes (the float32 stream
// read and written, 8 B an output channel against 9 C / 8 B of products),
// so it is bound by HBM; Stage 1's N = 64 runs half of the 128-channel
// tile (PERF.md §6).
//
// The mainloop takes its operands from an Operands class (the expanders
// and what the epilogue adds); kernel E, whose int8 codes need no
// expansion, has a mainloop of its own on the same helpers
// (i8_conv_fused.cu).
#include "expand_operands.cuh"

namespace {

using namespace qnx;

constexpr int kBM = 128;       // output pixels of a block (32 windows)
constexpr int kBN = 128;       // output channels of a block
constexpr int kThreads = 256;  // two warpgroups, 64 rows each
constexpr int kStages = 3;     // packed-word ring
constexpr int kSmemTau = 15;   // thresholds held in shared memory (more: L1)

struct ConvArgs {
  const uint32_t* x;   // (P, B, H, W, Cw) packed words (P = 1 for A, A')
  const uint32_t* w0;  // (9 Cw, N) mask (D, A') or sign (A)
  const uint32_t* w1;  // (9 Cw, N) msign (D) or sign (A'); A: unused
  const int* nnz;      // (N,)      A' only
  const int* corr;     // (H', W', N) at the output grid: A, A', D's tanh mode
  const int* sgn;      // (N,)
  const int* tau;      // (n_thresh, N)
  uint32_t* out;       // (P, B, H', W', Nw)
  int p, b, h, w, cw, n, n_thresh, pool;
  int k;               // A: the true reduction length 9 C
};

// The residual conv's arguments: ConvArgs (sgn, tau, nnz and w1 unused) and
// its float32 operands.  Only its instances take them, so ConvArgs, and
// with it the code of every other instance, stays as it was: fields
// appended to ConvArgs changed the SASS of them all (PERF.md §6).
struct ResidualArgs : ConvArgs {
  const float* scale;  // (N,)
  const float* shift;  // (N,)
  const float* res;    // (B, H', W', N) the residual r
  float* out_f;        // (B, H', W', N) x_new
};

// The arguments the instances of an Operands class take.
template <class Ops>
struct ArgsOf {
  using type = ConvArgs;
};
template <int S>
struct ArgsOf<BinaryResidualOperands<S>> {
  using type = ResidualArgs;
};
template <class Ops>
using ArgsFor = typename ArgsOf<Ops>::type;

// The output grid's extent of a 3x3 conv with pad 1 at stride s.
__host__ __device__ __forceinline__ int conv_out(int extent, int s) {
  return (extent + s - 1) / s;
}

// tiles (double-buffered), ring, column constants
template <int KW, int WP>
size_t smem_bytes(int p) {
  return 2 * (kBM + kBN) * 32 * KW +
         sizeof(uint32_t) * kStages * (WP + p) * kBM * KW +
         sizeof(int) * (4 + kSmemTau) * kBN;
}

// grid (ceil(4 b qh qw / kBM), ceil(n / kBN)), block kThreads, dynamic
// shared memory smem_bytes<KW, Ops::kWPlanes>(p).
template <class Ops, int KW>
__global__ void __launch_bounds__(kThreads, 2)
expand_mma_conv3x3_kernel(const ArgsFor<Ops> a) {
  constexpr int kWP = Ops::kWPlanes;
  constexpr int kKB = 32 * KW;            // k bytes of a step
  constexpr uint32_t kSbo = 2 * KW * 128;  // bytes between 8-row groups
  extern __shared__ __align__(128) unsigned char smem[];
  // tiles [2][128 / 8 row or column groups][2 KW chunks][8][16 bytes]
  unsigned char* a8 = smem;
  unsigned char* b8 = a8 + 2 * kBM * kKB;
  uint32_t* ring_b = reinterpret_cast<uint32_t*>(b8 + 2 * kBN * kKB);
  //                                             [kStages][kWP][kBN][KW]
  uint32_t* ring_a = ring_b + kStages * kWP * kBN * KW;  // [kStages][P][kBM][KW]
  // the block's column constants: the two halves of the mask's count (A'),
  // then cols [2 + kSmemTau][kBN]: sgn, nnz (A'), the first thresholds
  int* count = reinterpret_cast<int*>(ring_a + kStages * a.p * kBM * KW);
  int* cols = count + 2 * kBN;
  const int* col_sgn = cols;
  const int* col_nnz = cols + kBN;
  const int* col_tau = cols + 2 * kBN;

  const int tid = threadIdx.x;
  __builtin_assume(tid < kThreads);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // groupID
  const int t = lane & 3;   // threadID_in_group
  const int wg = warp >> 2;  // the warpgroup's 64 rows
  // this thread's accumulator rows: wrow and wrow + 8
  const int wrow = wg * 64 + (warp & 3) * 16 + g;
  const int p = a.p;
  constexpr int kS = Ops::kStride;
  const int ho_s = conv_out(a.h, kS);  // the conv's output grid, before the pool
  const int wo_s = conv_out(a.w, kS);
  const int qh = windows(ho_s, a.pool);
  const int qw = windows(wo_s, a.pool);
  const int rows = 4 * a.b * qh * qw;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const size_t plane_words = static_cast<size_t>(a.b) * a.h * a.w * a.cw;

  // this thread's activation row for the copies (a row outside the image
  // or past the rows reads zeros): the input pixel at the centre of its
  // taps, and its first word in plane 0
  const int cr = tid & (kBM - 1);
  int cy = -4, cx = -4;
  const uint32_t* xrow = a.x;
  if (m0 + cr < rows) {
    const Pixel px = pixel_of(m0 + cr, qh, qw);
    if (px.y < ho_s && px.x < wo_s) {
      cy = kS * px.y;
      cx = kS * px.x;
      xrow += (static_cast<size_t>(px.bi * a.h + cy) * a.w + cx) * a.cw;
    }
  }

  const int steps = 9 * (a.cw / KW);
  // the next step to copy: its tap, its first word in the tap, its stage;
  // K step s covers weight rows s * KW .. s * KW + KW - 1
  int i_step = 0, i_tap = 0, i_c0 = 0, i_stage = 0;
  auto issue = [&]() {
    if (i_step < steps) {
      const int dy = i_tap / 3 - 1;
      const int dx = i_tap - 3 * (dy + 1) - 1;
      const int iy = cy + dy;
      const int ix = cx + dx;
      const bool av = iy >= 0 && iy < a.h && ix >= 0 && ix < a.w;
      const uint32_t* src = xrow + (dy * a.w + dx) * a.cw + i_c0;
      for (int j = tid / kBM; j < p; j += kThreads / kBM) {
        cp_async<4 * KW>(ring_a + ((i_stage * p + j) * kBM + cr) * KW,
                         av ? src + j * plane_words : a.x, av);
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
      i_c0 += KW;
      if (i_c0 == a.cw) {
        i_c0 = 0;
        ++i_tap;
      }
    }
    cp_async_commit();
  };

  // the tiles of the step in stage into buffer buf
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
    // nnz - (set bits of mask's column), added to s in the epilogue: the
    // MMA's sum over the mask is count - 2 mismatches, the popcount form's
    // is nnz - 2 mismatches.  Outside the K loop, while step 0 lands.
    const int col = tid & (kBN - 1);
    int bits = 0;
    if (n0 + col < a.n) {
#pragma unroll 8
      for (int k = tid / kBN; k < 9 * a.cw; k += kThreads / kBN) {
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
      if constexpr (Ops::kResidual) {  // scale, then shift, as their bits
        v = __float_as_int(__ldg((what ? a.shift : a.scale) + col));
      } else if (what == 0) {
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
  expand(0, 0);

  int stage = 0;  // the ring stage that step's expansion read
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<1>();  // this thread's copies of step + 1 have landed
    // every thread's copies of step + 1 and tiles of step are visible,
    // and step - 1's wgmma are done with the other buffers
    __syncthreads();
    issue();  // step + 3, into the stage that step's expansion read
    const unsigned char* ta = a8 + (step & 1) * kBM * kKB + wg * 8 * kSbo;
    const unsigned char* tb = b8 + (step & 1) * kBN * kKB;
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < KW; ++kc) {
      wgmma_k32<Ops::kU8>(acc, tile_desc(ta + kc * 256, kSbo),
                          tile_desc(tb + kc * 256, kSbo));
    }
    wgmma_commit();
    stage = stage + 1 == kStages ? 0 : stage + 1;
    if (step + 1 < steps) expand(stage, (step + 1) & 1);  // while they run
    wgmma_wait<0>();
#pragma unroll
    for (int r = 0; r < 64; ++r) hold(acc[r]);
  }

  // epilogue: each of this thread's two rows, one output word (32
  // channels) at a time.  A: s += k - 288 Cw (the pad bits' +-1 products,
  // whatever they hold) + corr
  const int binary_const = a.k - 288 * a.cw;
  const int nw = (a.n + 31) / 32;
  const int ho = a.pool ? qh : ho_s;
  const int wo = a.pool ? qw : wo_s;
  const size_t out_plane = static_cast<size_t>(a.b) * ho * wo * nw;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + wrow + 8 * r;
    const bool in_rows = m < rows;
    Pixel px{};
    if (in_rows) px = pixel_of(m, qh, qw);
    const bool in_img = in_rows && px.y < ho_s && px.x < wo_s;
    const bool out = a.pool ? in_rows && (g & 3) == 0 : in_img;
    size_t pos = 0;
    if (out) {
      pos = a.pool ? (static_cast<size_t>(px.bi) * qh + px.qy) * qw + px.qx
                   : (static_cast<size_t>(px.bi) * ho_s + px.y) * wo_s + px.x;
    }
    // the border term: the row's corr over the block's channels, all loads
    // in flight
    int corr[4][4][2] = {};
    if constexpr (Ops::kBorder) {
      const int* row_corr = a.corr + (static_cast<size_t>(px.y) * wo_s + px.x) * a.n;
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = n0 + 32 * q + ni * 8 + 2 * t + j;
            if (in_img && col < a.n) corr[q][ni][j] = __ldg(row_corr + col);
          }
    }
    // threshold v of channel col at tau[v * tau_stride + col - tau_col0]
    const int* tau = smem_tau ? col_tau : a.tau;
    const int tau_stride = smem_tau ? kBN : a.n;
    const int tau_col0 = smem_tau ? n0 : 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // output word q of the block's 128 channels
      const int col0 = n0 + 32 * q;
      if (col0 >= a.n) break;  // uniform: no channel of this word is real
      // s[ni][j]: channel col0 + 8 ni + 2t + j; u = sgn * s; code: the level
      // (D) or bit (A, A') of each of this thread's 8 channels.  The
      // residual conv (every channel real: N % 32 == 0): r and x_new of
      // those channels, two a float2
      int u[4][2], code[4][2];
      float2 res[4], val[4];
      const size_t at_f = pos * a.n + col0 + 2 * t;
      if constexpr (Ops::kResidual) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          res[ni] = out ? __ldg(reinterpret_cast<const float2*>(a.res + at_f + ni * 8))
                        : make_float2(0.f, 0.f);
        }
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = 32 * q + ni * 8 + 2 * t + j;  // the block's channel
          int s = acc[(4 * q + ni) * 4 + 2 * r + j];
          if (in_img && n0 + c < a.n) {  // each pixel's, before the pool
            if constexpr (Ops::kBorder) s += corr[q][ni][j];
            if constexpr (Ops::kCorr) {
              s += Ops::kCount ? col_nnz[c] - count[c] - count[kBN + c]
                               : binary_const;
            }
          }
          if (a.pool) {  // the window's four rows are lanes g, g^1, g^2, g^3
            s = max(s, __shfl_xor_sync(kFull, s, 4));
            s = max(s, __shfl_xor_sync(kFull, s, 8));
          }
          if constexpr (Ops::kResidual) {
            const float* fold = reinterpret_cast<const float*>(cols);
            const float v = __fadd_rn(
                __fadd_rn(__fmul_rn(static_cast<float>(s), fold[c]), fold[kBN + c]),
                j ? res[ni].y : res[ni].x);
            (j ? val[ni].y : val[ni].x) = v;
            code[ni][j] = v >= 0.f;
          } else {
            u[ni][j] = col_sgn[c] * s;
            code[ni][j] = 0;
          }
        }
      }
      if constexpr (Ops::kResidual) {
        if (out) {
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            *reinterpret_cast<float2*>(a.out_f + at_f + ni * 8) = val[ni];
          }
        }
      } else if (out) {
        for (int v = 0; v < a.n_thresh; ++v) {  // 8 loads in flight a level
          const int* tau_v = tau + static_cast<size_t>(v) * tau_stride - tau_col0;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int col = col0 + ni * 8 + 2 * t + j;
              if (col < a.n) code[ni][j] += u[ni][j] >= tau_v[col];
            }
          }
        }
      }
      // bit j of the codes packed over the 32 channels: each lane holds 8
      // of them, the 4 lanes of a group OR theirs together
      const size_t at = pos * nw + col0 / 32;
      for (int plane = 0; plane < p; ++plane) {
        uint32_t word = 0;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            word |= static_cast<uint32_t>((code[ni][j] >> plane) & 1)
                    << (ni * 8 + 2 * t + j);
          }
        }
        word |= __shfl_xor_sync(kFull, word, 1);
        word |= __shfl_xor_sync(kFull, word, 2);
        if (out && t == 0) a.out[plane * out_plane + at] = word;
      }
    }
  }
}

template <class Ops, int KW>
int launch(const ArgsFor<Ops>& a, cudaStream_t stream) {
  const long long rows = 4LL * a.b * windows(conv_out(a.h, Ops::kStride), a.pool) *
                         windows(conv_out(a.w, Ops::kStride), a.pool);
  if (rows >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = expand_mma_conv3x3_kernel<Ops, KW>;
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
  const dim3 grid(static_cast<unsigned>((rows + kBM - 1) / kBM),
                  (a.n + kBN - 1) / kBN);
  kernel<<<grid, kThreads, smem_bytes<KW, Ops::kWPlanes>(a.p), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// KW = 4 words a step where the 16-byte activation copies are aligned
template <class Ops>
int dispatch(const ArgsFor<Ops>& a, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (a.cw % 4 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0) {
    return launch<Ops, 4>(a, s);
  }
  return launch<Ops, 1>(a, s);
}

}  // namespace

extern "C" {

// Plain C entry points, bound with ctypes by qnx_torch/kernels/_build.py.
// Each launches on the given stream, does not synchronise, and returns
// cudaGetLastError() so a refused launch is reported at once.

// Kernel D's conv: planes (P, B, H, W, Cw), mask / msign (9 Cw, N), corr
// (H, W, N) or null (no border term: the relu mode's instances, which load
// none), sgn (N,), tau (n_thresh, N) -> planes (P, B, H', W', ceil(N/32)).
int qnx_plane_conv3x3_fused(const void* xp, const void* mask, const void* msign,
                            const void* corr, const void* sgn, const void* tau,
                            void* out, int p, int b, int h, int w, int cw, int n,
                            int n_thresh, int pool, void* stream) {
  const ConvArgs a{static_cast<const uint32_t*>(xp), static_cast<const uint32_t*>(mask),
                   static_cast<const uint32_t*>(msign), nullptr,
                   static_cast<const int*>(corr), static_cast<const int*>(sgn),
                   static_cast<const int*>(tau), static_cast<uint32_t*>(out), p, b,
                   h, w, cw, n, n_thresh, pool, 0};
  // the served paths' planes get an unrolled expander: relu mode's one and
  // two (abits 2, 3), tanh mode's two (abits 2)
  if (corr) {
    if (p == 2) return dispatch<PlaneOperands<2, true>>(a, stream);
    return dispatch<PlaneOperands<0, true>>(a, stream);
  }
  if (p == 1) return dispatch<PlaneOperands<1>>(a, stream);
  if (p == 2) return dispatch<PlaneOperands<2>>(a, stream);
  return dispatch<PlaneOperands<0>>(a, stream);
}

// Kernel A's ternary conv: bits (B, H, W, Cw), mask / sign (9 Cw, N), nnz
// (N,), corr (H, W, N), sgn and tau (N,) -> words (B, H', W', ceil(N/32)).
int qnx_ternary_conv3x3_fused(const void* xp, const void* mask, const void* sign,
                              const void* nnz, const void* corr, const void* sgn,
                              const void* tau, void* out, int b, int h, int w,
                              int cw, int n, int pool, void* stream) {
  const ConvArgs a{static_cast<const uint32_t*>(xp), static_cast<const uint32_t*>(mask),
                   static_cast<const uint32_t*>(sign), static_cast<const int*>(nnz),
                   static_cast<const int*>(corr), static_cast<const int*>(sgn),
                   static_cast<const int*>(tau), static_cast<uint32_t*>(out), 1, b, h,
                   w, cw, n, 1, pool, 0};
  return dispatch<TernaryOperands>(a, stream);
}

// Kernel A's binary conv: bits (B, H, W, Cw), sign words (9 Cw, N), corr
// (H, W, N), sgn and tau (N,), k = 9 C -> words (B, H', W', ceil(N/32)).
int qnx_xnor_conv3x3_fused(const void* xp, const void* wp, const void* corr,
                           const void* sgn, const void* tau, void* out, int b,
                           int h, int w, int cw, int n, int k, int pool,
                           void* stream) {
  const ConvArgs a{static_cast<const uint32_t*>(xp), static_cast<const uint32_t*>(wp),
                   nullptr, nullptr, static_cast<const int*>(corr),
                   static_cast<const int*>(sgn), static_cast<const int*>(tau),
                   static_cast<uint32_t*>(out), 1, b, h, w, cw, n, 1, pool, k};
  return dispatch<BinaryOperands>(a, stream);
}

// Kernel A's residual binary conv (Bi-Real Net): bits (B, H, W, Cw), sign
// words (9 Cw, N), corr (H', W', N), scale and shift (N,) float32, the
// residual r (B, H', W', N) float32, k = 9 C, stride 1 or 2 (H' = ceil(H /
// stride)), N % 32 == 0 -> the stream (B, H', W', N) float32 into out_f and
// its sign bits (B, H', W', N / 32) into out.
int qnx_xnor_conv3x3_residual(const void* xp, const void* wp, const void* corr,
                              const void* scale, const void* shift, const void* res,
                              void* out_f, void* out, int b, int h, int w, int cw,
                              int n, int k, int stride, void* stream) {
  const ResidualArgs a{
      {static_cast<const uint32_t*>(xp), static_cast<const uint32_t*>(wp), nullptr,
       nullptr, static_cast<const int*>(corr), nullptr, nullptr,
       static_cast<uint32_t*>(out), 1, b, h, w, cw, n, 0, 0, k},
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<const float*>(res), static_cast<float*>(out_f)};
  if (n % 32 != 0 || (stride != 1 && stride != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return stride == 2 ? dispatch<BinaryResidualOperands<2>>(a, stream)
                     : dispatch<BinaryResidualOperands<1>>(a, stream);
}

}  // extern "C"
