// Fused int8 3x3 conv + integer threshold epilogue (+ 2x2 max pool) on
// Hopper's int8 tensor cores (sm_90a): kernel E of the port.
//
// Replaces the Pallas kernel qnx/kernels/i8_conv_fused.py:_conv_epilogue_kernel
// (:40, entry i8_conv_fused :102) and gives the int8 codes of the unfused
// qnx.nn.int8_engine.I8Conv, the layer that pack_int8 builds:
//
//   s[b,y,x,n] = sum_{dy,dx,c} x8[b, y+dy-1, x+dx-1, c] * w8[dy, dx, c, n]
//                (int32; a tap outside the image reads an int8 zero, which
//                is the zero pad in every encoding, so there is no corr)
//   pool:   s = max of s over the 2x2 window ('VALID': odd H or W floor)
//   k    = sum_v [sgn[n] * s >= tau[v, n]]     (n_thresh thresholds)
//   code = mul * k - off, the encoding's affine form:
//     pm1    (2, 1): one threshold, code -1 or +1   (binary_tanh)
//     zo     (1, 0): one threshold, code 0 or 1     (binary_sigmoid)
//     levels (1, 0): code 0 .. n_thresh             (quantized_relu)
//     tanh   (1, n_thresh / 2): n_thresh = 2L - 2 thresholds, signed code
//            -(L-1) .. L-1, down to -127 at 8 bits  (quantized_tanh)
//
// I8Conv thresholds first and pools the codes, taking the window's minimum
// where sgn < 0.  Pooling s first is the same function in every encoding:
// mul > 0, so the code is nondecreasing in sgn*s, and the window's max code
// (sgn = 1) is the code of max s, its min code (sgn = -1) the code of
// min(-s) = -max s.  One threshold per pooled output instead of four.  The
// plain version (i8_conv_fused.py:i8_conv_fused_ref) keeps I8Conv's order,
// so the card's check holds the two formulations against each other.  The
// encoding is an argument, passed as its affine form: one threshold in the
// levels or zo encoding is {0, 1}, never the sign encoding's {-1, +1} (the
// JAX I8Conv(fused=True) fault, ROADMAP.md §3).  A zero code is the zero
// activation in every encoding (zo's 0, tanh's signed 0), so a zero pad
// needs no border term.  The compare is int32, tau is never negated (it
// may be INT32_MIN).  The accumulator is exact for any int8 operands while
// 9*C*128*128 < 2^31, C <= 14563 (the wrapper checks).
//
// What bounds it on an H100: the int8 tensor cores (1,979 TOP/s dense at
// 700 W; 0.156 ms for the five cifar10 VGG convs at batch 256) only if the
// operands reach them.  Unlike the packed kernels (expand_mma_conv.cu),
// whose operands stay 1 bit a value until shared memory, E's are int8: a
// block of 128 rows x 128 channels copies 256 bytes from L2 per channel of
// a tap for 16384 MACs, 64 MACs a byte (about 2 GB for the five convs), and
// the tensor cores read every tile byte from shared memory.
//
// Design: implicit GEMM on wgmma.mma_async m64n128k32 s8 x s8 -> s32, both
// operands from shared memory (wgmma_conv.cuh).  Rows (M) are output pixels
// in quad-major order, so the 2x2 pool is two __shfl_xor_sync in the
// epilogue; columns (N) are output channels; K = 9 C, tap-major.  A block of
// two warpgroups owns 128 rows x 128 channels, each warpgroup its 64 rows;
// two blocks a SM.  A K step is 128 channels of one tap.  The codes need no
// expansion: x8 (B, H, W, C) is K-contiguous per pixel, and the weights
// come K-major, wk (N, 9 Cp) with each tap's C channels zero-padded to
// Cp = ceil16(C) (made once by I8Conv), so cp.async copies 16-byte chunks
// of both straight into the tiles that the wgmma descriptors read; no
// transpose, no register staging.  The tiles' rows are the step's 128
// bytes in the 128-byte swizzle: on the no-swizzle layout of the packed
// kernels the K loop ran at half the speed (PERF.md §6).  A tap outside the
// image, a row past the end and channels past C or Cp zero-fill.  For C
// not a multiple of 16 the activation chunks are copied 4 bytes (C % 4 ==
// 0) or 1 byte at a time.  The tiles form a ring of kStages stages: copies
// run one step ahead and one wgmma group stays in flight across the
// barrier (wgmma.wait_group 1), so the tensor cores do not wait for a
// step's barrier.  Per K step: wait for this step's copies, one
// __syncthreads, issue the copies of step + 1 into the stage step - 2's
// wgmma read, issue this step's wgmma, wait for step - 1's.  Measured
// against it (PERF.md §6): 128 x 256 tiles where N >= 256 and a fourth
// stage (one block a SM each), and 64-channel steps on the no-swizzle
// layout with 4 to 8 stages.
//
// The epilogue is latency, as in the packed kernels: the block's sgn and
// its first kSmemTau thresholds per channel are staged in shared memory
// while the first copies land; more thresholds are read through L1.
#include "wgmma_conv.cuh"

namespace {

using namespace qnx;

constexpr int kBM = 128;            // output pixels of a block (32 windows)
constexpr int kBN = 128;            // output channels of a block
constexpr int kKC = 128;            // channels of one tap a K step: 128 bytes
constexpr int kChunks = kKC / 16;   // 16-byte chunks of a row a K step
constexpr int kThreads = 256;       // two warpgroups, 64 rows each
constexpr int kSmemTau = 15;        // thresholds held in shared memory
constexpr int kStages = 3;          // tile ring: two blocks a SM
// this thread's rows (columns) of the copies: kRowStride apart
constexpr int kRowStride = kThreads / kChunks;
static_assert(kChunks == 8, "swizzle128 lays out rows of 8 chunks");

struct I8Args {
  const int8_t* x;   // (B, H, W, C) codes
  const int8_t* wk;  // (N, 9 Cp) K-major weights
  const int* sgn;    // (N,)
  const int* tau;    // (n_thresh, N)
  int8_t* out;       // (B, H', W', N) codes
  int b, h, w, c, cp, n, n_thresh, pool;
  int mul, off;      // code = mul * (thresholds passed) - off
};

// the tile ring, then the block's sgn and first thresholds
constexpr size_t kSmemBytes = kSwizzleAlign + kStages * (kBM + kBN) * kKC +
                              sizeof(int) * (1 + kSmemTau) * kBN;

// 16 bytes of activation channels [c, c + 16) of a pixel's codes at src
// (nullptr: a tap outside the image or a row past the end) into dst, zeros
// past C; kVec-byte copies (any is a valid address, never read).
template <int kVec>
__device__ __forceinline__ void copy_codes(unsigned char* dst, const int8_t* src,
                                           int c, int channels, const int8_t* any) {
  if constexpr (kVec == 1) {  // synchronous: the stage is free, as for cp.async
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (src) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (c + i < channels) {
          v[i >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(src + c + i)))
                       << (8 * (i & 3));
        }
      }
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 16; j += kVec) {
      const bool valid = src != nullptr && c + j < channels;
      cp_async<kVec>(dst + j, valid ? src + c + j : any, valid);
    }
  }
}

// grid (ceil(4 b qh qw / kBM), ceil(n / kBN)), block kThreads, dynamic
// shared memory kSmemBytes.  kVec: the activation copies' bytes.
template <int kVec>
__global__ void __launch_bounds__(kThreads, 2)
i8_conv3x3_kernel(const I8Args a) {
  constexpr int kStageBytes = (kBM + kBN) * kKC;
  constexpr int kRows = kBM / kRowStride;  // activation rows a thread copies
  constexpr int kCols = kBN / kRowStride;  // weight rows a thread copies
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // stage s: A tile [kBM][kKC bytes], then B tile [kBN][kKC bytes], both
  // swizzled (swizzle128)
  unsigned char* smem = align_smem(smem_raw);
  int* col_sgn = reinterpret_cast<int*>(smem + kStages * kStageBytes);
  const int* col_tau = col_sgn + kBN;  // [kSmemTau][kBN]

  const int tid = threadIdx.x;
  __builtin_assume(tid < kThreads);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;   // groupID
  const int t = lane & 3;    // threadID_in_group
  const int wg = warp >> 2;  // the warpgroup's 64 rows
  // this thread's accumulator rows: wrow and wrow + 8
  const int wrow = wg * 64 + (warp & 3) * 16 + g;
  const int qh = windows(a.h, a.pool);
  const int qw = windows(a.w, a.pool);
  const int rows = 4 * a.b * qh * qw;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // this thread's copies: chunk ch of rows (and weight columns) r0 + i
  // kRowStride; copy u = tid + i kThreads lands at swizzle128(u) of its tile
  const int ch = (tid >> 3) % kChunks;
  const int r0 = tid / (8 * kChunks) * 8 + (tid & 7);
  int cy[kRows], cx[kRows];  // a row outside the image or past the rows: zeros
  const int8_t* xrow[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int m = m0 + r0 + i * kRowStride;
    cy[i] = cx[i] = -4;
    xrow[i] = a.x;
    if (m < rows) {
      const Pixel px = pixel_of(m, qh, qw);
      if (px.y < a.h && px.x < a.w) {
        cy[i] = px.y;
        cx[i] = px.x;
        xrow[i] = a.x + (static_cast<size_t>(px.bi * a.h + px.y) * a.w + px.x) * a.c;
      }
    }
  }
  const int8_t* wcol[kCols];
  bool wlive[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const int col = n0 + r0 + i * kRowStride;
    wlive[i] = col < a.n;
    wcol[i] = a.wk + static_cast<size_t>(wlive[i] ? col : 0) * 9 * a.cp;
  }

  const int steps = 9 * ((a.cp + kKC - 1) / kKC);
  // the next step to copy: its tap, its first channel in the tap, its stage
  int i_step = 0, i_tap = 0, i_c0 = 0, i_stage = 0;
  auto issue = [&]() {
    if (i_step < steps) {
      const int dy = i_tap / 3 - 1;
      const int dx = i_tap - 3 * (dy + 1) - 1;
      const int c = i_c0 + ch * 16;
      unsigned char* ta = smem + i_stage * kStageBytes;
      unsigned char* tb = ta + kBM * kKC;
      const long long shift = static_cast<long long>(dy * a.w + dx) * a.c;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int iy = cy[i] + dy;
        const int ix = cx[i] + dx;
        const bool av = iy >= 0 && iy < a.h && ix >= 0 && ix < a.w;
        copy_codes<kVec>(ta + swizzle128(tid + i * kThreads), av ? xrow[i] + shift : nullptr,
                         c, a.c, a.x);
      }
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const bool bv = wlive[i] && c < a.cp;
        cp_async<16>(tb + swizzle128(tid + i * kThreads),
                     bv ? wcol[i] + i_tap * a.cp + c : a.wk, bv);
      }
      ++i_step;
      i_stage = i_stage + 1 == kStages ? 0 : i_stage + 1;
      i_c0 += kKC;
      if (i_c0 >= a.cp) {
        i_c0 = 0;
        ++i_tap;
      }
    }
    cp_async_commit();
  };

  int acc[64];  // n8 tile j: channels 8j + 2t, +1 of row wrow, then wrow + 8
#pragma unroll
  for (int r = 0; r < 64; ++r) acc[r] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 2; ++s) issue();
  // the block's sgn and first thresholds, while the first copies land
  const int smem_tau = a.n_thresh <= kSmemTau ? a.n_thresh : 0;
  for (int i = tid; i < (1 + smem_tau) * kBN; i += kThreads) {
    const int col = n0 + i % kBN;
    const int what = i / kBN;  // sgn, then the thresholds
    int v = 0;
    if (col < a.n) {
      v = what ? __ldg(a.tau + static_cast<size_t>(what - 1) * a.n + col)
               : __ldg(a.sgn + col);
    }
    col_sgn[i] = v;
  }

  int stage = 0;  // step's
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 3>();  // this thread's copies of step have landed
    fence_proxy_async();           // ... visible to wgmma's reads
    // every thread's copies of step are visible, and every warpgroup is
    // done with step - 2's wgmma (it waited for them in step - 1)
    __syncthreads();
    issue();  // step + kStages - 2, into the stage step - 2 read
    const unsigned char* ta = smem + stage * kStageBytes;
    stage = stage + 1 == kStages ? 0 : stage + 1;
    const unsigned char* tb = ta + kBM * kKC;
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kKC / 32; ++kc) {
      wgmma_k32<false>(acc, tile_desc_sw128(ta + wg * 64 * kKC + kc * 32),
                       tile_desc_sw128(tb + kc * 32));
    }
    wgmma_commit();
    wgmma_wait<1>();  // step - 1's group is done; step's stays in flight
#pragma unroll
    for (int r = 0; r < 64; ++r) hold(acc[r]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int r = 0; r < 64; ++r) hold(acc[r]);

  // epilogue: each of this thread's two rows, two channels of an n8 tile
  // at a time; threshold v of the block's channel c at tau[v * stride + c]
  const int* tau = smem_tau ? col_tau : a.tau + n0;
  const int stride = smem_tau ? kBN : a.n;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + wrow + 8 * r;
    const bool in_rows = m < rows;
    Pixel px{};
    if (in_rows) px = pixel_of(m, qh, qw);
    const bool out = a.pool ? in_rows && (g & 3) == 0
                            : in_rows && px.y < a.h && px.x < a.w;
    size_t pos = 0;
    if (out) {
      pos = a.pool ? (static_cast<size_t>(px.bi) * qh + px.qy) * qw + px.qx
                   : (static_cast<size_t>(px.bi) * a.h + px.y) * a.w + px.x;
    }
    int8_t* orow = a.out + pos * a.n + n0;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      if (n0 + 8 * j >= a.n) break;  // uniform: no channel of this tile is real
      const int c = 8 * j + 2 * t;   // the block's channel of e = 0
      int s0 = acc[4 * j + 2 * r];
      int s1 = acc[4 * j + 2 * r + 1];
      if (a.pool) {  // the window's four rows are lanes g, g^1, g^2, g^3
        s0 = max(s0, __shfl_xor_sync(kFull, s0, 4));
        s0 = max(s0, __shfl_xor_sync(kFull, s0, 8));
        s1 = max(s1, __shfl_xor_sync(kFull, s1, 4));
        s1 = max(s1, __shfl_xor_sync(kFull, s1, 8));
      }
      const bool live1 = n0 + c + 1 < a.n;
      if (out && n0 + c < a.n) {
        const int u0 = col_sgn[c] * s0;
        const int u1 = col_sgn[c + 1] * s1;
        int k0 = 0, k1 = 0;
        for (int v = 0; v < a.n_thresh; ++v) {
          const int* tau_v = tau + static_cast<size_t>(v) * stride + c;
          k0 += u0 >= tau_v[0];
          if (live1) k1 += u1 >= tau_v[1];
        }
        k0 = a.mul * k0 - a.off;  // the encoding's code, -127 .. 127
        k1 = a.mul * k1 - a.off;
        // both bytes, 2-aligned; a negative code's two's complement byte
        if (live1 && (a.n & 1) == 0) {
          *reinterpret_cast<uint16_t*>(orow + c) = static_cast<uint16_t>(
              (k0 & 0xff) | ((k1 & 0xff) << 8));
        } else {
          orow[c] = static_cast<int8_t>(k0);
          if (live1) orow[c + 1] = static_cast<int8_t>(k1);
        }
      }
    }
  }
}

template <int kVec>
int launch(const I8Args& a, cudaStream_t stream) {
  const long long rows = 4LL * a.b * windows(a.h, a.pool) * windows(a.w, a.pool);
  if (rows >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = i8_conv3x3_kernel<kVec>;
  // once per instance: the dynamic shared memory, and the SM's shared
  // memory split towards shared
  static const cudaError_t configured = [&] {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    }
    return e;
  }();
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const dim3 grid(static_cast<unsigned>((rows + kBM - 1) / kBM), (a.n + kBN - 1) / kBN);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Plain C entry point, bound with ctypes by qnx_torch/kernels/_build.py.
// Launches on the given stream, does not synchronise, and returns
// cudaGetLastError() so a refused launch is reported at once.  x8 (B, H,
// W, C) int8 codes; wk (N, 9 Cp) int8 weights, K-major, each tap's C
// channels zero-padded to Cp = ceil(C / 16) 16, 16-byte aligned; sgn (N,);
// tau (n_thresh, N); mul, off: the encoding's code mul * k - off of the k
// thresholds passed (pm1 2, 1; zo and levels 1, 0; tanh 1, n_thresh / 2)
// -> out (B, H', W', N) int8 codes.
int qnx_i8_conv3x3_fused(const void* x8, const void* wk, const void* sgn,
                         const void* tau, void* out, int b, int h, int w,
                         int c, int n, int n_thresh, int mul, int off, int pool,
                         void* stream) {
  if (reinterpret_cast<uintptr_t>(wk) % 16) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const I8Args a{static_cast<const int8_t*>(x8), static_cast<const int8_t*>(wk),
                 static_cast<const int*>(sgn), static_cast<const int*>(tau),
                 static_cast<int8_t*>(out), b, h, w, c, (c + 15) / 16 * 16, n,
                 n_thresh, pool, mul, off};
  // the activation copies' width: 16 bytes where C and x8 allow it
  auto s = static_cast<cudaStream_t>(stream);
  const auto x = reinterpret_cast<uintptr_t>(x8);
  if (c % 16 == 0 && x % 16 == 0) return launch<16>(a, s);
  if (c % 4 == 0 && x % 4 == 0) return launch<4>(a, s);
  return launch<1>(a, s);
}

}  // extern "C"
