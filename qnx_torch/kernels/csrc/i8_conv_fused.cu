// Fused int8 3x3 conv + integer threshold epilogue (+ 2x2 max pool), for
// Hopper (sm_90a): kernel E of the port.
//
// Replaces the Pallas kernel qnx/kernels/i8_conv_fused.py:_conv_epilogue_kernel
// (entry i8_conv_fused) and gives the int8 codes of the unfused
// qnx.nn.int8_engine.I8Conv, the layer that pack_int8 builds:
//
//   s[b,y,x,n] = sum_{dy,dx,c} x8[b, y+dy-1, x+dx-1, c] * w8[dy, dx, c, n]
//                (int32; a tap outside the image reads an int8 zero, which
//                is the zero pad in every encoding, so there is no corr)
//   pool:   s = max of s over the 2x2 window ('VALID': odd H or W floor)
//   pm1:    code = sgn[n] * s >= tau[n] ? 1 : -1
//   levels: code = sum_v [sgn[n] * s >= tau[v, n]]
//
// I8Conv thresholds first and pools the codes, taking the window's minimum
// where sgn < 0.  Pooling s first is the same function: the code is
// nondecreasing in sgn*s, so the window's max code (sgn = 1) is the code of
// max s, and its min code (sgn = -1) is the code of min(-s) = -max s.  One
// threshold per pooled output instead of four.  The plain version
// (i8_conv_fused.py:i8_conv_fused_ref) keeps I8Conv's order, so the card's
// check holds the two formulations against each other.  The encoding is an
// argument: one threshold in the levels encoding is still levels ({0, 1}),
// never the sign encoding (the JAX I8Conv(fused=True) fault, ROADMAP.md §3).
// The compare is int32, tau is never negated (it may be INT32_MIN).
//
// Design: implicit GEMM on the tensor cores, mma.sync m16n8k32 s8 x s8 ->
// s32.  Rows (M) are output pixels in quad-major order, four consecutive rows
// one 2x2 window, so the pool is two __shfl_xor_sync in the epilogue; columns
// (N) are output channels; K = 9*C, tap-major as w8's (3, 3, C, N) layout,
// taken in steps of 32 channels of one tap.  A block of 8 warps owns 128 rows
// x 128 channels (each warp 64 x 32: 4 x 4 mma tiles, 64 int32 accumulators
// a thread).  Each step's operand tiles pass through registers into shared
// memory, double-buffered, so the next step's global loads are in flight
// while the tensor cores run this one.  The mma wants K contiguous for each
// output channel, and w8 has N contiguous: each thread transposes a 4x4 byte
// block with __byte_perm on its way into shared memory.  Shared rows are 12
// words apart (8 used), so the fragment loads hit 32 distinct banks.  Ragged
// B, H, W, C and N are masked: rows past the image and channels past C load
// zeros, columns past N load zero weights and store nothing.
//
// Bound on an H100 SXM: at the cifar10 VGG's conv shapes each conv does
// 19-39 GMAC at batch 256 over 4-42 MB of int8 codes and weights, so the
// tensor cores bound it (1,979 int8 TOP/s dense at 700 W: 39.1 us for conv_1
// against 12.5 us for its bytes at 3.35 TB/s).  This first version uses the
// legacy mma.sync path with plain loads; wgmma, TMA and warp specialisation
// are later work.  The accumulator is exact for any int8 operands while
// 9*C*128*128 < 2^31, C <= 14563 (the wrapper checks).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 128;       // output pixels of a block (32 windows)
constexpr int kBN = 128;       // output channels of a block
constexpr int kBK = 32;        // channels of one tap per step (one mma k)
constexpr int kThreads = 256;  // 8 warps: 2 along M x 4 along N
constexpr int kStride = 12;    // shared row stride in 32-bit words (8 used)
constexpr unsigned kFull = 0xffffffffu;

struct Tiles {
  uint32_t a[2][kBM * kStride];  // [pixel][k word], double-buffered
  uint32_t b[2][kBN * kStride];  // [channel][k word]
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The pixel of GEMM row m: window (bi, qy, qx), position p in it.
struct Pixel {
  long long bi;
  int qy, qx, y, x;
};

__device__ __forceinline__ Pixel pixel_of(long long m, int qh, int qw) {
  const long long quad = m >> 2;
  const int p = static_cast<int>(m & 3);
  Pixel px;
  px.qx = static_cast<int>(quad % qw);
  const long long r = quad / qw;
  px.qy = static_cast<int>(r % qh);
  px.bi = r / qh;
  px.y = 2 * px.qy + (p >> 1);
  px.x = 2 * px.qx + (p & 1);
  return px;
}

// grid (ceil(4 * b * qh * qw / kBM), ceil(n / kBN)), block kThreads.
// kVecX: C % 16 == 0, 16-byte activation loads.  kVecW: N % 4 == 0, 4-byte
// weight loads.  Otherwise byte loads, masked byte by byte.
template <bool kVecX, bool kVecW>
__global__ void __launch_bounds__(kThreads)
i8_conv3x3_fused_kernel(const int8_t* __restrict__ x8,
                        const int8_t* __restrict__ w8,
                        const int* __restrict__ sgn,
                        const int* __restrict__ tau,
                        int8_t* __restrict__ out,
                        int b, int h, int w, int c, int n, int n_thresh,
                        int levels, int pool) {
  __shared__ __align__(16) Tiles smem;
  Tiles& tiles = smem;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // mma groupID
  const int t = lane & 3;   // mma threadID_in_group
  const int wm = warp & 1;  // the warp's 64 rows
  const int wn = warp >> 1; // the warp's 32 channels
  // windows: pooled outputs ('VALID'), or every pixel in ceil-sized quads
  const int qh = pool ? h / 2 : (h + 1) / 2;
  const int qw = pool ? w / 2 : (w + 1) / 2;
  const long long rows = 4LL * b * qh * qw;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  // activation loads: 16 bytes of one row a thread
  const int a_row = tid >> 1;
  const int a_part = (tid & 1) * 16;
  int ay = -2, ax = -2;  // a row past the end reads nothing
  const int8_t* a_img = x8;
  if (m0 + a_row < rows) {
    const Pixel px = pixel_of(m0 + a_row, qh, qw);
    ay = px.y;
    ax = px.x;
    a_img = x8 + static_cast<size_t>(px.bi) * h * w * c;
  }
  // weight loads: a 4 (k) x 4 (channel) byte block a thread
  const int b_k = (tid & 7) * 4;
  const int b_n = (tid >> 3) * 4;

  const int steps_per_tap = (c + kBK - 1) / kBK;
  const int steps = 9 * steps_per_tap;
  uint4 ra;
  uint32_t rb[4];

  auto load = [&](int step) {
    const int tap = step / steps_per_tap;
    const int c0 = (step - tap * steps_per_tap) * kBK;
    const int iy = ay + tap / 3 - 1;
    const int ix = ax + tap % 3 - 1;
    const int ca = c0 + a_part;
    ra = make_uint4(0u, 0u, 0u, 0u);
    if (ay >= 0 && iy >= 0 && iy < h && ix >= 0 && ix < w && ca < c) {
      const int8_t* src = a_img + (static_cast<size_t>(iy) * w + ix) * c + ca;
      if constexpr (kVecX) {
        ra = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          if (ca + i < c) {
            v[i >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(src[i]))
                         << (8 * (i & 3));
          }
        }
        ra = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    const int col = n0 + b_n;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int cb = c0 + b_k + i;
      rb[i] = 0u;
      if (cb < c && col < n) {
        const int8_t* src = w8 + (static_cast<size_t>(tap) * c + cb) * n + col;
        if constexpr (kVecW) {
          rb[i] = __ldg(reinterpret_cast<const uint32_t*>(src));
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (col + j < n) {
              rb[i] |= static_cast<uint32_t>(static_cast<uint8_t>(src[j])) << (8 * j);
            }
          }
        }
      }
    }
  };

  auto store = [&](int buf) {
    *reinterpret_cast<uint4*>(&tiles.a[buf][a_row * kStride + a_part / 4]) = ra;
    // rb[i] holds k row b_k + i of channels b_n .. b_n + 3; word j of the
    // transposed block holds channel b_n + j of k rows b_k .. b_k + 3
    const uint32_t t0 = __byte_perm(rb[0], rb[1], 0x5140);
    const uint32_t t1 = __byte_perm(rb[0], rb[1], 0x7362);
    const uint32_t t2 = __byte_perm(rb[2], rb[3], 0x5140);
    const uint32_t t3 = __byte_perm(rb[2], rb[3], 0x7362);
    uint32_t* dst = &tiles.b[buf][b_n * kStride + b_k / 4];
    dst[0] = __byte_perm(t0, t2, 0x5410);
    dst[kStride] = __byte_perm(t0, t2, 0x7632);
    dst[2 * kStride] = __byte_perm(t1, t3, 0x5410);
    dst[3 * kStride] = __byte_perm(t1, t3, 0x7632);
  };

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  load(0);
  store(0);
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const int cur = step & 1;
    if (step + 1 < steps) load(step + 1);
    const uint32_t* sa = tiles.a[cur];
    const uint32_t* sb = tiles.b[cur];
    uint32_t af[4][4];
    uint32_t bf[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int r = wm * 64 + mi * 16 + g;
      af[mi][0] = sa[r * kStride + t];
      af[mi][1] = sa[(r + 8) * kStride + t];
      af[mi][2] = sa[r * kStride + t + 4];
      af[mi][3] = sa[(r + 8) * kStride + t + 4];
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = wn * 32 + ni * 8 + g;
      bf[ni][0] = sb[col * kStride + t];
      bf[ni][1] = sb[col * kStride + t + 4];
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    if (step + 1 < steps) store(cur ^ 1);
    __syncthreads();
  }

  // epilogue: accumulator r of tile (mi, ni) is row wm*64 + mi*16 + g +
  // 8*(r >> 1), channel wn*32 + ni*8 + 2*t + (r & 1)
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + wn * 32 + ni * 8 + 2 * t + j;
      const bool live = col < n;
      const int sg = live ? __ldg(sgn + col) : 0;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          int s = acc[mi][ni][2 * half + j];
          const long long m = m0 + wm * 64 + mi * 16 + 8 * half + g;
          if (pool) {  // the window's four rows are lanes g, g^1, g^2, g^3
            s = max(s, __shfl_xor_sync(kFull, s, 4));
            s = max(s, __shfl_xor_sync(kFull, s, 8));
            if (g & 3) continue;
          }
          if (!live || m >= rows) continue;
          const int u = sg * s;
          int code;
          if (levels) {
            code = 0;
            for (int v = 0; v < n_thresh; ++v) {
              code += u >= __ldg(tau + static_cast<size_t>(v) * n + col);
            }
          } else {
            code = u >= __ldg(tau + col) ? 1 : -1;
          }
          const Pixel px = pixel_of(m, qh, qw);
          size_t pos;
          if (pool) {
            pos = (static_cast<size_t>(px.bi) * qh + px.qy) * qw + px.qx;
          } else {
            if (px.y >= h || px.x >= w) continue;
            pos = (static_cast<size_t>(px.bi) * h + px.y) * w + px.x;
          }
          out[pos * n + col] = static_cast<int8_t>(code);
        }
      }
    }
  }
}

template <bool kVecX, bool kVecW>
int launch(const void* x8, const void* w8, const void* sgn, const void* tau,
           void* out, int b, int h, int w, int c, int n, int n_thresh,
           int levels, int pool, cudaStream_t stream) {
  const long long qh = pool ? h / 2 : (h + 1) / 2;
  const long long qw = pool ? w / 2 : (w + 1) / 2;
  const long long rows = 4LL * b * qh * qw;
  const dim3 grid(static_cast<unsigned>((rows + kBM - 1) / kBM), (n + kBN - 1) / kBN);
  i8_conv3x3_fused_kernel<kVecX, kVecW><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(x8), static_cast<const int8_t*>(w8),
      static_cast<const int*>(sgn), static_cast<const int*>(tau),
      static_cast<int8_t*>(out), b, h, w, c, n, n_thresh, levels, pool);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Plain C entry point, bound with ctypes by qnx_torch/kernels/_build.py.
// Launches on the given stream, does not synchronise, and returns
// cudaGetLastError() so a refused launch is reported at once.  levels: 0 for
// the pm1 encoding (tau (N,)), 1 for levels (tau (n_thresh, N)).
int qnx_i8_conv3x3_fused(const void* x8, const void* w8, const void* sgn,
                         const void* tau, void* out, int b, int h, int w,
                         int c, int n, int n_thresh, int levels, int pool,
                         void* stream) {
  const bool vec_x = c % 16 == 0 && reinterpret_cast<uintptr_t>(x8) % 16 == 0;
  const bool vec_w = n % 4 == 0 && reinterpret_cast<uintptr_t>(w8) % 4 == 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (vec_x && vec_w) return launch<true, true>(x8, w8, sgn, tau, out, b, h, w, c, n, n_thresh, levels, pool, s);
  if (vec_x) return launch<true, false>(x8, w8, sgn, tau, out, b, h, w, c, n, n_thresh, levels, pool, s);
  if (vec_w) return launch<false, true>(x8, w8, sgn, tau, out, b, h, w, c, n, n_thresh, levels, pool, s);
  return launch<false, false>(x8, w8, sgn, tau, out, b, h, w, c, n, n_thresh, levels, pool, s);
}

}  // extern "C"
