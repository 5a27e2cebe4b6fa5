// The packed operands of the int8 tensor-core kernels (sm_90a) and their
// expansion to int8 MMA tiles, shared by the 3x3 convs
// (expand_mma_conv.cu) and the dense layers (expand_mma_dense.cu) of kernels
// A (binary), A' (ternary weights) and D (bit planes).
//
// Both mainloops copy K steps of KW packed 32-channel words into a ring in
// shared memory: the activation words of kBM rows, [stage][plane][row][KW],
// and the weight words of kBN columns, [stage][weight plane][column][KW].
// expand_tiles turns one stage into the A and B tiles of one K step, each
// word once, in the canonical no-swizzle K-major layout (core matrices of 8
// rows x 16 bytes; a weight word is already K-contiguous for its column, so
// there is no transpose).  It uses no multiply-spread: the MMA sums over k
// in any order, so within each 32-channel word the tiles of A and B both
// hold channel 8q + i at byte q of 32-bit tile word i (i < 8), and tile
// word i is the word's bits i, 8+i, 16+i, 24+i moved to the bytes' low bits
// by one funnel shift and one AND (planes: moved to bit j and ORed).
#pragma once

#include "wgmma_conv.cuh"

namespace qnx {

constexpr int kMaxPlanes = 8;  // plane_gemm.py MAX_PLANES: levels < 2^8
constexpr uint32_t kLsb = 0x01010101u;

__device__ __forceinline__ uint32_t rotr(uint32_t x, int s) {
  return __funnelshift_r(x, x, s);  // wrap: s mod 32
}

// ------------------------------------------------------------ operands
// Tile word i (i < 8) of a packed word holds its channels 8q + i at byte q.
// Each expander turns half h of a packed word (16 channels) into its tile
// words 4h .. 4h+3, 16 bytes of a tile: expand_a an activation row's word
// (plane j at w[j * stride]), expand_b a weight column's.

// Each class also says what the mainloop does around its expanders: kU8,
// the A operand's type; kWPlanes, the weight planes a K step copies;
// kCorr, whether the epilogue adds a column constant (A and A': the +-1
// product over every bit position of the words, pads included, is not the
// popcount form's s); kCount, whether that constant is A''s nnz - (set
// bits of the mask's column), else A's true k less the bit positions
// (conv: k - 288 Cw, dense: k - 32 Kw); kBorder, whether the conv's
// epilogue adds the border term corr[y, x, n] to each pixel's s before the
// pool (A and A' always; D where its planes hold quantized_tanh's
// unsigned indices, whose zero pads are not the zero activation).  The
// conv's mainloop also reads kStride, its stride (1 or 2), and kResidual,
// whether its epilogue writes the float stream of a residual binary conv
// (BinaryResidualOperands) rather than thresholded codes; the dense
// kernel reads neither.

// Kernel D, with kP planes (0: as many as the argument says), and with
// the border term where kBorderTerm.  A: u8 levels sum_j 2^j bit_j.  B: s8
// 2 msign - mask.  One product over the levels whatever P, so the border
// term is added once per output, not once per plane.
template <int kP, bool kBorderTerm = false>
struct PlaneOperands {
  static constexpr bool kU8 = true;
  static constexpr int kStride = 1;
  static constexpr bool kResidual = false;
  static constexpr int kWPlanes = 2;
  static constexpr bool kCorr = false;
  static constexpr bool kCount = false;
  static constexpr bool kBorder = kBorderTerm;

  __device__ static uint4 expand_a(const uint32_t* w, int stride, int planes, int h) {
    const int p = kP ? kP : planes;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < p; ++j) {
      // channel 8q + 4h + e moves to bit 8q + e + j
      const uint32_t x = rotr(w[j * stride], (4 * h - j) & 31);
      const uint32_t keep = kLsb << j;
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] |= rotr(x, e) & keep;
    }
    return make_uint4(v[0], v[1], v[2], v[3]);
  }

  __device__ static uint4 expand_b(uint32_t mask, uint32_t msign, int h) {
    const uint32_t xm = rotr(mask, 4 * h);
    const uint32_t xs = rotr(msign, (4 * h - 1) & 31);  // 2 msign
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // bytewise 2 msign - mask in [-1, 2]: offset by 0x80, so no byte
      // borrows from its neighbour, and back
      const uint32_t two_s = (rotr(xs, e) & 0x02020202u) | 0x80808080u;
      v[e] = (two_s - (rotr(xm, e) & kLsb)) ^ 0x80808080u;
    }
    return make_uint4(v[0], v[1], v[2], v[3]);
  }
};

// s8 +1 for a set bit, -1 for a clear one: A's and A''s activations, A's
// weights.
__device__ __forceinline__ uint4 expand_pm1(uint32_t word, int h) {
  const uint32_t x = rotr(word, 4 * h);
  uint32_t v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    // 0xFF - 0xFE per set byte: 0x01 or 0xFF, no borrow across bytes
    v[e] = (rotr(x, e) & kLsb) * 0xFFFFFF02u + 0xFFFFFFFFu;
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// Kernel A (binary).  A and B: s8 +-1 (expand_pm1), one weight plane.
struct BinaryOperands {
  static constexpr bool kU8 = false;
  static constexpr int kStride = 1;
  static constexpr bool kResidual = false;
  static constexpr int kWPlanes = 1;
  static constexpr bool kCorr = true;
  static constexpr bool kCount = false;
  static constexpr bool kBorder = true;

  __device__ static uint4 expand_a(const uint32_t* w, int, int, int h) {
    return expand_pm1(w[0], h);
  }

  __device__ static uint4 expand_b(uint32_t sign, uint32_t, int h) {
    return expand_pm1(sign, h);
  }
};

// Kernel A's residual binary conv (Bi-Real Net): A's operands and s, at
// stride kS (1 or 2); the epilogue writes x_new = (float(s) scale + shift)
// + r, float32, and its sign bits (x_new >= 0) in place of the threshold.
template <int kS>
struct BinaryResidualOperands : BinaryOperands {
  static_assert(kS == 1 || kS == 2, "stride 1 or 2");
  static constexpr int kStride = kS;
  static constexpr bool kResidual = true;
};

// Kernel A' (ternary weights).  A: s8 +-1 (expand_pm1).  B: s8 mask ?
// (sign ? +1 : -1) : 0.
struct TernaryOperands {
  static constexpr bool kU8 = false;
  static constexpr int kStride = 1;
  static constexpr bool kResidual = false;
  static constexpr int kWPlanes = 2;
  static constexpr bool kCorr = true;
  static constexpr bool kCount = true;
  static constexpr bool kBorder = true;

  __device__ static uint4 expand_a(const uint32_t* w, int, int, int h) {
    return expand_pm1(w[0], h);
  }

  __device__ static uint4 expand_b(uint32_t mask, uint32_t sign, int h) {
    const uint32_t neg = rotr(mask & ~sign, 4 * h);
    const uint32_t pos = rotr(mask & sign, 4 * h);
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // disjoint bytes: 0xFF, 0x01 or 0
      v[e] = (rotr(neg, e) & kLsb) * 0xFFu + (rotr(pos, e) & kLsb);
    }
    return make_uint4(v[0], v[1], v[2], v[3]);
  }
};

// The tiles of the K step in ring stage `stage` into tile buffer `buf`, by
// a block of kThreads threads (thread tid) over kBM activation rows with p
// planes and kBN weight columns.  A tile's unit u (tid + i kThreads) is row
// (column) group u / (16 KW), chunk c = (u / 8) % (2 KW) (half c & 1 of word
// c >> 1), row u % 8 of the group; its 16 bytes at 16 u of the tile.  Then
// the fence that shows the tiles to wgmma.
template <class Ops, int KW, int kBM, int kBN, int kThreads>
__device__ __forceinline__ void expand_tiles(const uint32_t* ring_a,
                                             const uint32_t* ring_b,
                                             unsigned char* a8, unsigned char* b8,
                                             int stage, int buf, int p, int tid) {
  constexpr int kWP = Ops::kWPlanes;
  constexpr int kKB = 32 * KW;  // k bytes of a step
  auto unit_a = [&](int u) {
    const int c = (u >> 3) % (2 * KW);
    const int r = (u >> 3) / (2 * KW) * 8 + (u & 7);
    const uint32_t* w = ring_a + (stage * p * kBM + r) * KW + (c >> 1);
    *reinterpret_cast<uint4*>(a8 + buf * kBM * kKB + u * 16) =
        Ops::expand_a(w, kBM * KW, p, c & 1);
  };
  auto unit_b = [&](int u) {
    const int c = (u >> 3) % (2 * KW);
    const int r = (u >> 3) / (2 * KW) * 8 + (u & 7);
    const uint32_t* w = ring_b + (stage * kWP * kBN + r) * KW + (c >> 1);
    *reinterpret_cast<uint4*>(b8 + buf * kBN * kKB + u * 16) =
        Ops::expand_b(w[0], w[(kWP - 1) * kBN * KW], c & 1);
  };
  static_assert(kBM * 2 * KW % kThreads == 0 && kBN * 2 * KW % kThreads == 0,
                "every thread expands whole units");
  if constexpr (kBM == kBN) {  // one unit of each tile in turn
#pragma unroll
    for (int i = 0; i < kBM * 2 * KW / kThreads; ++i) {
      unit_a(tid + i * kThreads);
      unit_b(tid + i * kThreads);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kBM * 2 * KW / kThreads; ++i) unit_a(tid + i * kThreads);
#pragma unroll
    for (int i = 0; i < kBN * 2 * KW / kThreads; ++i) unit_b(tid + i * kThreads);
  }
  fence_proxy_async();
}

}  // namespace qnx
