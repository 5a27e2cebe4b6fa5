// The pieces of the implicit-GEMM 3x3 convs on Hopper's int8 tensor cores
// (sm_90a) that expand_mma_conv.cu (kernels D and A, binary and ternary) and
// i8_conv_fused.cu (kernel E) share: cp.async copies into shared memory,
// wgmma.mma_async on K-major shared-memory tiles (the packed kernels' in
// the canonical no-swizzle layout, E's with the 128-byte swizzle), and the
// quad-major order of the GEMM rows.  The single-bit popcount GEMMs
// (popcount_gemm.cuh: kernels B and C, F4 and G) and the tensor-core probe
// (tc_probe.cu) take the copies, the swizzled tiles and the single-bit wgmma
// from here too, and F4 the TMA copies and their mbarriers.
//
// Rows (M) are output pixels in quad-major order: four consecutive rows are
// one 2x2 window, so a fused 2x2 pool is two __shfl_xor_sync over the lanes
// g, g^1, g^2, g^3 of the accumulator fragment.  Without the pool the
// windows are ceil-sized quads and a row outside the image reads zeros and
// writes nothing.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace qnx {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy kBytes (4, 8 or 16) from global to shared, or zeros where !valid
// (src is then not read, but must be a valid address).
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const int n = valid ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "n"(kBytes), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// Generic-proxy writes to shared memory, made visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// mbarriers in shared memory, and TMA copies that complete on them.  A
// barrier of count 1 completes a phase when its one arrival (with the bytes
// it expects) and those bytes have landed; waiters poll the phase's parity.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// The barriers' initialisation, visible to the async proxy (the TMA unit).
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` of bar has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// Copy the 2-D box at coordinates (c0 innermost, c1) of the tensor map at
// `map` (a __grid_constant__ kernel parameter) into shared memory at dst,
// completing on bar.  Elements outside the tensor arrive as zeros and
// count towards the bytes bar expects.
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map, int c0,
                                            int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most kPending of this warpgroup's wgmma groups are in flight.
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kPending) : "memory");
}

// Keep a register that an in-flight wgmma reads or writes where it is
// until the wait.
template <class T>
__device__ __forceinline__ void hold(T& r) {
  asm volatile("" : "+r"(r) :: "memory");
}

// Shared-memory matrix descriptor of a K-major tile without swizzle: core
// matrices of 8 rows x 16 bytes, 128 bytes apart along K (the leading
// offset), sbo bytes apart along M or N (the stride offset).
__device__ __forceinline__ uint64_t tile_desc(const void* tile, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// A K-major tile of rows of 128 bytes with the 128-byte swizzle: 16-byte
// chunk j of row r at chunk j ^ (r % 8) of its row, 8-row atoms of 1024
// bytes; the tile starts 1024-byte aligned.  Kernel E, which copies its
// tiles, ran twice as fast on it as on the no-swizzle layout; the packed
// kernels, which expand theirs, did not gain from it (PERF.md §6).
constexpr int kSwizzleAlign = 1024;

// Byte offset of copy unit u of a swizzled tile: unit u is 16-byte chunk
// (u / 8) % 8 of row (u / 64) 8 + u % 8, so eight consecutive units, one
// chunk of eight rows, land in eight distinct bank groups.
__device__ __forceinline__ int swizzle128(int u) {
  return (u >> 6) * 1024 + (u & 7) * 128 + ((((u >> 3) & 7) ^ (u & 7)) << 4);
}

// The descriptor of a swizzled tile, at byte k (a multiple of 32) of its
// rows: the stride offset is the 1024-byte atom, the layout 128B swizzle.
__device__ __forceinline__ uint64_t tile_desc_sw128(const void* tile) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// The same for K-major tiles of narrower rows (F2's K steps of 16 and 8
// words): rows of 64 bytes in the 64-byte swizzle (16-byte chunk j of row r
// at chunk j ^ ((r / 2) % 4), 8-row atoms of 512 bytes, layout type 2) and
// rows of 32 bytes in the 32-byte swizzle (chunk j ^ ((r / 4) % 2), atoms
// of 256 bytes, layout type 3); CuTe's Swizzle<2,4,3> and Swizzle<1,4,3>
// on byte offsets, as Swizzle<3,4,3> is the 128-byte one.  Each tile starts
// aligned to its atom.
__device__ __forceinline__ uint64_t tile_desc_sw64(const void* tile) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}

__device__ __forceinline__ uint64_t tile_desc_sw32(const void* tile) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(256 >> 4) << 32) | (3ull << 62);
}

// The first kSwizzleAlign-aligned byte of dynamic shared memory (a kernel
// that uses it asks for kSwizzleAlign bytes more than it needs).
__device__ __forceinline__ unsigned char* align_smem(unsigned char* smem) {
  return smem + ((kSwizzleAlign - (smem_addr(smem) & (kSwizzleAlign - 1))) &
                 (kSwizzleAlign - 1));
}

// d (64 rows of this warpgroup x 128 channels) += a * b, both from
// shared-memory tiles: 32 k of u8 x s8 (kU8) or s8 x s8, or 256 k of single
// bits, AND then popcount (wgmma_b1_k256; there also 64 channels, into 32
// accumulators).  Either reads 32 bytes of each K-major row.  Accumulator
// 4j + 2r + e of lane (g = lane / 4, t = lane % 4) of warp w of the
// warpgroup is row 16 w + g + 8 r, channel 8 j + 2 t + e.
#define QNX_D8(i)                                                          \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),              \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define QNX_WGMMA_M64N128(SHAPE_TYPES)                                       \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n128" SHAPE_TYPES " {"                \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n" \
      : QNX_D8(0), QNX_D8(8), QNX_D8(16), QNX_D8(24), QNX_D8(32), QNX_D8(40), \
        QNX_D8(48), QNX_D8(56)                                               \
      : "l"(desc_a), "l"(desc_b), "r"(1))
template <bool kU8>
__device__ __forceinline__ void wgmma_k32(int (&d)[64], uint64_t desc_a,
                                          uint64_t desc_b) {
  if constexpr (kU8) {
    QNX_WGMMA_M64N128("k32.s32.u8.s8");
  } else {
    QNX_WGMMA_M64N128("k32.s32.s8.s8");
  }
}

#define QNX_WGMMA_M64N64(SHAPE_TYPES)                                        \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64" SHAPE_TYPES " {"                 \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
      "%28, %29, %30, %31}, %32, %33, p;\n}\n"                                \
      : QNX_D8(0), QNX_D8(8), QNX_D8(16), QNX_D8(24)                         \
      : "l"(desc_a), "l"(desc_b), "r"(1))
// kRegs 64: m64n128k256; 32: m64n64k256
template <int kRegs>
__device__ __forceinline__ void wgmma_b1_k256(int (&d)[kRegs], uint64_t desc_a,
                                              uint64_t desc_b) {
  static_assert(kRegs == 64 || kRegs == 32, "n128 or n64");
  if constexpr (kRegs == 64) {
    QNX_WGMMA_M64N128("k256.s32.b1.b1.and.popc");
  } else {
    QNX_WGMMA_M64N64("k256.s32.b1.b1.and.popc");
  }
}
#undef QNX_WGMMA_M64N64
#undef QNX_WGMMA_M64N128
#undef QNX_D8

// The pixel of GEMM row m: window (bi, qy, qx), position p in it (rows
// < 2^31: the entry points check it).
struct Pixel {
  int bi, qy, qx, y, x;
};

__device__ __forceinline__ Pixel pixel_of(int m, int qh, int qw) {
  const int quad = m >> 2;
  const int p = m & 3;
  Pixel px;
  px.qx = quad % qw;
  const int r = quad / qw;
  px.qy = r % qh;
  px.bi = r / qh;
  px.y = 2 * px.qy + (p >> 1);
  px.x = 2 * px.qx + (p & 1);
  return px;
}

// Windows of a conv's quad-major rows: pooled outputs ('VALID': an odd H or
// W floors), or every pixel in ceil-sized quads.
__host__ __device__ __forceinline__ int windows(int extent, int pool) {
  return pool ? extent / 2 : (extent + 1) / 2;
}

}  // namespace qnx
