// Tensor-core rate probe on Hopper (sm_90a): MACs a second of wgmma on
// single-bit operands (m64n128k256 .s32.b1.b1.and.popc) against int8
// (m64n128k32 .s32.s8.s8), both on the same tiles resident in shared
// memory, with no global traffic in the timed loop.
//
// Replaces no TPU kernel.  It decides the instruction of popcount_gemm.cu
// (kernels B and C at wide N) and calibrates roofline.H100_PEAKS["b1_macs"]
// (qnx_torch/bench/roofline.py) by measurement, as int_probe.cu (H) did the
// popc ceiling; its wrapper and measurement are qnx_torch/bench/tc_probe.py.
//
//   out[w, r, c] = iters * sum_{kc < 4} op(a[r, kc], b[c, kc])   (mod 2^32)
//
// a is 64 rows x 128 bytes and b 128 rows x 128 bytes, K-major; op is the
// AND-popcount of 256 bits (b1) or the s8 dot of 32 bytes (s8), so both
// read the same bytes and the same 128-byte-swizzled tiles the GEMMs read
// (wgmma_conv.cuh); w is the warpgroup, each of which computes the whole
// product.  Bound: the tensor cores alone.  The loop commits four wgmma a
// group and keeps one group in flight across the wait, as the GEMMs do;
// two blocks of two warpgroups a SM.
#include "wgmma_conv.cuh"

namespace {

using namespace qnx;

constexpr int kThreads = 256;  // two warpgroups
constexpr int kRowBytes = 128;
constexpr int kRowsA = 64;
constexpr int kRowsB = 128;
constexpr int kSteps = kRowBytes / 32;  // wgmma an iteration
constexpr size_t kSmemBytes = kSwizzleAlign + (kRowsA + kRowsB) * kRowBytes;

// grid blocks, block kThreads, dynamic shared memory kSmemBytes
template <bool kB1>
__global__ void __launch_bounds__(kThreads, 2)
tc_probe_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                int* __restrict__ out, int iters) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* ta = align_smem(smem_raw);  // rows 0..63: a; 64..191: b
  const unsigned char* tb = ta + kRowsA * kRowBytes;
  const int tid = threadIdx.x;
  for (int u = tid; u < (kRowsA + kRowsB) * 8; u += kThreads) {
    const int row = (u >> 6) * 8 + (u & 7);  // swizzle128's row and chunk
    const int ch = (u >> 3) & 7;
    const uint4 v = row < kRowsA ? a[row * 8 + ch] : b[(row - kRowsA) * 8 + ch];
    *reinterpret_cast<uint4*>(ta + swizzle128(u)) = v;
  }
  fence_proxy_async();
  __syncthreads();

  int acc[64];
#pragma unroll
  for (int r = 0; r < 64; ++r) acc[r] = 0;
  wgmma_fence();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int kc = 0; kc < kSteps; ++kc) {
      const uint64_t da = tile_desc_sw128(ta + kc * 32);
      const uint64_t db = tile_desc_sw128(tb + kc * 32);
      if constexpr (kB1) {
        wgmma_b1_k256(acc, da, db);
      } else {
        wgmma_k32<false>(acc, da, db);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
#pragma unroll
    for (int r = 0; r < 64; ++r) hold(acc[r]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int r = 0; r < 64; ++r) hold(acc[r]);

  // accumulator 4j + 2r + e of lane (g, t) of warp w: row 16 w + g + 8 r,
  // column 8 j + 2 t + e
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int row = ((tid >> 5) & 3) * 16 + (lane >> 2);
  int* o = out + (static_cast<size_t>(blockIdx.x) * 2 + wg) * kRowsA * kRowsB;
#pragma unroll
  for (int j = 0; j < kRowsB / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int c = 8 * j + 2 * (lane & 3);
      o[(row + 8 * r) * kRowsB + c] = acc[4 * j + 2 * r];
      o[(row + 8 * r) * kRowsB + c + 1] = acc[4 * j + 2 * r + 1];
    }
  }
}

template <bool kB1>
int launch(const void* a, const void* b, void* out, int blocks, int iters,
           cudaStream_t stream) {
  tc_probe_kernel<kB1><<<blocks, kThreads, kSmemBytes, stream>>>(
      static_cast<const uint4*>(a), static_cast<const uint4*>(b),
      static_cast<int*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Plain C entry point, bound with ctypes by qnx_torch/kernels/_build.py:
// a (64, 32) and b (128, 32) int32 words, 16-byte aligned; out (2 blocks,
// 64, 128) int32; b1 != 0 for the single-bit wgmma, else s8.  Launches on
// the given stream and returns cudaGetLastError().
int qnx_tc_probe(const void* a, const void* b, void* out, int b1, int blocks,
                 int iters, void* stream) {
  if (blocks < 1 || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return b1 ? launch<true>(a, b, out, blocks, iters, s)
            : launch<false>(a, b, out, blocks, iters, s);
}

}  // extern "C"
