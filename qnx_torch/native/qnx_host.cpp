// qnx_torch host-side native runtime (a copy of qnx/native/qnx_host.cpp with
// the same C ABI): image normalization, bit-packing, and a popcount-GEMM
// oracle, multithreaded C++ exposed through a plain C ABI (loaded via
// ctypes by hostlib.py).
//
// Role: the card owns all model math; the host owns the serving data
// plane — normalizing image streams and packing bits for debug/converter
// paths. Those are the CPU-bound steps of the continuous-batching feeder
// (qnx_torch.serve.engine), so they are implemented natively.
//
// Build with no -ffast-math: qnx_u8_to_f32 relies on std::fmaf rounding
// once.
//
// Layout contracts mirror qnx_torch/ops/packing.py exactly:
//   * bit j of word kw holds element k = kw*32 + j (LSB-first),
//   * bit 1 encodes +1 (strict x > 0), bit 0 encodes -1,
//   * reduction axis zero-padded to a word multiple with 0-bits.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

int hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n ? static_cast<int>(n) : 4;
}

// Split [0, n) into chunks and run fn(begin, end) on a small thread pool.
template <typename F>
void parallel_for(int64_t n, F fn, int64_t grain = 1 << 14) {
  int nt = std::min<int64_t>(hw_threads(), std::max<int64_t>(1, n / grain));
  if (nt <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t b = t * chunk, e = std::min<int64_t>(n, b + chunk);
    if (b >= e) break;
    ts.emplace_back([=] { fn(b, e); });
  }
  for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

// uint8 [0,255] -> float32 [-1,1]: the reference's load-time scaling
// ("arrays scaled to [-1, 1]"), done per-request on the serving host.
// dst = src * f32(1/127.5) - 1, rounded once: an explicit fused
// multiply-add, so the value does not depend on whether the compiler
// contracts a multiply and a subtract.  It equals the device path's
// normalize_u8 (float64 product and difference, rounded to float32) bit
// for bit on all 256 inputs.
void qnx_u8_to_f32(const uint8_t* src, float* dst, int64_t n) {
  parallel_for(n, [=](int64_t b, int64_t e) {
    constexpr float kScale = 1.0f / 127.5f;
    for (int64_t i = b; i < e; ++i)
      dst[i] = std::fmaf(static_cast<float>(src[i]), kScale, -1.0f);
  });
}

// Sign-pack float rows along K (row-major (rows, k) -> (rows, kw) int32).
void qnx_pack_bits_f32(const float* src, int64_t rows, int64_t k,
                       int32_t* dst) {
  int64_t kw = (k + 31) / 32;
  parallel_for(rows, [=](int64_t rb, int64_t re) {
    for (int64_t r = rb; r < re; ++r) {
      const float* x = src + r * k;
      uint32_t* out = reinterpret_cast<uint32_t*>(dst) + r * kw;
      for (int64_t w = 0; w < kw; ++w) {
        uint32_t word = 0;
        int64_t lim = std::min<int64_t>(32, k - w * 32);
        for (int64_t j = 0; j < lim; ++j)
          word |= static_cast<uint32_t>(x[w * 32 + j] > 0.0f) << j;
        out[w] = word;
      }
    }
  }, /*grain=*/64);
}

// Ternary two-plane pack: mask bit = nonzero, sign bit = (> 0); also counts
// nonzeros per row. src row-major (rows, k); planes (rows, kw).
void qnx_pack_ternary_f32(const float* src, int64_t rows, int64_t k,
                          int32_t* mask, int32_t* sign, int32_t* nnz) {
  int64_t kw = (k + 31) / 32;
  parallel_for(rows, [=](int64_t rb, int64_t re) {
    for (int64_t r = rb; r < re; ++r) {
      const float* x = src + r * k;
      uint32_t* m = reinterpret_cast<uint32_t*>(mask) + r * kw;
      uint32_t* s = reinterpret_cast<uint32_t*>(sign) + r * kw;
      int32_t cnt = 0;
      for (int64_t w = 0; w < kw; ++w) {
        uint32_t mw = 0, sw = 0;
        int64_t lim = std::min<int64_t>(32, k - w * 32);
        for (int64_t j = 0; j < lim; ++j) {
          float v = x[w * 32 + j];
          mw |= static_cast<uint32_t>(v != 0.0f) << j;
          sw |= static_cast<uint32_t>(v > 0.0f) << j;
          cnt += v != 0.0f;
        }
        m[w] = mw;
        s[w] = sw;
      }
      nnz[r] = cnt;
    }
  }, /*grain=*/64);
}

// XNOR-popcount GEMM oracle: xp (M, kw) row-major, wpT (N, kw) row-major
// (weights TRANSPOSED for contiguous reduction), out (M, N) int32,
// out[m,n] = k - 2 * sum_w popcount(xp[m,w] ^ wpT[n,w]).
// Host-side independent cross-check of the device kernels.
void qnx_xnor_gemm(const int32_t* xp, const int32_t* wpT, int32_t* out,
                   int64_t m, int64_t n, int64_t kw, int32_t k) {
  const uint32_t* x = reinterpret_cast<const uint32_t*>(xp);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(wpT);
  parallel_for(m, [=](int64_t mb, int64_t me) {
    for (int64_t i = mb; i < me; ++i) {
      for (int64_t j = 0; j < n; ++j) {
        int32_t mism = 0;
        const uint32_t* xr = x + i * kw;
        const uint32_t* wr = w + j * kw;
        for (int64_t t = 0; t < kw; ++t)
          mism += __builtin_popcount(xr[t] ^ wr[t]);
        out[i * n + j] = k - 2 * mism;
      }
    }
  }, /*grain=*/4);
}

int32_t qnx_host_abi_version() { return 1; }

}  // extern "C"
