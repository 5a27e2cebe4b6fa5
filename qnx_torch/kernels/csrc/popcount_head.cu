// The integer logit heads by popcount, for Hopper (sm_90a): kernels B, C
// and D's int32 head at the narrow N of a classifier, with the head's float
// affine fused.
//
// Replaces, at the heads, the Pallas kernels qnx/kernels/xnor_gemm.py:
// _xnor_gemm_kernel (:73, kernel B, the binary head PackedDenseLogits),
// qnx/kernels/ternary_gemm.py:_ternary_gemm_kernel (:29, kernel C,
// TernaryDenseLogits) and qnx/kernels/plane_gemm.py:_plane_gemm_kernel
// (:32, kernel D, looped over the planes by PlaneDenseLogits), with what the
// JAX heads leave to XLA around them (the plane sum and a * s + c,
// qnx/nn/inference.py:106, :120, :406):
//
//   B:  s = k - 2 sum_words popc(x ^ w)
//   C:  s = nnz[n] - 2 sum_words popc(mask & (x ^ sign))   (nnz as given)
//   D:  s = sum_j 2^j (2 popc(b_j & msign) - popc(b_j & mask)), P <= 8
//   logits = float((double) a[n] * (double) s + (double) c[n])
//
// B and C at wide N stay popcount_gemm.cu's (the measurement path).
//
// What bounds a head on an H100: nothing of the ALUs.  The MNIST head (256 x
// 4096 x 10) is 0.33 M popc (0.08 us at the measured 4.14e12 popc/s) and
// 128 KB of activations (0.04 us at 3.35 TB/s); a launch costs more.  So it
// is bound by launch and memory latency, and the design cuts the chain of
// dependent steps and fills the card:
// - one warp owns one row and kHeadCols = 16 columns (all of N = 10), so the
//   grid has one warp per row (256 warps at M = 256, 64 blocks of 4; 1, 2
//   or 8 warps a block measured the same), against popcount_gemm.cu's 8
//   blocks with 22 of 32 lanes idle;
// - the Kw words of the row are split over the lanes (lane l takes words l,
//   l + 32, ...: 4 at the MNIST head, 1 at the abits-3 VGG's), each load
//   coalesced; the weights are read K-major, (planes, N, Kw) (the head
//   modules hold that copy, `wt`), so a lane's weight loads are coalesced
//   too;
// - a lane loads kInFlight = 4 words' activations and weights into
//   registers before it adds any, so its loads are in flight together, and
//   D's plane count is a template argument for the served P = 1 and 2 (any
//   P <= 8 runs as P = 0).  In CUDA graph replays at batch 256 (PERF.md
//   section 6) that took the binary MNIST head from 3.4-4.2 us (a loop the
//   compiler unrolled) to 2.5-3.2, and the abits-3 head (P = 2) from
//   4.6-5.2 (a run-time P) to 3.1-3.5; the launch alone takes 0.5-0.8;
// - the lanes' partial sums are reduced by __reduce_add_sync, one per live
//   column; D's planes are summed in registers inside the same warp;
// - the epilogue's constants (k or nnz, a, c) are loaded before the loop, and
//   lane g writes column g: one store of the row's outputs.
// The affine is computed as torch's plain version does it, a float64
// multiply and a float64 add each rounded to nearest (__dmul_rn and
// __dadd_rn are never contracted into an FMA), then one rounding to float32:
// the logits equal the plain version bit for bit.  No atomics: every output
// is summed in one warp in a fixed order.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kLanes = 32;
constexpr unsigned kAllLanes = 0xffffffffu;
constexpr int kHeadCols = 16;   // columns a warp owns
constexpr int kHeadWarps = 4;   // warps a block
constexpr int kHeadPlanes = 8;  // plane_gemm.py MAX_PLANES
constexpr int kInFlight = 4;    // words a lane loads before it adds them

// The operand classes: kX activation words and kW weight words a packed
// word position, the term they add to a column's sum, and s from the sum.
//
// Binary (B): xp (M, Kw), wt (1, N, Kw) the sign plane; s = k - 2 total.
struct XnorHead {
  static constexpr int kX = 1, kW = 1, kScale = -2;
  const unsigned* __restrict__ xp;
  const unsigned* __restrict__ wt;
  int k;

  __device__ __forceinline__ int planes() const { return 1; }
  __device__ __forceinline__ int base(int) const { return k; }
  __device__ __forceinline__ int term(const unsigned (&x)[kX],
                                      const unsigned (&w)[kW], int) const {
    return __popc(x[0] ^ w[0]);
  }
};

// Ternary (C): wt (2, N, Kw) the mask and sign planes; s = nnz - 2 total.
struct TernaryHead {
  static constexpr int kX = 1, kW = 2, kScale = -2;
  const unsigned* __restrict__ xp;
  const unsigned* __restrict__ wt;
  const int* __restrict__ nnz;

  __device__ __forceinline__ int planes() const { return 1; }
  __device__ __forceinline__ int base(int col) const { return __ldg(nnz + col); }
  __device__ __forceinline__ int term(const unsigned (&x)[kX],
                                      const unsigned (&w)[kW], int) const {
    return __popc(w[0] & (x[0] ^ w[1]));
  }
};

// Bit planes (D): xp (P, M, Kw) {0,1} planes, wt (2, N, Kw) the mask and
// msign planes; s = total.  P is known at compile time for the served 1
// and 2 planes; P = 0 takes any P <= kHeadPlanes at run time (the planes
// past p load as 0 and add nothing).  2^j t_j is t_j * (1 << j): t_j may
// be negative.
template <int P>
struct PlaneHead {
  static constexpr int kX = P ? P : kHeadPlanes, kW = 2, kScale = 1;
  const unsigned* __restrict__ xp;
  const unsigned* __restrict__ wt;
  int p;

  __device__ __forceinline__ int planes() const { return P ? P : p; }
  __device__ __forceinline__ int base(int) const { return 0; }
  __device__ __forceinline__ int term(const unsigned (&x)[kX],
                                      const unsigned (&w)[kW], int p) const {
    int t = 0;
#pragma unroll
    for (int j = 0; j < kX; ++j) {
      if (j < p) t += (2 * __popc(x[j] & w[1]) - __popc(x[j] & w[0])) * (1 << j);
    }
    return t;
  }
};

// acc[g] += the terms of the row's words lane, lane + 32, ... for columns
// col0 + g < n.  A lane loads kInFlight words' activations and weights
// (predicated, 0 past the edge) before it adds any of them, so their loads
// are in flight together; it adds only the words it has (at the abits-3
// head's Kw = 32, one a lane) and D's first p planes.
template <class Operands>
__device__ __forceinline__ void accumulate(const Operands& op, long long row,
                                           int col0, int lane, int m, int kw,
                                           int n, int (&acc)[kHeadCols]) {
  const size_t plane = static_cast<size_t>(m) * kw;
  const size_t wplane = static_cast<size_t>(n) * kw;
  const unsigned* x = op.xp + static_cast<size_t>(row) * kw;
  const int p = op.planes();
  for (int i0 = lane; i0 < kw; i0 += kLanes * kInFlight) {
    unsigned xs[kInFlight][Operands::kX];
    unsigned ws[kInFlight][kHeadCols][Operands::kW];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = i0 + u * kLanes;
      const bool live = i < kw;
#pragma unroll
      for (int j = 0; j < Operands::kX; ++j)
        xs[u][j] = live && j < p ? __ldg(x + j * plane + i) : 0u;
#pragma unroll
      for (int g = 0; g < kHeadCols; ++g) {
        const unsigned* w = op.wt + static_cast<size_t>(col0 + g) * kw + i;
#pragma unroll
        for (int q = 0; q < Operands::kW; ++q)
          ws[u][g][q] = live && col0 + g < n ? __ldg(w + q * wplane) : 0u;
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (i0 + u * kLanes >= kw) break;
#pragma unroll
      for (int g = 0; g < kHeadCols; ++g) {
        if (col0 + g < n) acc[g] += op.term(xs[u], ws[u][g], p);
      }
    }
  }
}

// Block (32 * kHeadWarps); warp task t covers row t / groups and columns
// (t % groups) * kHeadCols .. + kHeadCols, groups = ceil(n / kHeadCols).
// Writes int32 s (kLogits false) or float32 logits (M, N).
template <class Operands, bool kLogits>
__global__ void __launch_bounds__(kLanes * kHeadWarps)
popcount_head_kernel(const Operands op, const float* __restrict__ a,
                     const float* __restrict__ c, void* __restrict__ out, int m,
                     int kw, int n) {
  const int lane = threadIdx.x % kLanes;
  const int groups = (n + kHeadCols - 1) / kHeadCols;
  const long long task =
      static_cast<long long>(blockIdx.x) * kHeadWarps + threadIdx.x / kLanes;
  const long long row = task / groups;
  if (row >= m) return;  // the whole warp
  const int col0 = static_cast<int>(task % groups) * kHeadCols;
  const int col = col0 + lane;  // the column this lane stores
  const bool stores = lane < kHeadCols && col < n;
  int base = 0;
  float fa = 0.0f, fc = 0.0f;
  if (stores) {  // issued before the loop, so their latency hides behind it
    base = op.base(col);
    if constexpr (kLogits) {
      fa = __ldg(a + col);
      fc = __ldg(c + col);
    }
  }
  int acc[kHeadCols] = {};
  accumulate(op, row, col0, lane, m, kw, n, acc);
  int total = 0;
#pragma unroll
  for (int g = 0; g < kHeadCols; ++g) {
    if (col0 + g < n) {  // the same for every lane of the warp
      const int sum = __reduce_add_sync(kAllLanes, acc[g]);
      if (lane == g) total = sum;
    }
  }
  if (!stores) return;
  const int s = base + Operands::kScale * total;
  const size_t at = static_cast<size_t>(row) * n + col;
  if constexpr (kLogits) {
    static_cast<float*>(out)[at] = __double2float_rn(__dadd_rn(
        __dmul_rn(static_cast<double>(fa), static_cast<double>(s)),
        static_cast<double>(fc)));
  } else {
    static_cast<int*>(out)[at] = s;
  }
}

// Launch the head over (m, n) outputs: logits where a is given, else s.
template <class Operands>
int launch_head(const Operands& op, const void* a, const void* c, void* out,
                int m, int kw, int n, void* stream) {
  const long long tasks =
      static_cast<long long>(m) * ((n + kHeadCols - 1) / kHeadCols);
  const long long blocks = (tasks + kHeadWarps - 1) / kHeadWarps;
  if (blocks < 1 || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto fa = static_cast<const float*>(a);
  const auto fc = static_cast<const float*>(c);
  if (a != nullptr) {
    popcount_head_kernel<Operands, true><<<grid, kLanes * kHeadWarps, 0, s>>>(
        op, fa, fc, out, m, kw, n);
  } else {
    popcount_head_kernel<Operands, false><<<grid, kLanes * kHeadWarps, 0, s>>>(
        op, fa, fc, out, m, kw, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Plain C entry points, bound with ctypes by qnx_torch/kernels/_build.py.
// wt is the weight planes K-major, (planes, N, Kw) int32; a and c are (N,)
// float32, both null for the int32 s.  Each launches on the given stream,
// does not synchronise, and returns cudaGetLastError() so a refused launch
// is reported at once.

int qnx_xnor_head(const void* xp, const void* wt, const void* a, const void* c,
                  void* out, int m, int kw, int n, int k, void* stream) {
  const XnorHead op{static_cast<const unsigned*>(xp),
                    static_cast<const unsigned*>(wt), k};
  return launch_head(op, a, c, out, m, kw, n, stream);
}

int qnx_ternary_head(const void* xp, const void* wt, const void* nnz,
                     const void* a, const void* c, void* out, int m, int kw,
                     int n, void* stream) {
  const TernaryHead op{static_cast<const unsigned*>(xp),
                       static_cast<const unsigned*>(wt),
                       static_cast<const int*>(nnz)};
  return launch_head(op, a, c, out, m, kw, n, stream);
}

int qnx_plane_head(const void* xp, const void* wt, const void* a, const void* c,
                   void* out, int p, int m, int kw, int n, void* stream) {
  const auto x = static_cast<const unsigned*>(xp);
  const auto w = static_cast<const unsigned*>(wt);
  if (p < 1 || p > kHeadPlanes) return static_cast<int>(cudaErrorInvalidValue);
  if (p == 1) return launch_head(PlaneHead<1>{x, w, p}, a, c, out, m, kw, n, stream);
  if (p == 2) return launch_head(PlaneHead<2>{x, w, p}, a, c, out, m, kw, n, stream);
  return launch_head(PlaneHead<0>{x, w, p}, a, c, out, m, kw, n, stream);
}

}  // extern "C"
