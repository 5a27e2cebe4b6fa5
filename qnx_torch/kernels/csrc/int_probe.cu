// Integer issue-rate probe for Hopper (sm_90a): chains of 32-bit integer
// steps, one element per thread.  Replaces the Pallas kernel of
// experiments/vpu_probe.py:chain (H), which measures the TPU's VPU:
//
//   acc = 0; repeat REPS times { acc = step(acc, x, y); x = x + 1 }; out = acc
//
// with the six steps of that file (MODE, in the order of enum Mode below):
//   xor     acc ^= x ^ y                 add     acc += x ^ y
//   mul     acc = acc * x + y            pc      acc += popc(x ^ y)
//   pconly  acc = popc(acc ^ x)          csa     a = x ^ acc; u = acc ^ a;
//                                                c = acc & a; acc = (u ^ y) | c
//
// Arithmetic is unsigned, so it wraps as the int32 JAX ops do.  The per-step
// x + 1 keeps the compiler from folding or hoisting the chain: each step
// reads a new x, and the REPS steps are unrolled in full, so the SASS of a
// build has REPS of the step's instructions per element (count them with
// `cuobjdump -sass`, as qnx_torch.experiments.vpu_probe does).  Timing REPS
// = 96 against REPS = 32 (the JAX file's) and 384 against 128, and
// differencing, strips the launch and the loads.  A probe, not a fast
// kernel: bound by the larger of its bytes (12 an element) and the issue of
// its steps' instructions (popc 16 per clock per SM at compute capability
// 9.0, LOP3 and IADD3 64).  At 32 steps the cheapest mode, xor (one LOP3
// and one IADD3 a step), issues for less time than its bytes take, so its
// 96 - 32 difference measures memory; at 128 steps and more its issue takes
// about four times its bytes' time, which the 384 - 128 difference reads.
#include <cuda_runtime.h>

namespace {

enum Mode { kXor = 0, kAdd, kMul, kPc, kPconly, kCsa };
constexpr int kBlock = 256;

template <int MODE, int REPS>
__global__ void __launch_bounds__(kBlock)
int_chain_kernel(const unsigned* __restrict__ x, const unsigned* __restrict__ y,
                 unsigned* __restrict__ out, int count) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= count) return;
  unsigned xv = __ldg(x + i);
  const unsigned yv = __ldg(y + i);
  unsigned acc = 0u;
#pragma unroll
  for (int r = 0; r < REPS; ++r) {
    if constexpr (MODE == kXor) {
      acc ^= xv ^ yv;
    } else if constexpr (MODE == kAdd) {
      acc += xv ^ yv;
    } else if constexpr (MODE == kMul) {
      acc = acc * xv + yv;
    } else if constexpr (MODE == kPc) {
      acc += __popc(xv ^ yv);
    } else if constexpr (MODE == kPconly) {
      acc = __popc(acc ^ xv);
    } else {
      const unsigned a = xv ^ acc;
      const unsigned u = acc ^ a;
      const unsigned c = acc & a;
      acc = (u ^ yv) | c;
    }
    xv += 1u;
  }
  out[i] = acc;
}

template <int REPS>
cudaError_t launch_chain(int mode, const unsigned* x, const unsigned* y,
                         unsigned* out, int count, cudaStream_t stream) {
  const dim3 grid((count + kBlock - 1) / kBlock);
  switch (mode) {
    case kXor: int_chain_kernel<kXor, REPS><<<grid, kBlock, 0, stream>>>(x, y, out, count); break;
    case kAdd: int_chain_kernel<kAdd, REPS><<<grid, kBlock, 0, stream>>>(x, y, out, count); break;
    case kMul: int_chain_kernel<kMul, REPS><<<grid, kBlock, 0, stream>>>(x, y, out, count); break;
    case kPc: int_chain_kernel<kPc, REPS><<<grid, kBlock, 0, stream>>>(x, y, out, count); break;
    case kPconly: int_chain_kernel<kPconly, REPS><<<grid, kBlock, 0, stream>>>(x, y, out, count); break;
    case kCsa: int_chain_kernel<kCsa, REPS><<<grid, kBlock, 0, stream>>>(x, y, out, count); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Plain C entry point, bound with ctypes by qnx_torch/kernels/_build.py.
// mode indexes MODES of qnx_torch/kernels/int_probe.py; reps is one of the
// compiled chain lengths (1, 32, 96, 128, 384).  Launches on the given stream, does not
// synchronise, returns cudaGetLastError() (cudaErrorInvalidValue for a mode
// or length that is not compiled in).
int qnx_int_chain(const void* x, const void* y, void* out, int count, int mode,
                  int reps, void* stream) {
  const auto* xu = static_cast<const unsigned*>(x);
  const auto* yu = static_cast<const unsigned*>(y);
  auto* ou = static_cast<unsigned*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (reps == 1) return launch_chain<1>(mode, xu, yu, ou, count, s);
  if (reps == 32) return launch_chain<32>(mode, xu, yu, ou, count, s);
  if (reps == 96) return launch_chain<96>(mode, xu, yu, ou, count, s);
  if (reps == 128) return launch_chain<128>(mode, xu, yu, ou, count, s);
  if (reps == 384) return launch_chain<384>(mode, xu, yu, ou, count, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
