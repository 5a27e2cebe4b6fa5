"""Fused packed XNOR-popcount dense and 3x3 conv with the integer threshold
epilogue (torch port of :mod:`qnx.kernels.xnor_conv_fused`, binary branch).

    s    = K - 2 * sum_kw popcount(x ^ w)       (+-1 dot product)
    s   += corr[h, w, n]                        (conv: zero-pad correction)
    s    = 2x2 max of s                         (conv with pool)
    bit  = sgn * s >= tau                       (per-channel folded BN)

Unlike the JAX wrappers, which return int8 codes for XLA to pool and repack,
these return the packed output words, ``pack_bits`` of the codes along the
channel axis: the CUDA kernels (``csrc/xnor_fused.cu``) gather the conv
patches, pool and repack themselves.

Each wrapper launches its CUDA kernel for a CUDA tensor and runs its plain
version (``*_ref``) only for a tensor on the CPU.  ``launches`` on each
wrapper counts kernel launches, so a run can show that it went through the
kernels.
"""
from __future__ import annotations

import ctypes

import torch

from qnx_torch.ops.packing import WORD, pack_bits, unpack_bits
from . import _build
from .xnor_conv import extract_packed_patches


def _check(name: str, xp, wp, sgn, tau, corr=None) -> None:
    """Device, dtype, contiguity and shape checks shared by both paths."""
    n = wp.shape[1]
    tensors = {"xp": xp, "wp": wp, "sgn": sgn, "tau": tau}
    if corr is not None:
        tensors["corr"] = corr
    for arg, t in tensors.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {arg} must be int32, got {t.dtype}")
        if t.device != xp.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, xp on {xp.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if sgn.shape != (n,) or tau.shape != (n,):
        raise ValueError(f"{name}: sgn {tuple(sgn.shape)} and tau "
                         f"{tuple(tau.shape)} must be ({n},)")
    if n % WORD:
        raise ValueError(f"{name}: output channels {n} must be a multiple of "
                         f"{WORD} (one packed word per 32 channels)")


def _dot_to_s(dot: torch.Tensor, kw: int, k: int) -> torch.Tensor:
    """±1 dot over all 32*kw unpacked bits -> s over the true k.  Padding bits
    are 0 in both operands; each decodes to -1 and adds +1 to the dot."""
    return dot.to(torch.int32) - (WORD * kw - k)


def _threshold_pack(s: torch.Tensor, sgn: torch.Tensor,
                    tau: torch.Tensor) -> torch.Tensor:
    return pack_bits((sgn * s >= tau).to(torch.int8), axis=-1)


def _launch(fn_name: str, *args) -> None:
    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream
    code = getattr(lib, fn_name)(*args, ctypes.c_void_p(stream))
    _build.check(lib, fn_name, code)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


# ---------------------------------------------------------------------------
# dense: (M, Kw) x (Kw, N) -> (M, N/32) packed words
# ---------------------------------------------------------------------------

def xnor_gemm_fused_ref(xp: torch.Tensor, wp: torch.Tensor, k: int,
                        sgn: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`xnor_gemm_fused`: unpack to ±1, float32
    matmul (exact: integer sums below 2^24), threshold, pack."""
    kw = wp.shape[0]
    x = unpack_bits(xp, kw * WORD, dtype=torch.float32)
    w = unpack_bits(wp, kw * WORD, axis=0, dtype=torch.float32)
    return _threshold_pack(_dot_to_s(x @ w, kw, k), sgn, tau)


def xnor_gemm_fused(xp: torch.Tensor, wp: torch.Tensor, k: int,
                    sgn: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """Fused packed binary GEMM + threshold -> (M, N/32) int32 packed words.

    Args:
      xp:  (M, Kw) int32 packed activation rows.
      wp:  (Kw, N) int32 packed weights (packed along the reduction axis).
      k:   true reduction length.
      sgn, tau: (N,) int32 threshold direction / integer threshold.
    """
    m, kw = xp.shape
    if wp.shape[0] != kw:
        raise ValueError(f"xnor_gemm_fused: xp {tuple(xp.shape)} and wp "
                         f"{tuple(wp.shape)} disagree on Kw")
    _check("xnor_gemm_fused", xp, wp, sgn, tau)
    n = wp.shape[1]
    if xp.is_cuda:
        out = torch.empty((m, n // WORD), dtype=torch.int32, device=xp.device)
        with torch.cuda.device(xp.device):
            _launch("qnx_xnor_dense_fused", _ptr(xp), _ptr(wp), _ptr(sgn),
                    _ptr(tau), _ptr(out), m, kw, n, k)
        xnor_gemm_fused.launches += 1
        return out
    if xp.device.type != "cpu":
        raise ValueError(f"xnor_gemm_fused: no kernel for device {xp.device}")
    return xnor_gemm_fused_ref(xp, wp, k, sgn, tau)


xnor_gemm_fused.launches = 0


# ---------------------------------------------------------------------------
# conv: (B, H, W, Cw) x (9*Cw, N) -> (B, H', W', N/32) packed words
# ---------------------------------------------------------------------------

def xnor_conv_fused_ref(xp: torch.Tensor, wp: torch.Tensor, k: int,
                        corr: torch.Tensor, sgn: torch.Tensor,
                        tau: torch.Tensor, *, pool: bool = False) -> torch.Tensor:
    """Plain version of :func:`xnor_conv_fused`: gather 3x3 patches padded
    with zero words (= -1 bits), unpack to ±1, float32 matmul, + corr,
    2x2 max of s, threshold, pack."""
    b, h, w, cw = xp.shape
    n = wp.shape[1]
    patches = extract_packed_patches(xp, 3, 3).reshape(b * h * w, 9 * cw)
    x = unpack_bits(patches, 9 * cw * WORD, dtype=torch.float32)
    wv = unpack_bits(wp, 9 * cw * WORD, axis=0, dtype=torch.float32)
    s = _dot_to_s(x @ wv, 9 * cw, k).reshape(b, h, w, n) + corr[None]
    if pool:
        s = s.reshape(b, h // 2, 2, w // 2, 2, n).amax(dim=(2, 4))
    return _threshold_pack(s, sgn, tau)


def xnor_conv_fused(xp: torch.Tensor, wp: torch.Tensor, k: int,
                    corr: torch.Tensor, sgn: torch.Tensor, tau: torch.Tensor,
                    *, pool: bool = False) -> torch.Tensor:
    """Fused packed binary 3x3 'SAME' stride-1 conv + threshold (+2x2 pool).

    Args:
      xp:   (B, H, W, Cw) int32 channel-packed sign bits.
      wp:   (9*Cw, N) int32 packed weights, tap-major (pack_conv_weights_np).
      k:    true reduction length (9 * C_in).
      corr: (H, W, N) int32 zero-pad correction (padding_correction).
      sgn, tau: (N,) int32 threshold direction / integer threshold.
      pool: fuse the 2x2/2 max pool (of s, before the threshold).

    Returns:
      (B, H', W', N/32) int32 packed words; H' = H/2, W' = W/2 when pool.
    """
    b, h, w, cw = xp.shape
    n = wp.shape[1]
    if wp.shape[0] != 9 * cw:
        raise ValueError(f"xnor_conv_fused: wp {tuple(wp.shape)} must be "
                         f"(9*Cw, N) for xp {tuple(xp.shape)}")
    if corr.shape != (h, w, n):
        raise ValueError(f"xnor_conv_fused: corr {tuple(corr.shape)} must be "
                         f"{(h, w, n)}")
    if pool and (h % 2 or w % 2):
        raise ValueError(f"xnor_conv_fused: pool needs even H and W, got {h}x{w}")
    _check("xnor_conv_fused", xp, wp, sgn, tau, corr)
    if xp.is_cuda:
        ho, wo = (h // 2, w // 2) if pool else (h, w)
        out = torch.empty((b, ho, wo, n // WORD), dtype=torch.int32,
                          device=xp.device)
        with torch.cuda.device(xp.device):
            _launch("qnx_xnor_conv3x3_fused", _ptr(xp), _ptr(wp), _ptr(corr),
                    _ptr(sgn), _ptr(tau), _ptr(out), b, h, w, cw, n, k,
                    int(pool))
        xnor_conv_fused.launches += 1
        return out
    if xp.device.type != "cpu":
        raise ValueError(f"xnor_conv_fused: no kernel for device {xp.device}")
    return xnor_conv_fused_ref(xp, wp, k, corr, sgn, tau, pool=pool)


xnor_conv_fused.launches = 0
