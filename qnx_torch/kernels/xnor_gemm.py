"""Packed binary popcount GEMM with int32 output (torch port of
:mod:`qnx.kernels.xnor_gemm`, kernel B):

    s[m, n] = k - 2 * sum_kw popcount(xp[m, kw] ^ wp[kw, n])

with k the true (unpadded) reduction length; pad bits are 0 in both
operands, so they XOR to 0.  :func:`xnor_gemm_popcount` launches the CUDA
kernel of ``csrc/popcount_gemm.cu`` for a CUDA tensor and runs its plain
version, :func:`xnor_gemm_popcount_ref`, only for a tensor on the CPU;
``xnor_gemm_popcount.launches`` counts kernel launches.  The JAX module's
``default_blocks`` and ``check_block_shape`` are TPU tiling rules and have no
counterpart here.
"""
from __future__ import annotations

import torch

from qnx_torch.ops.packing import WORD, unpack_bits
from . import _build


def _dot_to_s(dot: torch.Tensor, kw: int, k: int) -> torch.Tensor:
    """±1 dot over all 32*kw unpacked bits -> s over the true k.  Padding bits
    are 0 in both operands; each decodes to -1 and adds +1 to the dot."""
    return dot.to(torch.int32) - (WORD * kw - k)


def xnor_gemm_popcount_ref(xp: torch.Tensor, wp: torch.Tensor,
                           k: int) -> torch.Tensor:
    """Plain version of :func:`xnor_gemm_popcount`: unpack to ±1, float32
    matmul (exact: integer sums below 2^24), pad-bit correction."""
    kw = wp.shape[0]
    x = unpack_bits(xp, kw * WORD, dtype=torch.float32)
    w = unpack_bits(wp, kw * WORD, axis=0, dtype=torch.float32)
    return _dot_to_s(x @ w, kw, k)


def xnor_gemm_popcount(xp: torch.Tensor, wp: torch.Tensor, k: int) -> torch.Tensor:
    """Packed binary GEMM -> (M, N) int32 exact ±1 dot products.

    Args:
      xp: (M, Kw) int32 activations packed along K (``pack_bits(x, -1)``).
      wp: (Kw, N) int32 weights packed along K (``pack_bits(w, 0)``).
      k:  true (unpadded) reduction length.
    """
    m, kw = xp.shape
    if wp.dim() != 2 or wp.shape[0] != kw:
        raise ValueError(f"xnor_gemm_popcount: xp {tuple(xp.shape)} and wp "
                         f"{tuple(wp.shape)} disagree on Kw")
    n = wp.shape[1]
    if not _build.check_operands("xnor_gemm_popcount", xp, wp=wp):
        return xnor_gemm_popcount_ref(xp, wp, k)
    out = torch.empty((m, n), dtype=torch.int32, device=xp.device)
    if out.numel():
        _build.launch("qnx_xnor_gemm_popcount", xp.device, xp, wp, out, m, kw, n, k)
        xnor_gemm_popcount.launches += 1
    return out


xnor_gemm_popcount.launches = 0


def xnor_gemm(xp: torch.Tensor, wp: torch.Tensor, k: int,
              strategy: str = "popcount") -> torch.Tensor:
    """Strategy dispatcher of :func:`qnx.kernels.xnor_gemm.xnor_gemm`, a torch
    reference for comparisons from the same packed words: ``popcount`` runs
    :func:`xnor_gemm_popcount`; ``int8`` unpacks to ±1 and runs a dense
    matmul (float32, exact for integer sums below 2^24), paying for the
    unpack as the JAX strategy does."""
    if strategy == "popcount":
        return xnor_gemm_popcount(xp, wp, k)
    if strategy == "int8":
        x = unpack_bits(xp, k, axis=-1, dtype=torch.float32)
        w = unpack_bits(wp, k, axis=0, dtype=torch.float32)
        return (x @ w).to(torch.int32)
    raise ValueError(f"unknown strategy {strategy!r} for packed inputs")
