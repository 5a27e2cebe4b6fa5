"""Two-plane ternary-weight popcount GEMM with int32 output (torch port of
:mod:`qnx.kernels.ternary_gemm`, kernel C).

Weights in {-1, 0, +1} are two packed planes (mask = nonzero, sign =
positive; :func:`qnx_torch.ops.packing.pack_ternary`), activations packed ±1
sign bits:

    s[m, n] = nnz[n] - 2 * sum_kw popcount(mask[kw, n] & (xp[m, kw] ^ sign[kw, n]))

:func:`ternary_gemm` launches the CUDA kernel of ``csrc/popcount_gemm.cu``
for a CUDA tensor and runs its plain version, :func:`ternary_gemm_ref`, only
for a tensor on the CPU; ``ternary_gemm.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from qnx_torch.ops.packing import WORD, unpack_bits
from . import _build


def ternary_gemm_ref(xp: torch.Tensor, mask: torch.Tensor, sign: torch.Tensor,
                     nnz: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`ternary_gemm`: unpack x to ±1 and the weights to
    {-1, 0, +1}, float32 matmul (exact: integer sums below 2^24).  Over the
    mask's set bits the dot is ``count - 2 * mismatches``, so
    ``s = nnz - count + dot`` for any words, whatever ``nnz`` holds."""
    bits = mask.shape[0] * WORD
    x = unpack_bits(xp, bits, dtype=torch.float32)
    on = (unpack_bits(mask, bits, axis=0, dtype=torch.float32) + 1.0) * 0.5
    w = on * unpack_bits(sign, bits, axis=0, dtype=torch.float32)
    count = on.sum(dim=0).to(torch.int32)
    return (x @ w).to(torch.int32) + (nnz - count)


def check_planes(name: str, xp, mask, sign, nnz) -> None:
    """Shape checks of the ternary operands, shared with the fused wrapper."""
    kw = xp.shape[1]
    if mask.dim() != 2 or mask.shape[0] != kw or sign.shape != mask.shape:
        raise ValueError(f"{name}: mask {tuple(mask.shape)} and sign "
                         f"{tuple(sign.shape)} must both be (Kw={kw}, N)")
    if nnz.shape != (mask.shape[1],):
        raise ValueError(f"{name}: nnz {tuple(nnz.shape)} must be "
                         f"({mask.shape[1]},)")


def ternary_gemm(xp: torch.Tensor, mask: torch.Tensor, sign: torch.Tensor,
                 nnz: torch.Tensor) -> torch.Tensor:
    """Packed ternary GEMM: (M, Kw) x two (Kw, N) planes -> (M, N) int32.

    Args:
      xp:   (M, Kw) int32 packed ±1 activation rows.
      mask, sign: (Kw, N) int32 weight planes packed along K.
      nnz:  (N,) int32 nonzero count of each weight column.
    """
    check_planes("ternary_gemm", xp, mask, sign, nnz)
    if not _build.check_operands("ternary_gemm", xp, mask=mask, sign=sign, nnz=nnz):
        return ternary_gemm_ref(xp, mask, sign, nnz)
    (m, kw), n = xp.shape, mask.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=xp.device)
    if out.numel():
        _build.launch("qnx_ternary_gemm", xp.device, xp, mask, sign, nnz, out,
                      m, kw, n)
        ternary_gemm.launches += 1
    return out


ternary_gemm.launches = 0
