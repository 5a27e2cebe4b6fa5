"""Two-plane ternary-weight popcount GEMM with int32 output (torch port of
:mod:`qnx.kernels.ternary_gemm`, kernel C).

Weights in {-1, 0, +1} are two packed planes (mask = nonzero, sign =
positive; :func:`qnx_torch.ops.packing.pack_ternary`), activations packed ±1
sign bits:

    s[m, n] = nnz[n] - 2 * sum_kw popcount(mask[kw, n] & (xp[m, kw] ^ sign[kw, n]))

Two wrappers launch two CUDA kernels: :func:`ternary_gemm`, the GEMM of
``csrc/popcount_gemm.cu`` at wide N (the measurement path) on the
single-bit tensor cores, ``s = nnz - 2 P_m - 2 c_ms + 4 P_ms`` with P_m,
P_ms the AND-popcount products of x against mask and against mask & sign
and c_ms the column popcount of mask & sign, and
:func:`ternary_head`, ``csrc/popcount_head.cu``'s ternary logit head
(``TernaryDenseLogits``: int32 s or the logits ``a * s + c`` in one launch,
on the weight planes K-major).  Each launches its kernel for a CUDA tensor
and runs its plain version (``*_ref``) only for a tensor on the CPU;
``launches`` on each counts kernel launches.
"""
from __future__ import annotations

import torch

from qnx_torch.ops.packing import WORD, unpack_bits
from . import _build
from .xnor_gemm import affine, check_and_products, check_head, head_out, k_major


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
    check_and_products("ternary_gemm", xp.shape[1])
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


def ternary_head_ref(xp: torch.Tensor, mask: torch.Tensor, sign: torch.Tensor,
                     nnz: torch.Tensor, a=None, c=None) -> torch.Tensor:
    """Plain version of :func:`ternary_head`: :func:`ternary_gemm_ref`, then
    :func:`~qnx_torch.kernels.xnor_gemm.affine` where ``a`` and ``c`` are
    given."""
    s = ternary_gemm_ref(xp, mask, sign, nnz)
    return s if a is None else affine(a, s, c)


def ternary_head(xp: torch.Tensor, mask: torch.Tensor, sign: torch.Tensor,
                 nnz: torch.Tensor, a=None, c=None, *, wt=None) -> torch.Tensor:
    """Ternary logit head: (M, N) int32 s, or float32 logits ``a * s + c``
    where ``a`` and ``c`` are given, in one launch.

    Args:
      xp:   (M, Kw) int32 packed ±1 activation rows.
      mask, sign: (Kw, N) int32 weight planes packed along K.
      nnz:  (N,) int32 base of each column (its nonzero count; taken as
            given).
      a, c: (N,) float32 affine, or None for s.
      wt:   ``k_major(mask, sign)``, made once by the caller
            (``TernaryDenseLogits`` holds it); made per call without it.
    """
    check_planes("ternary_head", xp, mask, sign, nnz)
    (m, kw), n = xp.shape, mask.shape[1]
    if not check_head("ternary_head", xp, kw, n, 1, a, c, wt,
                      {"mask": mask, "sign": sign}, nnz=nnz):
        return ternary_head_ref(xp, mask, sign, nnz, a, c)
    out = head_out(xp, m, n, a)
    if out.numel():
        _build.launch("qnx_ternary_head", xp.device, xp,
                      k_major(mask, sign) if wt is None else wt, nnz, a, c, out,
                      m, kw, n)
        ternary_head.launches += 1
    return out


ternary_head.launches = 0
