"""Golden torch implementations of the packed binary and ternary GEMMs (port
of :func:`qnx.ops.reference.xnor_gemm_ref` and ``ternary_gemm_ref``): popcount
oracles, independent of the CUDA kernels' unpack-and-matmul plain versions."""
from __future__ import annotations

import torch

from .packing import popcount


def xnor_gemm_ref(xp: torch.Tensor, wp: torch.Tensor, k: int) -> torch.Tensor:
    """Packed binary GEMM: (M, Kw) int32 x (Kw, N) int32 -> (M, N) int32.

    dot[m, n] = k - 2 * sum_kw popcount(xp[m, kw] ^ wp[kw, n])
    where k is the true (unpadded) reduction length.
    """
    mism = torch.sum(popcount(xp[:, :, None] ^ wp[None, :, :]), dim=1,
                     dtype=torch.int32)
    return k - 2 * mism


def ternary_gemm_ref(xp: torch.Tensor, mask: torch.Tensor, sign: torch.Tensor,
                     nnz: torch.Tensor) -> torch.Tensor:
    """Packed ternary-weight GEMM: binary ±1 activations x {-1, 0, +1} weights.

    dot[m, n] = nnz[n] - 2 * sum_kw popcount(mask[kw, n] & (xp[m, kw] ^ sign[kw, n]))
    """
    mism = torch.sum(popcount(mask[None, :, :] & (xp[:, :, None] ^ sign[None, :, :])),
                     dim=1, dtype=torch.int32)
    return nnz[None, :].to(torch.int32) - 2 * mism
