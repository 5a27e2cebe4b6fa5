"""Golden torch implementation of the packed binary GEMM (port of
:func:`qnx.ops.reference.xnor_gemm_ref`): the correctness oracle the CUDA
kernels' plain versions are tested against."""
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
