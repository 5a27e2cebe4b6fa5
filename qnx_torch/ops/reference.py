"""Golden torch implementations of the packed binary, ternary and bit-plane
GEMMs (port of :mod:`qnx.ops.reference`): popcount oracles, independent of
the CUDA kernels' unpack-and-matmul plain versions."""
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


def bitplane_gemm_ref(planes: torch.Tensor, mask: torch.Tensor,
                      sign: torch.Tensor, nnz: torch.Tensor,
                      scales: torch.Tensor,
                      offset_weight_sum: torch.Tensor) -> torch.Tensor:
    """Multi-bit activations x ternary/binary weights via bit-plane expansion.

    Activations are ``x = offset + sum_p scales[p] * b_p`` with ``b_p`` in
    {0,1} packed per plane; for a ternary weight column
    ``dot = offset * sum(w) + sum_p scales[p] * (2*popcount(b_p & mask & sign)
    - popcount(b_p & mask))``.

    planes: (P, M, Kw) packed {0,1} planes; scales: (P,) float;
    offset_weight_sum: (N,) = offset * sum_k w[k, n].  ``nnz`` is unused, as
    in the JAX oracle.  Returns float32 (M, N).
    """
    del nnz
    pos = torch.sum(popcount(planes[:, :, :, None] & (mask & sign)[None, None]),
                    dim=2, dtype=torch.int32)  # (P, M, N): b_p = 1, w = +1
    tot = torch.sum(popcount(planes[:, :, :, None] & mask[None, None]),
                    dim=2, dtype=torch.int32)  # (P, M, N): b_p = 1, w != 0
    per_plane = (2 * pos - tot).to(torch.float32)  # sum_k b_p * w
    acc = torch.einsum("pmn,p->mn", per_plane, scales.to(torch.float32))
    return acc + offset_weight_sum[None, :].to(torch.float32)
