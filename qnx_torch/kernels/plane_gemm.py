"""Bit-plane GEMM and 3x3 conv with the multi-level threshold epilogue
(torch port of :mod:`qnx.kernels.plane_gemm`, kernel D, and of what the JAX
bit-plane layers leave to XLA around it).

Multi-bit activations decompose as ``x = q * sum_j 2^j b_j`` with ``b_j``
in {0,1} (quantized_relu's level, or quantized_tanh's unsigned index
``u = v + (L - 1)``): P planes, each packed along the channels like sign
bits.  Ternary (or binary) weights are two packed planes, ``mask`` (nonzero)
and ``msign = mask & sign`` (positive).  Per plane

    t_j  = 2 * popcount(b_j & msign) - popcount(b_j & mask)   (= b_j . w)
    s    = sum_j 2^j t_j
    s    = s + corr[y, x, n]                (conv with a border term)
    s    = 2x2 max of s                     (conv with pool)
    lvl  = sum_v [sgn * s >= tau[v]]        (fold_bn_levels thresholds)
    plane j of the output = bit j of lvl, packed along the channels.

Zero pads are b = 0 and add nothing, so the 'SAME' conv over quantized_relu
planes needs no correction (``corr`` None); quantized_tanh's zero pads are
u = 0 where the zero activation is u = L - 1, and ``corr`` (H, W, N), (L - 1)
times the pattern's padding correction, adds back what they leave out.  The
level is nondecreasing in ``sgn * s``, so pooling ``s + corr`` (max, each
pixel's corr added before the pool) and thresholding once equals the JAX
order, corr, threshold, then pool of the levels (the window's min where
sgn < 0), which the plain versions follow with kernel E's epilogue helpers
(``multi_threshold``, ``pool_codes``).  A layer
writes as many planes as it reads.

The JAX layers run one Pallas GEMM per plane and leave the plane sum, the
thresholds, the pool and the plane packing (or the head's affine) to XLA.
Here one CUDA kernel launch does all of it per layer, with three entries:
the conv and the dense layer on the int8 tensor cores
(``csrc/expand_mma_conv.cu``, ``csrc/expand_mma_dense.cu``: the planes
expand to u8 levels and the weight planes to s8 inside the kernel, one
product whatever P), the head by popcount (``csrc/popcount_head.cu``, a
warp a row, the planes summed in registers):

* :func:`plane_conv_fused`: (P, B, H, W, Cw) planes -> (P, B, H', W', Nw);
* :func:`plane_dense_fused`: (P, M, Kw) planes -> (P, M, Nw);
* :func:`plane_head`: (P, M, Kw) planes -> (M, N) int32 s, or float32
  logits ``a * s + c`` (the integer head, ``PlaneDenseLogits``; a 2-D
  (M, Kw) input is one plane); :func:`plane_gemm` is its int32 s on the
  (Kw, N) weights, the JAX ``plane_gemm`` summed over the planes.

Each wrapper launches its kernel for a CUDA tensor and runs its plain
version (``*_ref``: unpack to {0,1} and {-1, 0, +1}, float32 matmul per
plane, exact below 2^24, planes summed in int32) only for a tensor on the
CPU; ``launches`` on each wrapper counts kernel launches.
"""
from __future__ import annotations

import torch

from qnx_torch.ops.packing import WORD, pack_bits, packed_len, unpack_bits
from qnx_torch.ops.reference import bitplane_gemm_ref
from . import _build
from .i8_conv_fused import multi_threshold, pool_codes
from .xnor_conv import extract_packed_patches
from .xnor_conv_fused import card_splits
from .xnor_gemm import affine, check_head, head_out, k_major

# |s| <= K * (2^P - 1) must stay in int32, and the level in P bits
MAX_PLANES = 8


def levels_to_planes(level: torch.Tensor, nbits: int) -> torch.Tensor:
    """(..., C) int32 level indices -> (nbits, ..., Cw) packed {0,1} planes."""
    return torch.stack([pack_bits((level >> j) & 1, axis=-1)
                        for j in range(nbits)], dim=0)


def _weights(mask: torch.Tensor, msign: torch.Tensor) -> torch.Tensor:
    """(Kw, N) planes -> (32*Kw, N) float32 {-1, 0, +1} weights."""
    bits = mask.shape[0] * WORD
    on = (unpack_bits(mask, bits, axis=0, dtype=torch.float32) + 1.0) * 0.5
    pos = (unpack_bits(msign, bits, axis=0, dtype=torch.float32) + 1.0) * 0.5
    return 2.0 * pos - on


def _as_planes(planes: torch.Tensor) -> torch.Tensor:
    return planes[None] if planes.dim() == 2 else planes


def plane_gemm_ref(planes: torch.Tensor, mask: torch.Tensor,
                   msign: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`plane_gemm`: per plane, unpack to {0,1},
    float32 matmul with the {-1, 0, +1} weights (exact: |t| < 2^24), then
    ``s = sum_j 2^j t_j`` in int32."""
    planes = _as_planes(planes)
    w = _weights(mask, msign)
    s = None
    for j in range(planes.shape[0]):
        b = (unpack_bits(planes[j], w.shape[0], dtype=torch.float32) + 1.0) * 0.5
        t = (b @ w).to(torch.int32)
        s = t if s is None else s + t * (1 << j)
    return s


def _check(name: str, planes: torch.Tensor, mask: torch.Tensor,
           msign: torch.Tensor, kw: int) -> int:
    """Shape checks shared by the wrappers; returns P."""
    p = planes.shape[0]
    if not 1 <= p <= MAX_PLANES:
        raise ValueError(f"{name}: {p} planes; 1 to {MAX_PLANES} are taken")
    if mask.dim() != 2 or mask.shape[0] != kw or msign.shape != mask.shape:
        raise ValueError(f"{name}: mask {tuple(mask.shape)} and msign "
                         f"{tuple(msign.shape)} must both be ({kw}, N)")
    return p


def _check_levels(name: str, p: int, n: int, sgn, tau) -> None:
    if sgn.shape != (n,) or tau.dim() != 2 or tau.shape[1] != n:
        raise ValueError(f"{name}: sgn {tuple(sgn.shape)} and tau "
                         f"{tuple(tau.shape)} must be ({n},) and (n_thresh, {n})")
    if not 1 <= tau.shape[0] < 2**p:
        raise ValueError(f"{name}: {tau.shape[0]} thresholds do not fit the "
                         f"levels of {p} planes")


def plane_head_ref(planes: torch.Tensor, mask: torch.Tensor,
                   msign: torch.Tensor, a=None, c=None) -> torch.Tensor:
    """Plain version of :func:`plane_head`: :func:`plane_gemm_ref`, then
    :func:`~qnx_torch.kernels.xnor_gemm.affine` where ``a`` and ``c`` are
    given."""
    s = plane_gemm_ref(planes, mask, msign)
    return s if a is None else affine(a, s, c)


def plane_head(planes: torch.Tensor, mask: torch.Tensor, msign: torch.Tensor,
               a=None, c=None, *, wt=None) -> torch.Tensor:
    """Bit-plane logit head: (M, N) int32 ``s = sum_j 2^j t_j``, or float32
    logits ``a * s + c`` where ``a`` and ``c`` are given, in one launch.

    Args:
      planes: (P, M, Kw) int32 packed {0,1} activation planes, or (M, Kw)
              for one plane.
      mask, msign: (Kw, N) int32 weight planes (msign = mask & sign; bits
              outside the mask count as weight 2, as in the plain version).
      a, c:   (N,) float32 affine, or None for s.
      wt:     ``k_major(mask, msign)``, made once by the caller
              (``PlaneDenseLogits`` holds it); made per call without it.
    """
    x = _as_planes(planes)
    p = _check("plane_head", x, mask, msign, x.shape[-1])
    (_, m, kw), n = x.shape, mask.shape[1]
    if not check_head("plane_head", x, kw, n, 2**p - 1, a, c, wt,
                      {"mask": mask, "msign": msign}):
        return plane_head_ref(x, mask, msign, a, c)
    out = head_out(x, m, n, a)
    if out.numel():
        _build.launch("qnx_plane_head", x.device, x,
                      k_major(mask, msign) if wt is None else wt, a, c, out, p,
                      m, kw, n)
        plane_head.launches += 1
    return out


plane_head.launches = 0


def plane_gemm(planes: torch.Tensor, mask: torch.Tensor,
               msign: torch.Tensor) -> torch.Tensor:
    """Bit-plane GEMM summed over the planes -> (M, N) int32 ``s``: the int32
    epilogue of :func:`plane_head` (its launches count there).

    Args:
      planes: (P, M, Kw) int32 packed {0,1} activation planes, or (M, Kw)
              for one plane.
      mask, msign: (Kw, N) int32 weight planes (msign = mask & sign).
    """
    return plane_head(planes, mask, msign)


def plane_conv(planes: torch.Tensor, mask: torch.Tensor, msign: torch.Tensor,
               kh: int = 3, kw: int = 3) -> torch.Tensor:
    """'SAME' stride-1 conv of P activation planes (plain reference): (P, B,
    H, W, Cw) x (kh*kw*Cw, N) weight planes -> s = sum_j 2^j t_j, (B, H, W, N)
    int32, through the popcount oracle :func:`bitplane_gemm_ref` (exact in
    float32 below 2^24)."""
    p, b, h, w, _ = planes.shape
    patches = torch.stack([extract_packed_patches(planes[j], kh, kw)
                           .reshape(b * h * w, -1) for j in range(p)])
    scales = torch.tensor([float(2**j) for j in range(p)])
    # the oracle forms mask & sign itself, and mask & msign is msign
    s = bitplane_gemm_ref(patches, mask, msign, None, scales,
                          torch.zeros(mask.shape[1]))
    return s.to(torch.int32).reshape(b, h, w, -1)


def plane_conv_fused_ref(planes: torch.Tensor, mask: torch.Tensor,
                         msign: torch.Tensor, sgn: torch.Tensor,
                         tau: torch.Tensor, *, pool: bool = False,
                         corr: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of :func:`plane_conv_fused`, in the JAX order: gather
    3x3 patches of each plane padded with zero words, :func:`plane_gemm_ref`
    over the planes, the border term, the levels, the pool of the levels,
    the planes."""
    p, b, h, w, cw = planes.shape
    patches = torch.stack([extract_packed_patches(planes[j], 3, 3)
                           .reshape(b * h * w, 9 * cw) for j in range(p)])
    s = plane_gemm_ref(patches, mask, msign).reshape(b, h, w, -1)
    if corr is not None:
        s = s + corr
    lvl = multi_threshold(s, sgn, tau)
    if pool:
        lvl = pool_codes(lvl, sgn)
    return levels_to_planes(lvl, p)


def plane_conv_fused(planes: torch.Tensor, mask: torch.Tensor,
                     msign: torch.Tensor, sgn: torch.Tensor, tau: torch.Tensor,
                     *, pool: bool = False,
                     corr: torch.Tensor | None = None) -> torch.Tensor:
    """Fused bit-plane 3x3 'SAME' stride-1 conv (+ border term) + levels
    (+2x2 pool) -> the next layer's planes.

    Args:
      planes: (P, B, H, W, Cw) int32 packed {0,1} activation planes.
      mask, msign: (9*Cw, N) int32 weight planes, tap-major
              (pack_conv_ternary_np; msign = mask & sign).
      sgn:    (N,) int32 threshold direction.
      tau:    (n_thresh, N) int32 ascending thresholds, n_thresh < 2^P.
      pool:   fuse the 2x2/2 max pool (of s + corr, before the levels).
      corr:   (H, W, N) int32 added to each pixel's s (quantized_tanh's
              border term), or None (quantized_relu: no term, no loads).

    Returns:
      (P, B, H', W', ceil(N/32)) int32 planes; H' = H/2, W' = W/2 when pool.
    """
    p, b, h, w, cw = planes.shape
    _check("plane_conv_fused", planes, mask, msign, 9 * cw)
    n = mask.shape[1]
    _check_levels("plane_conv_fused", p, n, sgn, tau)
    if pool and (h % 2 or w % 2):
        raise ValueError(f"plane_conv_fused: pool needs even H and W, got {h}x{w}")
    if corr is not None and tuple(corr.shape) != (h, w, n):
        raise ValueError(f"plane_conv_fused: corr {tuple(corr.shape)} must be "
                         f"({h}, {w}, {n})")
    if not _build.check_operands("plane_conv_fused", planes, mask=mask,
                                 msign=msign, sgn=sgn, tau=tau,
                                 **({} if corr is None else {"corr": corr})):
        return plane_conv_fused_ref(planes, mask, msign, sgn, tau, pool=pool,
                                    corr=corr)
    ho, wo = (h // 2, w // 2) if pool else (h, w)
    out = torch.empty((p, b, ho, wo, packed_len(n)), dtype=torch.int32,
                      device=planes.device)
    if out.numel():
        _build.launch("qnx_plane_conv3x3_fused", planes.device, planes, mask,
                      msign, corr, sgn, tau, out, p, b, h, w, cw, n,
                      tau.shape[0], int(pool))
        plane_conv_fused.launches += 1
    return out


plane_conv_fused.launches = 0


def plane_dense_fused_ref(planes: torch.Tensor, mask: torch.Tensor,
                          msign: torch.Tensor, sgn: torch.Tensor,
                          tau: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`plane_dense_fused`: :func:`plane_gemm_ref`,
    the levels, the planes."""
    lvl = multi_threshold(plane_gemm_ref(planes, mask, msign), sgn, tau)
    return levels_to_planes(lvl, planes.shape[0])


def plane_dense_fused(planes: torch.Tensor, mask: torch.Tensor,
                      msign: torch.Tensor, sgn: torch.Tensor,
                      tau: torch.Tensor) -> torch.Tensor:
    """Fused bit-plane dense + levels -> (P, M, ceil(N/32)) int32 planes.

    Args:
      planes: (P, M, Kw) int32 packed {0,1} activation planes.
      mask, msign: (Kw, N) int32 weight planes (msign = mask & sign).
      sgn, tau: (N,) and (n_thresh, N) int32 thresholds, n_thresh < 2^P.
    """
    p, m, kw = planes.shape
    _check("plane_dense_fused", planes, mask, msign, kw)
    n = mask.shape[1]
    _check_levels("plane_dense_fused", p, n, sgn, tau)
    if not _build.check_operands("plane_dense_fused", planes, mask=mask,
                                 msign=msign, sgn=sgn, tau=tau):
        return plane_dense_fused_ref(planes, mask, msign, sgn, tau)
    out = torch.empty((p, m, packed_len(n)), dtype=torch.int32,
                      device=planes.device)
    if out.numel():
        _build.launch("qnx_plane_dense_fused", planes.device, planes, mask,
                      msign, sgn, tau, out, p, m, kw, n, tau.shape[0],
                      card_splits(planes.device, m, n, kw))
        plane_dense_fused.launches += 1
    return out


plane_dense_fused.launches = 0
