"""Fused packed binary and ternary dense and 3x3 conv with the integer threshold
epilogue (torch port of :mod:`qnx.kernels.xnor_conv_fused`: the binary and
the ternary branch, dense and conv), and the binary conv with a residual
epilogue (:func:`xnor_conv_residual`, Bi-Real Net's block; the JAX package
has none).

    s    = K - 2 * sum_kw popcount(x ^ w)       (±1 dot product)
    s    = nnz - 2 * sum_kw popcount(mask & (x ^ sign))   (ternary weights)
    s   += corr[h, w, n]                        (conv: zero-pad correction)
    s    = 2x2 max of s                         (conv with pool)
    bit  = sgn * s >= tau                       (per-channel folded BN)

Unlike the JAX wrappers, which return int8 codes for XLA to pool and repack,
these return the packed output words, ``pack_bits`` of the codes along the
channel axis, (..., ceil(N/32)) with the pad bits of the last word 0: the
CUDA kernels gather the conv patches, pool and repack themselves.  Any N is
allowed.  All four run on the int8 tensor cores, the bits and weight planes
expanded to s8 inside the kernel: the convs in ``csrc/expand_mma_conv.cu``,
the dense layers in ``csrc/expand_mma_dense.cu``, whose K is split over the
blocks of a cluster (:func:`dense_splits`).

Each wrapper launches its CUDA kernel for a CUDA tensor and runs its plain
version (``*_ref``) only for a tensor on the CPU.  ``launches`` on each
wrapper counts kernel launches, so a run can show that it went through the
kernels.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from qnx_torch.ops.packing import pack_bits, packed_len, unpack_bits
from . import _build
from .ternary_gemm import check_planes, ternary_gemm_ref
from .xnor_conv import extract_packed_patches
from .xnor_gemm import xnor_gemm_popcount_ref


def _check_epilogue(name: str, n: int, sgn, tau) -> None:
    if sgn.shape != (n,) or tau.shape != (n,):
        raise ValueError(f"{name}: sgn {tuple(sgn.shape)} and tau "
                         f"{tuple(tau.shape)} must be ({n},)")


def _threshold_pack(s: torch.Tensor, sgn: torch.Tensor,
                    tau: torch.Tensor) -> torch.Tensor:
    return pack_bits((sgn * s >= tau).to(torch.int8), axis=-1)


# ---------------------------------------------------------------------------
# dense: (M, Kw) x (Kw, N) -> (M, ceil(N/32)) packed words
# ---------------------------------------------------------------------------

# csrc/expand_mma_dense.cu: a tile's rows and channels, the most blocks of
# a cluster, and the fewest K steps a split leaves each block
DENSE_TILE = 128
MAX_SPLITS = 8
MIN_SPLIT_STEPS = 2


def dense_splits(m: int, n: int, kw: int, sms: int) -> int:
    """The blocks of a cluster that share one output tile of the dense
    kernels (``csrc/expand_mma_dense.cu``), each summing its share of the K
    steps: the largest power of two up to :data:`MAX_SPLITS` that keeps the
    blocks within one wave of the card's ``sms`` and leaves each block at
    least :data:`MIN_SPLIT_STEPS` of the K steps (4 words a step where Kw %
    4 == 0, else 1)."""
    tiles = -(-m // DENSE_TILE) * -(-n // DENSE_TILE)
    steps = kw // 4 if kw % 4 == 0 else kw
    splits = 1
    while (splits < MAX_SPLITS and 2 * splits * tiles <= sms
           and 2 * splits * MIN_SPLIT_STEPS <= steps):
        splits *= 2
    return splits


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def card_splits(device: torch.device, m: int, n: int, kw: int) -> int:
    """:func:`dense_splits` on the card that holds the operands."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return dense_splits(m, n, kw, _sms(index))

def xnor_gemm_fused_ref(xp: torch.Tensor, wp: torch.Tensor, k: int,
                        sgn: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`xnor_gemm_fused`: unpack to ±1, float32
    matmul (exact: integer sums below 2^24), threshold, pack."""
    return _threshold_pack(xnor_gemm_popcount_ref(xp, wp, k), sgn, tau)


def xnor_gemm_fused(xp: torch.Tensor, wp: torch.Tensor, k: int,
                    sgn: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """Fused packed binary GEMM + threshold -> (M, ceil(N/32)) int32 words.

    Args:
      xp:  (M, Kw) int32 packed activation rows.
      wp:  (Kw, N) int32 packed weights (packed along the reduction axis).
      k:   true reduction length.
      sgn, tau: (N,) int32 threshold direction / integer threshold.
    """
    m, kw = xp.shape
    if wp.dim() != 2 or wp.shape[0] != kw:
        raise ValueError(f"xnor_gemm_fused: xp {tuple(xp.shape)} and wp "
                         f"{tuple(wp.shape)} disagree on Kw")
    n = wp.shape[1]
    _check_epilogue("xnor_gemm_fused", n, sgn, tau)
    if not _build.check_operands("xnor_gemm_fused", xp, wp=wp, sgn=sgn, tau=tau):
        return xnor_gemm_fused_ref(xp, wp, k, sgn, tau)
    out = torch.empty((m, packed_len(n)), dtype=torch.int32, device=xp.device)
    if out.numel():
        _build.launch("qnx_xnor_dense_fused", xp.device, xp, wp, sgn, tau, out,
                      m, kw, n, k, card_splits(xp.device, m, n, kw))
        xnor_gemm_fused.launches += 1
    return out


xnor_gemm_fused.launches = 0


def ternary_gemm_fused_ref(xp: torch.Tensor, mask: torch.Tensor,
                           sign: torch.Tensor, nnz: torch.Tensor,
                           sgn: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`ternary_gemm_fused`: the plain ternary GEMM,
    threshold, pack."""
    return _threshold_pack(ternary_gemm_ref(xp, mask, sign, nnz), sgn, tau)


def ternary_gemm_fused(xp: torch.Tensor, mask: torch.Tensor, sign: torch.Tensor,
                       nnz: torch.Tensor, sgn: torch.Tensor,
                       tau: torch.Tensor) -> torch.Tensor:
    """Fused packed ternary GEMM + threshold -> (M, ceil(N/32)) int32 words.

    Args:
      xp:   (M, Kw) int32 packed ±1 activation rows.
      mask, sign: (Kw, N) int32 weight planes (pack_ternary along K).
      nnz:  (N,) int32 nonzero count of each weight column.
      sgn, tau: (N,) int32 threshold direction / integer threshold.
    """
    check_planes("ternary_gemm_fused", xp, mask, sign, nnz)
    (m, kw), n = xp.shape, mask.shape[1]
    _check_epilogue("ternary_gemm_fused", n, sgn, tau)
    if not _build.check_operands("ternary_gemm_fused", xp, mask=mask, sign=sign,
                                 nnz=nnz, sgn=sgn, tau=tau):
        return ternary_gemm_fused_ref(xp, mask, sign, nnz, sgn, tau)
    out = torch.empty((m, packed_len(n)), dtype=torch.int32, device=xp.device)
    if out.numel():
        _build.launch("qnx_ternary_dense_fused", xp.device, xp, mask, sign, nnz,
                      sgn, tau, out, m, kw, n, card_splits(xp.device, m, n, kw))
        ternary_gemm_fused.launches += 1
    return out


ternary_gemm_fused.launches = 0


# ---------------------------------------------------------------------------
# conv: (B, H, W, Cw) x (9*Cw, N) -> (B, H', W', ceil(N/32)) packed words
# ---------------------------------------------------------------------------

def _conv_ref(xp: torch.Tensor, gemm, corr: torch.Tensor, sgn: torch.Tensor,
              tau: torch.Tensor, pool: bool) -> torch.Tensor:
    """Gather 3x3 patches padded with zero words (= -1 bits), ``gemm`` them
    to s, + corr, 2x2 max of s, threshold, pack."""
    b, h, w, cw = xp.shape
    patches = extract_packed_patches(xp, 3, 3).reshape(b * h * w, 9 * cw)
    s = gemm(patches).reshape(b, h, w, -1) + corr[None]
    if pool:
        s = s.reshape(b, h // 2, 2, w // 2, 2, -1).amax(dim=(2, 4))
    return _threshold_pack(s, sgn, tau)


def _check_conv(name: str, xp: torch.Tensor, w_plane: torch.Tensor,
                corr: torch.Tensor, sgn, tau, pool: bool) -> tuple:
    """Shape checks of a fused conv's operands; returns (b, h, w, cw, n)."""
    b, h, w, cw = xp.shape
    n = w_plane.shape[1]
    if w_plane.shape[0] != 9 * cw:
        raise ValueError(f"{name}: weights {tuple(w_plane.shape)} must be "
                         f"(9*Cw, N) for xp {tuple(xp.shape)}")
    if corr.shape != (h, w, n):
        raise ValueError(f"{name}: corr {tuple(corr.shape)} must be "
                         f"{(h, w, n)}")
    if pool and (h % 2 or w % 2):
        raise ValueError(f"{name}: pool needs even H and W, got {h}x{w}")
    _check_epilogue(name, n, sgn, tau)
    return b, h, w, cw, n


def _conv_out(xp: torch.Tensor, n: int, pool: bool) -> torch.Tensor:
    b, h, w, _ = xp.shape
    ho, wo = (h // 2, w // 2) if pool else (h, w)
    return torch.empty((b, ho, wo, packed_len(n)), dtype=torch.int32,
                       device=xp.device)


def xnor_conv_fused_ref(xp: torch.Tensor, wp: torch.Tensor, k: int,
                        corr: torch.Tensor, sgn: torch.Tensor,
                        tau: torch.Tensor, *, pool: bool = False) -> torch.Tensor:
    """Plain version of :func:`xnor_conv_fused`: gather 3x3 patches padded
    with zero words (= -1 bits), unpack to ±1, float32 matmul, + corr,
    2x2 max of s, threshold, pack."""
    return _conv_ref(xp, lambda p: xnor_gemm_popcount_ref(p, wp, k), corr,
                     sgn, tau, pool)


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
      (B, H', W', ceil(N/32)) int32 packed words; H' = H/2, W' = W/2 when pool.
    """
    b, h, w, cw, n = _check_conv("xnor_conv_fused", xp, wp, corr, sgn, tau, pool)
    if not _build.check_operands("xnor_conv_fused", xp, wp=wp, corr=corr,
                                 sgn=sgn, tau=tau):
        return xnor_conv_fused_ref(xp, wp, k, corr, sgn, tau, pool=pool)
    out = _conv_out(xp, n, pool)
    if out.numel():
        _build.launch("qnx_xnor_conv3x3_fused", xp.device, xp, wp, corr, sgn,
                      tau, out, b, h, w, cw, n, k, int(pool))
        xnor_conv_fused.launches += 1
    return out


xnor_conv_fused.launches = 0


def ternary_conv_fused_ref(xp: torch.Tensor, mask: torch.Tensor,
                           sign: torch.Tensor, nnz: torch.Tensor,
                           corr: torch.Tensor, sgn: torch.Tensor,
                           tau: torch.Tensor, *, pool: bool = False) -> torch.Tensor:
    """Plain version of :func:`ternary_conv_fused`: gather 3x3 patches padded
    with zero words, the plain ternary GEMM, + corr, 2x2 max of s,
    threshold, pack."""
    return _conv_ref(xp, lambda p: ternary_gemm_ref(p, mask, sign, nnz), corr,
                     sgn, tau, pool)


def ternary_conv_fused(xp: torch.Tensor, mask: torch.Tensor, sign: torch.Tensor,
                       nnz: torch.Tensor, corr: torch.Tensor, sgn: torch.Tensor,
                       tau: torch.Tensor, *, pool: bool = False) -> torch.Tensor:
    """Fused packed ternary-weight 3x3 'SAME' stride-1 conv + threshold
    (+2x2 pool): ``s = nnz - 2*popcount(mask & (x ^ sign))`` + corr.

    Args:
      xp:   (B, H, W, Cw) int32 channel-packed sign bits.
      mask, sign: (9*Cw, N) int32 weight planes, tap-major
            (pack_conv_ternary_np).
      nnz:  (N,) int32 nonzero count of each weight column over all taps.
      corr: (H, W, N) int32 zero-pad correction (padding_correction of the
            ternary pattern).
      sgn, tau: (N,) int32 threshold direction / integer threshold.
      pool: fuse the 2x2/2 max pool (of s, before the threshold).

    Returns:
      (B, H', W', ceil(N/32)) int32 packed words, as :func:`xnor_conv_fused`.
    """
    b, h, w, cw, n = _check_conv("ternary_conv_fused", xp, mask, corr, sgn,
                                 tau, pool)
    if sign.shape != mask.shape or nnz.shape != (n,):
        raise ValueError(f"ternary_conv_fused: sign {tuple(sign.shape)} and nnz "
                         f"{tuple(nnz.shape)} must be {tuple(mask.shape)} and "
                         f"({n},)")
    if not _build.check_operands("ternary_conv_fused", xp, mask=mask, sign=sign,
                                 nnz=nnz, corr=corr, sgn=sgn, tau=tau):
        return ternary_conv_fused_ref(xp, mask, sign, nnz, corr, sgn, tau,
                                      pool=pool)
    out = _conv_out(xp, n, pool)
    if out.numel():
        _build.launch("qnx_ternary_conv3x3_fused", xp.device, xp, mask, sign,
                      nnz, corr, sgn, tau, out, b, h, w, cw, n, int(pool))
        ternary_conv_fused.launches += 1
    return out


ternary_conv_fused.launches = 0


# ---------------------------------------------------------------------------
# residual conv: (B, H, W, Cw) x (9*Cw, N) + r -> the float32 stream
# (B, H', W', N) and its sign bits (B, H', W', N/32), H' = ceil(H / stride)
# ---------------------------------------------------------------------------

def xnor_conv_residual_ref(xp: torch.Tensor, wp: torch.Tensor, k: int,
                           corr: torch.Tensor, scale: torch.Tensor,
                           shift: torch.Tensor, residual: torch.Tensor,
                           stride: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`xnor_conv_residual`: unpack the C = k / 9
    channels to ±1, pad with -1 (the zero word a pad tap reads), a float32
    conv at the stride (exact: integer sums below 2^24, rounded back in
    case the convolution's algorithm is not a direct sum), + corr, then the
    float32 epilogue in the kernel's order, each step its own op."""
    b, h, w, cw = xp.shape
    n = wp.shape[1]
    c = k // 9
    x = unpack_bits(xp, c, dtype=torch.float32).permute(0, 3, 1, 2)
    x = F.pad(x, (1, 1, 1, 1), value=-1.0)
    wt = unpack_bits(wp.reshape(9, cw, n), c, axis=1, dtype=torch.float32)
    wt = wt.reshape(3, 3, c, n).permute(3, 2, 0, 1)  # OIHW
    s = torch.round(F.conv2d(x, wt, stride=stride)).to(torch.int32)
    s = s.permute(0, 2, 3, 1) + corr
    v = s.to(torch.float32) * scale
    v = v + shift
    v = (v + residual).contiguous()
    return v, pack_bits(v >= 0)


def xnor_conv_residual(xp: torch.Tensor, wp: torch.Tensor, k: int,
                       corr: torch.Tensor, scale: torch.Tensor,
                       shift: torch.Tensor, residual: torch.Tensor,
                       stride: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed binary 3x3 conv, pad 1, at stride 1 or 2, with a residual
    epilogue (Bi-Real Net's block, ``csrc/expand_mma_conv.cu``
    ``expand_mma_conv3x3_kernel<BinaryResidualOperands<stride>, KW>``).

    Output pixel (y, x) reads input pixels (stride*y - 1 + dy, stride*x -
    1 + dx), dy, dx in 0..2; a pad tap adds nothing once ``corr`` is added.
    Per output element, in float32 with round-to-nearest at each step and
    no fused multiply-add:

        s     = sum over taps and channels of x w + corr[y, x, n]   (int32, exact)
        t     = float(s) * scale[n]          (float(s) exact: |s| < 2^24)
        u     = t + shift[n]
        x_new = u + residual[b, y, x, n]
        bit   = x_new >= 0                   (-0.0 packs as +1)

    Args:
      xp:       (B, H, W, Cw) int32 channel-packed sign bits of the stream.
      wp:       (9*Cw, N) int32 packed sign(W), tap-major (pack_conv_weights_np).
      k:        true reduction length (9 * C_in).
      corr:     (H', W', N) int32 zero-pad correction at the output grid
                (padding_correction at the stride).
      scale, shift: (N,) float32 fold of alpha and BatchNorm.
      residual: (B, H', W', N) float32, NHWC.
      stride:   1 or 2.

    Returns:
      (x_new (B, H', W', N) float32, bits (B, H', W', ceil(N/32)) int32 with
      the pad bits of the last word 0).  The CUDA kernel takes N % 32 == 0.
    """
    b, h, w, cw = xp.shape
    n = wp.shape[1]
    if stride not in (1, 2):
        raise ValueError(f"xnor_conv_residual: stride must be 1 or 2, got {stride}")
    ho, wo = -(-h // stride), -(-w // stride)
    if wp.shape[0] != 9 * cw or corr.shape != (ho, wo, n):
        raise ValueError(f"xnor_conv_residual: weights {tuple(wp.shape)} and corr "
                         f"{tuple(corr.shape)} must be {(9 * cw, n)} and "
                         f"{(ho, wo, n)} for xp {tuple(xp.shape)} at stride {stride}")
    if (scale.shape != (n,) or shift.shape != (n,)
            or residual.shape != (b, ho, wo, n)):
        raise ValueError(f"xnor_conv_residual: scale {tuple(scale.shape)}, shift "
                         f"{tuple(shift.shape)} and residual {tuple(residual.shape)} "
                         f"must be ({n},), ({n},) and {(b, ho, wo, n)}")
    f32 = torch.float32
    if not _build.check_operands("xnor_conv_residual", xp,
                                 {"scale": f32, "shift": f32, "residual": f32},
                                 wp=wp, corr=corr, scale=scale, shift=shift,
                                 residual=residual):
        return xnor_conv_residual_ref(xp, wp, k, corr, scale, shift, residual,
                                      stride)
    if n % 32:
        raise ValueError(f"xnor_conv_residual: the kernel takes N % 32 == 0, got {n}")
    out_f = torch.empty((b, ho, wo, n), dtype=f32, device=xp.device)
    out = torch.empty((b, ho, wo, n // 32), dtype=torch.int32, device=xp.device)
    if out.numel():
        _build.launch("qnx_xnor_conv3x3_residual", xp.device, xp, wp, corr, scale,
                      shift, residual, out_f, out, b, h, w, cw, n, k, stride)
        xnor_conv_residual.launches += 1
    return out_f, out


xnor_conv_residual.launches = 0
