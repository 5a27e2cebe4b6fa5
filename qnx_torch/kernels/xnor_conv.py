"""Packed binary and ternary convolution helpers (torch port of
:mod:`qnx.kernels.xnor_conv`): packed-word patch gathering, host-side weight
packing (sign planes, or mask and sign planes) and the zero-padding
correction, plus the unfused convs as plain references.

Zero-padding correction: a zero pad is a third symbol in the ±1 domain.
The packed input is padded with 0-bits, which decode to -1, so

    s_packed[b,h,w,n] = s_zero_pad[b,h,w,n] - sum_{taps outside image} w[tap,n]

and the exact zero-pad conv is recovered with the input-independent
``corr[h,w,n] = sum_{pad taps at (h,w)} w[tap,n]`` (:func:`padding_correction`).

Layout contract: activations NHWC packed along C (C bits -> Cw words per
position); weights HWIO packed along I per tap, concatenated tap-major
[(dy0,dx0) words..., (dy0,dx1) words...] to match patch order.
"""
from __future__ import annotations

import numpy as np
import torch

from qnx_torch.ops.packing import pack_bits_np, pack_ternary_np
from qnx_torch.ops.reference import ternary_gemm_ref, xnor_gemm_ref


def extract_packed_patches(xp: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """(B, H, W, Cw) packed words -> (B, H, W, kh*kw*Cw) 'SAME' patches.

    Pads with all-zero words (= -1 bits, corrected downstream) and stacks
    the kh*kw shifted views along the last axis, tap-major."""
    b, h, w, cw = xp.shape
    ph, pw = kh // 2, kw // 2
    xpad = xp.new_zeros(b, h + 2 * ph, w + 2 * pw, cw)
    xpad[:, ph:ph + h, pw:pw + w, :] = xp
    taps = [xpad[:, dy:dy + h, dx:dx + w, :]
            for dy in range(kh) for dx in range(kw)]
    return torch.cat(taps, dim=-1)


def pack_conv_weights_np(pattern: np.ndarray):
    """Host-side: (kh, kw, C, N) ±1 pattern -> (kh*kw*Cw, N) packed planes
    matching :func:`extract_packed_patches` order. Returns (wp, k_true)."""
    kh, kw, c, n = pattern.shape
    blocks = [pack_bits_np(pattern[dy, dx], axis=0)  # (Cw, N)
              for dy in range(kh) for dx in range(kw)]
    return np.concatenate(blocks, axis=0), kh * kw * c


def pack_conv_ternary_np(pattern: np.ndarray):
    """Host-side ternary variant: (kh, kw, C, N) {-1, 0, +1} pattern ->
    (mask, sign, nnz) of shapes (kh*kw*Cw, N), (kh*kw*Cw, N), (N,), tap-major
    like :func:`pack_conv_weights_np`."""
    kh, kw, c, n = pattern.shape
    masks, signs = [], []
    nnz = np.zeros(n, np.int32)
    for dy in range(kh):
        for dx in range(kw):
            m, s, z = pack_ternary_np(pattern[dy, dx], axis=0)
            masks.append(m)
            signs.append(s)
            nnz += z
    return np.concatenate(masks, 0), np.concatenate(signs, 0), nnz


def padding_correction(pattern: np.ndarray, h: int, w: int,
                       stride: int = 1) -> np.ndarray:
    """Host-side: corr[y, x, n] = sum over taps falling outside the image of
    sum_c pattern[dy, dx, c, n] (a ±1 or {-1, 0, +1} pattern), at the
    output grid of an (h, w) input: (h, w) at stride 1, (ceil(h/s),
    ceil(w/s)) at stride s, whose output (y, x) reads input (s*y + dy - ph,
    s*x + dx - pw).  Adding ``corr`` to the packed conv output yields the
    exact zero-padding conv result."""
    kh, kw, _, n = pattern.shape
    ph, pw = kh // 2, kw // 2
    ho, wo = -(-h // stride), -(-w // stride)
    wsum = pattern.sum(axis=2, dtype=np.int64)  # (kh, kw, n)
    corr = np.zeros((ho, wo, n), np.int64)
    for dy in range(kh):
        for dx in range(kw):
            # tap (dy,dx) at output (y,x) reads input (s*y+dy-ph, s*x+dx-pw)
            ys = stride * np.arange(ho)[:, None] + dy - ph
            xs = stride * np.arange(wo)[None, :] + dx - pw
            outside = (ys < 0) | (ys >= h) | (xs < 0) | (xs >= w)
            corr += outside[:, :, None] * wsum[dy, dx][None, None, :]
    return corr.astype(np.int32)


def xnor_conv(xp: torch.Tensor, wp: torch.Tensor, k: int, corr: torch.Tensor,
              kh: int = 3, kw: int = 3) -> torch.Tensor:
    """Packed binary 'SAME' conv, stride 1: (B,H,W,Cw) x (kh*kw*Cw, N) ->
    exact zero-pad conv output (B,H,W,N) int32 (plain reference)."""
    b, h, w, _ = xp.shape
    patches = extract_packed_patches(xp, kh, kw)
    s = xnor_gemm_ref(patches.reshape(b * h * w, -1), wp, k)
    return s.reshape(b, h, w, -1) + corr[None]


def ternary_conv(xp: torch.Tensor, mask: torch.Tensor, sign: torch.Tensor,
                 nnz: torch.Tensor, corr: torch.Tensor, kh: int = 3,
                 kw: int = 3) -> torch.Tensor:
    """Packed ternary-weight 'SAME' conv, stride 1 (two-plane popcount):
    exact zero-pad conv output (B,H,W,N) int32 (plain reference)."""
    b, h, w, _ = xp.shape
    patches = extract_packed_patches(xp, kh, kw)
    s = ternary_gemm_ref(patches.reshape(b * h * w, -1), mask, sign, nnz)
    return s.reshape(b, h, w, -1) + corr[None]
