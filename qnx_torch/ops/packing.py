"""Bit-packing of ±1 (binary) and {-1, 0, +1} (ternary) tensors into int32
words (torch port of :mod:`qnx.ops.packing`).

Layout contract, identical to the JAX package:

* bit ``j`` of word ``kw`` holds element ``k = kw*32 + j``  (LSB-first);
* bit value 1 encodes +1, bit value 0 encodes -1;
* the reduction axis is zero-padded up to a multiple of 32 **with 0-bits on
  both operands**, so padding bits XOR to 0 (a "match") and the true dot
  product is recovered as ``dot = K - 2*popcount(x ^ w)`` with the *unpadded*
  K — no correction term needed;
* packed words are stored as int32.

torch has no unsigned 32-bit arithmetic, so words are assembled a byte at
a time in uint8 and read as int32, and popcounted in int64.
"""
from __future__ import annotations

import numpy as np
import torch

WORD = 32

_SHIFTS = torch.arange(WORD, dtype=torch.int64)


def packed_len(k: int) -> int:
    """Number of 32-bit words covering k elements."""
    return (k + WORD - 1) // WORD


def pack_bits(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack the sign bits of ``x`` along ``axis`` into int32 words.

    An element packs to bit 1 iff ``x > 0`` (exact zeros and -0.0 pack as
    -1), like :func:`qnx.ops.packing.pack_bits`.  Each byte of a word is
    summed in uint8 from its 8 bits and the four bytes are read as one int32
    (little-endian, as the CPU and the card are): no int64 and no table
    copied from the host."""
    x = torch.movedim(x, axis, -1)
    k = x.shape[-1]
    kw = packed_len(k)
    bits = (x > 0).to(torch.uint8)
    if kw * WORD != k:
        bits = torch.cat([bits, bits.new_zeros(*bits.shape[:-1], kw * WORD - k)], -1)
    bits = bits.reshape(*bits.shape[:-1], kw, 4, 8)
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device)
    words = (bits << shifts).sum(-1, dtype=torch.uint8).view(torch.int32).squeeze(-1)
    return torch.movedim(words, -1, axis)


def unpack_bits(words: torch.Tensor, k: int, axis: int = -1,
                dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: int32 words -> ±1 values along ``axis``."""
    words = torch.movedim(words, axis, -1)
    # arithmetic >> on int32 smears the sign bit; the & 1 keeps bit j only
    bits = (words.unsqueeze(-1) >> _SHIFTS.to(words.device).to(words.dtype)) & 1
    pm1 = (2 * bits - 1).to(dtype)
    pm1 = pm1.reshape(*pm1.shape[:-2], -1)[..., :k]
    return torch.movedim(pm1, -1, axis)


def pack_ternary(w: torch.Tensor, axis: int = 0):
    """Pack a {-c, 0, +c}-valued tensor into (mask, sign) bit-planes.

    Returns ``(mask_words, sign_words, nnz)`` where along ``axis`` the mask
    bit is 1 iff the element is nonzero, the sign bit is 1 iff it is > 0
    (zeros carry sign bit 0), and ``nnz`` is the int32 count of nonzeros of
    each remaining-axes slice, as :func:`qnx.ops.packing.pack_ternary`.
    Padding words are all-zero in both planes, so they contribute nothing."""
    mask = pack_bits(w != 0, axis=axis)
    sign = pack_bits(w, axis=axis)
    nnz = torch.sum(w != 0, dim=axis, dtype=torch.int32)
    return mask, sign, nnz


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Population count of int32 words (SWAR on the unsigned value, in
    int64 so no shift sees a sign bit)."""
    v = words.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) >> 24) & 0xFF).to(torch.int32)


def pack_bits_np(x: np.ndarray, axis: int = -1) -> np.ndarray:
    """Host-side (numpy) pack_bits — identical layout/convention to
    :func:`pack_bits`; used by the conversion pass."""
    x = np.moveaxis(np.asarray(x), axis, -1)
    k = x.shape[-1]
    kw = packed_len(k)
    bits = x > 0
    bits = np.pad(bits, [(0, 0)] * (bits.ndim - 1) + [(0, kw * WORD - k)])
    bits = bits.reshape(*bits.shape[:-1], kw, WORD).astype(np.uint32)
    shifts = np.arange(WORD, dtype=np.uint32)
    words = np.sum(bits << shifts, axis=-1, dtype=np.uint32).view(np.int32)
    return np.moveaxis(words, -1, axis)


def pack_ternary_np(w: np.ndarray, axis: int = 0):
    """Host-side (numpy) :func:`pack_ternary`, same contract; used by the
    conversion pass."""
    w = np.asarray(w)
    mask = pack_bits_np(np.where(w != 0, 1.0, -1.0), axis=axis)
    sign = pack_bits_np(w, axis=axis)
    nnz = np.sum(w != 0, axis=axis, dtype=np.int32)
    return mask, sign, nnz
