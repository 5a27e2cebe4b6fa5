"""Packed-integer inference engines for the binary and ternary VGG and MLP
and the bit-plane VGG (torch port of the packed and bit-plane layers of
:mod:`qnx.nn.inference`).

A packed model is a chain of

    bits --XNOR/ternary popcount conv/GEMM--> int32 s --(sgn*s >= tau)--> bits

and a bit-plane model (n-bit quantized_relu or quantized_tanh activations,
abits > 1) one of

    {0,1} planes --plane popcount conv/GEMM--> s = sum_j 2^j t_j (+ corr)
                 --(sum_v [sgn*s >= tau[v]])--> level --bit j--> planes

with float math only at the first layer (real-valued images in) and the
logit head.  Layers are ``nn.Module``s whose packed words, corrections,
thresholds and float weights are buffers, so ``model.to(device)`` moves all
of it.  Tensors keep the JAX package's layout: NHWC activations packed along
C, (9*Cw, N) tap-major conv weights, (Kw, N) dense weights and planes.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import torch
import torch.nn.functional as F
from torch import nn

from qnx_torch.kernels.plane_gemm import (levels_to_planes, plane_conv_fused,
                                          plane_dense_fused, plane_head)
from qnx_torch.kernels.ternary_gemm import ternary_head
from qnx_torch.kernels.xnor_conv_fused import (ternary_conv_fused,
                                               ternary_gemm_fused,
                                               xnor_conv_fused, xnor_gemm_fused)
from qnx_torch.kernels.xnor_gemm import k_major, xnor_head
from qnx_torch.ops.packing import pack_bits, unpack_bits
from qnx_torch.ops.quant import quantized_relu, quantized_tanh

_TF32_LOCK = threading.Lock()


@contextmanager
def _ieee_f32():
    """Launch the float boundary ops in IEEE float32, the counterpart of the
    JAX package's ``REFERENCE_PRECISION``: TF32 off for cuBLAS and cuDNN
    (cuDNN allows TF32 by default) for the ops inside only, and the caller's
    settings restored after.  The flags are process-wide and read when an op
    is launched, so the lock keeps two forwards in different threads from
    restoring each other's settings mid-launch."""
    with _TF32_LOCK:
        matmul = torch.backends.cuda.matmul.allow_tf32
        cudnn = torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul
            torch.backends.cudnn.allow_tf32 = cudnn


class _BatchNorm(nn.Module):
    """Inference BN with flax.linen's op order:
    (y - mean) * (rsqrt(var + eps) * scale) + bias."""

    def __init__(self, bn_scale, bn_bias, bn_mean, bn_var, bn_eps: float):
        super().__init__()
        self.register_buffer("bn_scale", bn_scale)
        self.register_buffer("bn_bias", bn_bias)
        self.register_buffer("bn_mean", bn_mean)
        self.register_buffer("bn_var", bn_var)
        self.bn_eps = bn_eps

    def _bn(self, y: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.bn_var + self.bn_eps) * self.bn_scale
        return (y - self.bn_mean) * mul + self.bn_bias


def _conv_same(x: torch.Tensor, w: torch.Tensor, bias) -> torch.Tensor:
    """f32 'SAME' stride-1 conv of NHWC ``x`` with HWIO ``w`` (+bias), TF32
    off, NHWC out."""
    kh, kw = w.shape[:2]
    with _ieee_f32():
        y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                     padding=(kh // 2, kw // 2))
    y = y.permute(0, 2, 3, 1)
    return y if bias is None else y + bias


def _maxpool2(y: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pool (NHWC, 'VALID'), exact on int32 or f32."""
    b, h, w, c = y.shape
    y = y[:, :h // 2 * 2, :w // 2 * 2]
    return y.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def _levels_from_float(y: torch.Tensor, nb: int) -> torch.Tensor:
    """Float pre-activation -> int32 level index of quantized_relu(y, nb),
    ``round(quantized_relu(y) / q)`` (the division by the pow2 step q is
    exact in float32)."""
    q = 2.0 ** (1 - nb)
    return torch.round(quantized_relu(y, nb) / q).to(torch.int32)


def _tanh_levels_from_float(y: torch.Tensor, nb: int) -> torch.Tensor:
    """Float pre-activation -> int32 SIGNED code v in [-(L-1), L-1]
    (L = 2^(nb-1)) of quantized_tanh(y, nb), ``round(quantized_tanh(y) /
    q)`` (the division by the pow2 step q is exact in float32).  A zero
    code is the zero activation, so the int8 engine's conv pads need no
    correction."""
    q = 2.0 ** (1 - nb)
    return torch.round(quantized_tanh(y, nb) / q).to(torch.int32)


class FloatDenseBits(_BatchNorm):
    """Float-input dense layer producing sign bits: f32 ``x @ w`` (+bias) ->
    BN -> bits packed along the features."""

    def __init__(self, w, bias, bn_scale, bn_bias, bn_mean, bn_var,
                 bn_eps: float = 1e-4):
        super().__init__(bn_scale, bn_bias, bn_mean, bn_var, bn_eps)
        self.register_buffer("w", w)        # (K, N) f32
        self.register_buffer("bias", bias)  # (N,) f32 or None

    def dense(self, x: torch.Tensor) -> torch.Tensor:
        """The f32 matmul (+bias)."""
        with _ieee_f32():
            y = x @ self.w
        return y if self.bias is None else y + self.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pack_bits(self._bn(self.dense(x)), axis=-1)


class PackedDenseBits(nn.Module):
    """Binary hidden dense layer: popcount GEMM + integer threshold ->
    packed bits, in one kernel."""

    def __init__(self, wp, sgn, tau, k: int):
        super().__init__()
        self.register_buffer("wp", wp)      # (Kw, N) int32
        self.register_buffer("sgn", sgn)
        self.register_buffer("tau", tau)
        self.k = k

    def forward(self, bits: torch.Tensor) -> torch.Tensor:
        return xnor_gemm_fused(bits, self.wp, self.k, self.sgn, self.tau)


class TernaryDenseBits(nn.Module):
    """Ternary hidden dense layer: two-plane popcount GEMM + integer
    threshold -> packed bits, in one kernel."""

    def __init__(self, mask, sign, nnz, sgn, tau):
        super().__init__()
        self.register_buffer("mask", mask)  # (Kw, N) int32
        self.register_buffer("sign", sign)  # (Kw, N) int32
        self.register_buffer("nnz", nnz)    # (N,) int32
        self.register_buffer("sgn", sgn)
        self.register_buffer("tau", tau)

    def forward(self, bits: torch.Tensor) -> torch.Tensor:
        return ternary_gemm_fused(bits, self.mask, self.sign, self.nnz,
                                  self.sgn, self.tau)


class _IntegerHead(nn.Module):
    """Output head over packed bits or planes: an integer GEMM and the
    folded float affine ``a * s + c``, one kernel launch on the card
    (``csrc/popcount_head.cu``) for the logits (``forward``) or the int32 s
    (``scores``).  The weight planes are also held K-major (``wt``), as the
    kernel reads them."""

    def __init__(self, a, c, *planes):
        super().__init__()
        self.register_buffer("a", a)  # (N,) f32
        self.register_buffer("c", c)  # (N,) f32
        self.register_buffer("wt", k_major(*planes))  # (planes, N, Kw) int32

    def head(self, x: torch.Tensor, a=None, c=None) -> torch.Tensor:
        """The head's wrapper: int32 s, or the logits with ``a`` and ``c``."""
        raise NotImplementedError

    def scores(self, x: torch.Tensor) -> torch.Tensor:
        """The head's int32 s."""
        return self.head(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(x, self.a, self.c)


class PackedDenseLogits(_IntegerHead):
    """Binary output head: popcount GEMM -> int32 s -> float affine."""

    def __init__(self, wp, a, c, k: int):
        super().__init__(a, c, wp)
        self.register_buffer("wp", wp)  # (Kw, N) int32
        self.k = k

    def head(self, bits, a=None, c=None):
        return xnor_head(bits, self.wp, self.k, a, c, wt=self.wt)


class TernaryDenseLogits(_IntegerHead):
    """Ternary output head: two-plane popcount GEMM -> int32 s -> affine."""

    def __init__(self, mask, sign, nnz, a, c):
        super().__init__(a, c, mask, sign)
        self.register_buffer("mask", mask)  # (Kw, N) int32
        self.register_buffer("sign", sign)  # (Kw, N) int32
        self.register_buffer("nnz", nnz)    # (N,) int32

    def head(self, bits, a=None, c=None):
        return ternary_head(bits, self.mask, self.sign, self.nnz, a, c,
                            wt=self.wt)


class FloatDenseLogits(_BatchNorm):
    """Float output head over ±1 values (``last_layer_float`` configs):
    logits = BN(x @ w + bias)."""

    def __init__(self, w, bias, bn_scale, bn_bias, bn_mean, bn_var,
                 bn_eps: float = 1e-4):
        super().__init__(bn_scale, bn_bias, bn_mean, bn_var, bn_eps)
        self.register_buffer("w", w)
        self.register_buffer("bias", bias)

    def forward(self, bits_as_pm1: torch.Tensor) -> torch.Tensor:
        with _ieee_f32():
            y = bits_as_pm1 @ self.w
        if self.bias is not None:
            y = y + self.bias
        return self._bn(y)


class FloatConvBits(_BatchNorm):
    """Float first conv layer: f32 'SAME' conv (+bias) -> BN -> sign bits
    packed along channels.  Optional 2x2 max pool BEFORE BN (BinaryNet)."""

    def __init__(self, w, bias, bn_scale, bn_bias, bn_mean, bn_var,
                 bn_eps: float = 1e-4, pool: bool = False):
        super().__init__(bn_scale, bn_bias, bn_mean, bn_var, bn_eps)
        self.register_buffer("w", w)        # (kh, kw, C, N) f32, HWIO
        self.register_buffer("bias", bias)  # (N,) f32 or None
        self.pool = pool

    def conv(self, x: torch.Tensor) -> torch.Tensor:
        """The f32 'SAME' conv (+bias), NHWC in and out."""
        return _conv_same(x, self.w, self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        if self.pool:
            y = _maxpool2(y)
        return pack_bits(self._bn(y), axis=-1)


class PackedConvBits(nn.Module):
    """Binary hidden conv: packed 3x3 conv + pad corr (+ max pool of s) +
    integer threshold -> packed bits, in one kernel."""

    def __init__(self, wp, corr, sgn, tau, k: int, pool: bool = False):
        super().__init__()
        self.register_buffer("wp", wp)      # (9*Cw, N) int32
        self.register_buffer("corr", corr)  # (H, W, N) int32
        self.register_buffer("sgn", sgn)    # (N,) int32 in {+1, -1}
        self.register_buffer("tau", tau)    # (N,) int32
        self.k = k
        self.pool = pool

    def forward(self, bits: torch.Tensor) -> torch.Tensor:
        return xnor_conv_fused(bits, self.wp, self.k, self.corr, self.sgn,
                               self.tau, pool=self.pool)


class TernaryConvBits(nn.Module):
    """Ternary hidden conv: two-plane packed 3x3 conv + pad corr (+ max pool
    of s) + integer threshold -> packed bits, in one kernel."""

    def __init__(self, mask, sign, nnz, corr, sgn, tau, pool: bool = False):
        super().__init__()
        self.register_buffer("mask", mask)  # (9*Cw, N) int32
        self.register_buffer("sign", sign)  # (9*Cw, N) int32
        self.register_buffer("nnz", nnz)    # (N,) int32
        self.register_buffer("corr", corr)  # (H, W, N) int32
        self.register_buffer("sgn", sgn)    # (N,) int32 in {+1, -1}
        self.register_buffer("tau", tau)    # (N,) int32
        self.pool = pool

    def forward(self, bits: torch.Tensor) -> torch.Tensor:
        return ternary_conv_fused(bits, self.mask, self.sign, self.nnz,
                                  self.corr, self.sgn, self.tau, pool=self.pool)


class FloatDenseLogitsFromBits(_BatchNorm):
    """Float head over binary activations: unpack bits to ±1 ('pm1') or
    {0,1} ('zo', binary_sigmoid), f32 GEMM (+bias), BN -> logits."""

    def __init__(self, w, bias, bn_scale, bn_bias, bn_mean, bn_var,
                 bn_eps: float = 1e-4, k: int = 0, coding: str = "pm1"):
        super().__init__(bn_scale, bn_bias, bn_mean, bn_var, bn_eps)
        if coding not in ("pm1", "zo"):
            raise ValueError(f"coding must be 'pm1' or 'zo', got {coding!r}")
        self.register_buffer("w", w)        # (K, N) f32
        self.register_buffer("bias", bias)
        self.k = k
        self.coding = coding

    def forward(self, bits: torch.Tensor) -> torch.Tensor:
        x = unpack_bits(bits, self.k, axis=-1, dtype=torch.float32)
        if self.coding == "zo":
            x = (x + 1.0) * 0.5  # the stored bit IS the {0,1} value
        with _ieee_f32():
            y = x @ self.w
        if self.bias is not None:
            y = y + self.bias
        return self._bn(y)


class PackedVGG(nn.Module):
    """End-to-end packed VGG: float first conv -> packed conv blocks ->
    flatten (C-word-aligned) -> packed dense -> head."""

    def __init__(self, first: FloatConvBits, convs, denses, head):
        super().__init__()
        self.first = first
        self.convs = nn.ModuleList(convs)
        self.denses = nn.ModuleList(denses)
        self.head = head

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        bits = self.first(images)
        for layer in self.convs:
            bits = layer(bits)
        # (H*W*Cw) word-aligned flatten, of each plane in a bit-plane model
        bits = bits.reshape(*bits.shape[:-3], -1)
        for layer in self.denses:
            bits = layer(bits)
        return self.head(bits)


def vgg_forward(model: PackedVGG, images: torch.Tensor) -> torch.Tensor:
    """Packed forward: NHWC images in [-1, 1] -> logits."""
    with torch.inference_mode():
        return model(images)


class PackedMLP(nn.Module):
    """End-to-end packed MLP: flatten -> float-in first layer -> hidden
    packed (binary or ternary) dense layers -> integer head."""

    def __init__(self, first: FloatDenseBits, hidden, head):
        super().__init__()
        self.first = first
        self.hidden = nn.ModuleList(hidden)
        self.head = head

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        bits = self.first(images.reshape(images.shape[0], -1))
        for layer in self.hidden:
            bits = layer(bits)
        return self.head(bits)


def mlp_forward(model: PackedMLP, images: torch.Tensor) -> torch.Tensor:
    """Packed forward: images in [-1, 1] -> logits."""
    with torch.inference_mode():
        return model(images)


# ---------------------------------------------------------------------------
# bit-plane engine (abits > 1): {0,1} activation planes, multi-level
# thresholds
# ---------------------------------------------------------------------------

class FloatConvPlanes(FloatConvBits):
    """Float first conv -> BN -> n-bit levels -> packed {0,1} planes
    (abits > 1 configs).  ``mode="relu"``: quantized_relu's level in
    [0, L - 1], nb - 1 planes; ``mode="tanh"``: quantized_tanh's signed
    code v as the unsigned index u = v + (L - 1) in [0, 2L - 2], nb planes
    (L = 2^(nb-1))."""

    def __init__(self, w, bias, bn_scale, bn_bias, bn_mean, bn_var,
                 bn_eps: float = 1e-4, nb: int = 2, pool: bool = False,
                 mode: str = "relu"):
        super().__init__(w, bias, bn_scale, bn_bias, bn_mean, bn_var,
                         bn_eps=bn_eps, pool=pool)
        if mode not in ("relu", "tanh"):
            raise ValueError(f"mode must be 'relu' or 'tanh', got {mode!r}")
        self.nb = nb
        self.mode = mode

    def levels(self, z: torch.Tensor) -> torch.Tensor:
        """BN output -> the planes of its level index."""
        if self.mode == "tanh":
            u = _tanh_levels_from_float(z, self.nb) + (2 ** (self.nb - 1) - 1)
            return levels_to_planes(u, self.nb)
        return levels_to_planes(_levels_from_float(z, self.nb), self.nb - 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        if self.pool:
            y = _maxpool2(y)
        return self.levels(self._bn(y))


class PlaneConvTernary(nn.Module):
    """Ternary- (or binary-) weight conv over activation planes + border
    term + multi-level integer thresholds (+ max pool of s) -> the next
    planes, in one kernel.  Zero pads add nothing to {0,1} planes, so relu
    mode has no border term (``corr`` None); tanh mode's planes carry
    unsigned indices u = v + (L - 1), whose zero pads understate the zero
    activation by L - 1 a tap, and ``corr`` (H, W, N) holds that
    (L - 1)-scaled border correction."""

    def __init__(self, mask, msign, sgn, tau, pool: bool = False, corr=None):
        super().__init__()
        self.register_buffer("mask", mask)    # (9*Cw, N) int32
        self.register_buffer("msign", msign)  # mask & sign
        self.register_buffer("sgn", sgn)      # (N,) int32
        self.register_buffer("tau", tau)      # (n_thresh, N) int32
        self.register_buffer("corr", corr)    # (H, W, N) int32 or None
        self.pool = pool

    def forward(self, planes: torch.Tensor) -> torch.Tensor:
        return plane_conv_fused(planes, self.mask, self.msign, self.sgn,
                                self.tau, pool=self.pool, corr=self.corr)


class PlaneDenseTernary(nn.Module):
    """Ternary-weight dense over flattened activation planes + multi-level
    thresholds -> planes, in one kernel."""

    def __init__(self, mask, msign, sgn, tau):
        super().__init__()
        self.register_buffer("mask", mask)    # (Kw, N) int32
        self.register_buffer("msign", msign)
        self.register_buffer("sgn", sgn)
        self.register_buffer("tau", tau)      # (n_thresh, N) int32

    def forward(self, planes: torch.Tensor) -> torch.Tensor:
        return plane_dense_fused(planes, self.mask, self.msign, self.sgn,
                                 self.tau)


class PlaneDenseLogits(_IntegerHead):
    """Integer head over planes: s = sum_j 2^j t_j, logits = a * s + c, in
    one kernel over all planes."""

    def __init__(self, mask, msign, a, c):
        super().__init__(a, c, mask, msign)
        self.register_buffer("mask", mask)    # (Kw, N) int32
        self.register_buffer("msign", msign)

    def head(self, planes, a=None, c=None):
        return plane_head(planes, self.mask, self.msign, a, c, wt=self.wt)


class FloatDenseLogitsFromPlanes(_BatchNorm):
    """Float head over n-bit activations: x = q * (sum_j 2^j b_j - lvl0),
    f32 GEMM (+bias), BN -> logits (``last_layer_float`` configs; lvl0 =
    L - 1 recentres quantized_tanh's unsigned index, 0 for relu)."""

    def __init__(self, w, bias, bn_scale, bn_bias, bn_mean, bn_var,
                 bn_eps: float = 1e-4, k: int = 0, q: float = 0.5,
                 lvl0: int = 0):
        super().__init__(bn_scale, bn_bias, bn_mean, bn_var, bn_eps)
        self.register_buffer("w", w)        # (K, N) f32
        self.register_buffer("bias", bias)
        self.k = k
        self.q = q
        self.lvl0 = lvl0

    def forward(self, planes: torch.Tensor) -> torch.Tensor:
        lvl = None
        for j in range(planes.shape[0]):
            b = (unpack_bits(planes[j], self.k, axis=-1, dtype=torch.int32) + 1) // 2
            lvl = b if lvl is None else lvl + (b << j)
        # the int32 difference times the pow2 step q: exact
        x = (lvl - self.lvl0).to(torch.float32) * self.q
        with _ieee_f32():
            y = x @ self.w
        if self.bias is not None:
            y = y + self.bias
        return self._bn(y)


class PlaneVGG(PackedVGG):
    """End-to-end n-bit-activation VGG (the CIFAR-10 TNN config, relu or
    tanh mode): float first conv (``FloatConvPlanes``) -> plane convs -> flatten each plane
    (C-word-aligned) -> plane dense -> head, on (P, B, ...) planes."""


# the bit-plane forward (NHWC images in [-1, 1] -> logits) is the packed one
plane_forward = vgg_forward
