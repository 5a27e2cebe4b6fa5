"""int8 inference engine (torch port of :mod:`qnx.nn.int8_engine`).

Activations are int8 codes: ``pm1`` for binary_tanh (±1), ``zo`` for
binary_sigmoid ({0, 1}, the code is the value), ``levels`` for
quantized_relu(nb) level indices 0 .. 2^(nb-1)-1 and ``tanh`` for
quantized_tanh(nb) signed codes -(2^(nb-1)-1) .. 2^(nb-1)-1 (real value
q * code, q = 2^(1-nb), folded into the thresholds).  Weights are int8:
{-1, 0, +1}, or ``full-qnn``'s pow2-grid integers in [-2^(wbits-1),
2^(wbits-1) - 1] (wbits <= 8, the scale folded likewise).  Every hidden
layer is an exact int32 product and the integer threshold epilogue of the
packed engine, from the same BN fold, so the two engines give the same
bits.  An int8 zero is a true zero in every encoding, so the convs' zero
pads need no correction.

* every hidden conv runs kernel E (:func:`qnx_torch.kernels.i8_conv_fused.
  i8_conv_fused`: conv, threshold and pool in one CUDA kernel), with its
  weights also held K-major (``wk``, :func:`~qnx_torch.kernels.
  i8_conv_fused.k_major`) as the kernel reads them; the JAX layer's
  ``fused`` flag has no counterpart, the port has one route;
* the dense layers are plain int8 products, as XLA's are in JAX:
  ``torch._int_mm`` on CUDA, an int32 matmul on the CPU (:func:`_dot_i8`),
  with the (K, N) weights held column-major (:func:`_column_major`);
* the first layer and a float head are float32 ops with TF32 off.

The relu network types (``bnn``, ``tnn``, ``qnn``: quantized weights, float
relu activations) are :class:`I8WConv`, :class:`I8WDense` and
:class:`I8WHead`: int8 weights and a scalar scale, dequantized at each call
and run through cuDNN and cuBLAS with TF32 off, as the JAX package leaves
them to XLA.  Layers are ``nn.Module``s whose int8 weights, thresholds and
float weights are buffers; tensors keep the JAX layouts (NHWC codes,
(3, 3, C, N) conv weights, (K, N) dense weights).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from qnx_torch.kernels.i8_conv_fused import (ENCODINGS, act_epilogue,
                                             i8_conv_fused, k_major)
from qnx_torch.kernels.xnor_gemm import affine
from qnx_torch.nn.inference import (FloatConvBits, FloatDenseBits, _BatchNorm,
                                    _conv_same, _ieee_f32, _levels_from_float,
                                    _maxpool2, _tanh_levels_from_float)

# torch._int_mm on CUDA takes M > 16 rows and K and N multiples of 8
_INT_MM_MIN_ROWS = 17
_INT_MM_MULTIPLE = 8


def _column_major(w8: torch.Tensor) -> torch.Tensor:
    """The same (K, N) weights laid out column-major (strides (1, K)), the
    layout cuBLAS's int8 GEMM runs fast: ``torch._int_mm`` of (256, 8192) x
    (8192, 1024) took 0.289 ms with a row-major operand and 0.020 ms with
    the same values column-major on an H100 SXM at 700 W (chip_smoke.py,
    PERF.md §6)."""
    return w8.t().contiguous().t()


def _dot_i8(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) x (K, N) -> exact int32 (M, N): ``torch._int_mm`` on
    CUDA (:func:`_int_mm_padded`), an int32 matmul on the CPU."""
    if not x8.is_cuda:
        return x8.to(torch.int32) @ w8.to(torch.int32)
    return _int_mm_padded(x8, w8)


def _int_mm_padded(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """``torch._int_mm`` of any shape.  On CUDA it takes only M > 16 and K
    and N multiples of 8: a shape that falls short is padded with zero rows
    or columns (a zero code or weight adds nothing) and the result cut back,
    as the MLP head's N = 10 and a batch of 16 rows or fewer need.  The
    weights are padded as (N, K), so a column-major ``w8`` stays
    column-major."""
    (m, k), n = x8.shape, w8.shape[1]
    mp = max(m, _INT_MM_MIN_ROWS)
    kp = -(-k // _INT_MM_MULTIPLE) * _INT_MM_MULTIPLE
    np_ = -(-n // _INT_MM_MULTIPLE) * _INT_MM_MULTIPLE
    if (mp, kp) != (m, k):
        x8 = F.pad(x8, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        w8 = F.pad(w8.t(), (0, kp - k, 0, np_ - n)).t()
    s = torch._int_mm(x8, w8)
    return s if (mp, np_) == (m, n) else s[:m, :n]


def _check_act(act: str) -> str:
    if act not in ENCODINGS:
        raise ValueError(f"unknown int8 encoding {act!r}")
    return act


def _encode_float(act: str, z: torch.Tensor, nb: int) -> torch.Tensor:
    """Float post-BN pre-activation -> int8 activation code (first layers)."""
    if _check_act(act) == "pm1":
        return torch.where(z > 0, 1, -1).to(torch.int8)
    if act == "zo":
        return torch.where(z > 0, 1, 0).to(torch.int8)
    if act == "tanh":
        return _tanh_levels_from_float(z, nb).to(torch.int8)
    return _levels_from_float(z, nb).to(torch.int8)


class I8FirstConv(FloatConvBits):
    """Float first conv: f32 'SAME' conv (+bias, TF32 off) -> [pool] -> BN
    -> int8 activation codes."""

    def __init__(self, w, bias, bn_scale, bn_bias, bn_mean, bn_var,
                 bn_eps: float = 1e-4, act: str = "pm1", nb: int = 1,
                 pool: bool = False):
        super().__init__(w, bias, bn_scale, bn_bias, bn_mean, bn_var, bn_eps,
                         pool=pool)
        self.act = _check_act(act)
        self.nb = nb

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        if self.pool:
            y = _maxpool2(y)
        return _encode_float(self.act, self._bn(y), self.nb)


class I8FirstDense(FloatDenseBits):
    """Float first dense (MLP): f32 matmul (+bias, TF32 off) -> BN -> int8
    activation codes."""

    def __init__(self, w, bias, bn_scale, bn_bias, bn_mean, bn_var,
                 bn_eps: float = 1e-4, act: str = "pm1", nb: int = 1):
        super().__init__(w, bias, bn_scale, bn_bias, bn_mean, bn_var, bn_eps)
        self.act = _check_act(act)
        self.nb = nb

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _encode_float(self.act, self._bn(self.dense(x)), self.nb)


class I8Conv(nn.Module):
    """Hidden int8 conv: 3x3 conv + integer threshold (+2x2 pool of the
    codes), in one launch of kernel E.  ``w8`` keeps the JAX converter's
    layout; ``wk`` is the same weights K-major, made once here, which the
    kernel reads."""

    def __init__(self, w8, sgn, tau, act: str = "pm1", pool: bool = False):
        super().__init__()
        self.register_buffer("w8", w8)    # (3, 3, C, N) int8
        self.register_buffer("wk", k_major(w8))  # (N, 9 Cp) int8
        self.register_buffer("sgn", sgn)  # (N,) int32
        self.register_buffer("tau", tau)  # (N,) or (L, N) int32
        self.act = _check_act(act)
        self.pool = pool

    def forward(self, x8: torch.Tensor) -> torch.Tensor:
        return i8_conv_fused(x8, self.w8, self.sgn, self.tau,
                             encoding=self.act, pool=self.pool, wk=self.wk)


class I8Dense(nn.Module):
    """Hidden int8 dense: int8 product -> int32 s -> threshold codes."""

    def __init__(self, w8, sgn, tau, act: str = "pm1"):
        super().__init__()
        self.register_buffer("w8", _column_major(w8))  # (K, N) int8
        self.register_buffer("sgn", sgn)
        self.register_buffer("tau", tau)
        self.act = _check_act(act)

    def scores(self, x8: torch.Tensor) -> torch.Tensor:
        """The layer's int32 s."""
        return _dot_i8(x8, self.w8)

    def forward(self, x8: torch.Tensor) -> torch.Tensor:
        return act_epilogue(self.act, self.scores(x8), self.sgn, self.tau)


class I8DenseLogits(nn.Module):
    """int8 head: int8 product -> int32 s -> logits a*s + c, rounded once
    as XLA's fused multiply-add is."""

    def __init__(self, w8, a, c):
        super().__init__()
        self.register_buffer("w8", _column_major(w8))  # (K, N) int8
        self.register_buffer("a", a)    # (N,) f32
        self.register_buffer("c", c)    # (N,) f32

    def scores(self, x8: torch.Tensor) -> torch.Tensor:
        """The head's int32 s."""
        return _dot_i8(x8, self.w8)

    def logits(self, s: torch.Tensor) -> torch.Tensor:
        return affine(self.a, s, self.c)

    def forward(self, x8: torch.Tensor) -> torch.Tensor:
        return self.logits(self.scores(x8))


class I8FloatHead(_BatchNorm):
    """Float head: codes * q -> f32 matmul (+bias, TF32 off) -> BN (q = 1
    for pm1 and zo, 2^(1-nb) for levels and tanh)."""

    def __init__(self, w, bias, bn_scale, bn_bias, bn_mean, bn_var,
                 bn_eps: float = 1e-4, q: float = 1.0):
        super().__init__(bn_scale, bn_bias, bn_mean, bn_var, bn_eps)
        self.register_buffer("w", w)        # (K, N) f32
        self.register_buffer("bias", bias)  # (N,) f32 or None
        self.q = q  # level step; 1 for pm1

    def forward(self, x8: torch.Tensor) -> torch.Tensor:
        x = x8.to(torch.float32) * self.q
        with _ieee_f32():
            y = x @ self.w
        if self.bias is not None:
            y = y + self.bias
        return self._bn(y)


class _Dequantized(_BatchNorm):
    """A relu network type's layer: weights ``w`` (int8 grid integers, or
    float32 for a float boundary layer) times the scalar ``alpha``, made
    float at each call; ``alpha * z`` is the fake-quant weight bit for bit
    (both are H * z * 2^-(nb-1), and a pow2 scale is exact in float32)."""

    def __init__(self, w, alpha, bias, bn_scale, bn_bias, bn_mean, bn_var,
                 bn_eps: float = 1e-4):
        super().__init__(bn_scale, bn_bias, bn_mean, bn_var, bn_eps)
        self.register_buffer("w", w)          # int8 or f32, JAX layout
        self.register_buffer("alpha", alpha)  # () f32
        self.register_buffer("bias", bias)    # (N,) f32 or None

    def weights(self) -> torch.Tensor:
        return self.w.to(torch.float32) * self.alpha

    def _dense(self, x: torch.Tensor) -> torch.Tensor:
        """x @ (alpha w) (+bias), TF32 off."""
        with _ieee_f32():
            y = x @ self.weights()
        return y if self.bias is None else y + self.bias


class I8WDense(_Dequantized):
    """Relu network types' dense layer: float x @ (alpha w) (+bias, TF32
    off) -> BN -> relu."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self._bn(self._dense(x)))


class I8WConv(_Dequantized):
    """Relu network types' conv: float 'SAME' conv with alpha w (+bias,
    TF32 off) -> [2x2 pool] -> BN -> relu, the training graph's order."""

    def __init__(self, w, alpha, bias, bn_scale, bn_bias, bn_mean, bn_var,
                 bn_eps: float = 1e-4, pool: bool = False):
        super().__init__(w, alpha, bias, bn_scale, bn_bias, bn_mean, bn_var,
                         bn_eps)
        self.pool = pool

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _conv_same(x, self.weights(), self.bias)
        if self.pool:
            y = _maxpool2(y)
        return torch.relu(self._bn(y))


class I8WHead(_Dequantized):
    """Relu network types' head: logits = BN(x @ (alpha w) + bias)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._bn(self._dense(x))


class I8MLP(nn.Module):
    """flatten -> I8FirstDense (or I8WDense) -> hidden I8Dense (or I8WDense)
    layers -> head."""

    def __init__(self, first: I8FirstDense, hidden, head):
        super().__init__()
        self.first = first
        self.hidden = nn.ModuleList(hidden)
        self.head = head

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x8 = self.first(images.reshape(images.shape[0], -1))
        for layer in self.hidden:
            x8 = layer(x8)
        return self.head(x8)


class I8VGG(nn.Module):
    """I8FirstConv -> 5 I8Conv (kernel E) -> NHWC flatten -> 2 I8Dense ->
    head; or, for the relu network types, 6 I8WConv -> flatten -> 2
    I8WDense -> I8WHead."""

    def __init__(self, first: I8FirstConv, convs, denses, head):
        super().__init__()
        self.first = first
        self.convs = nn.ModuleList(convs)
        self.denses = nn.ModuleList(denses)
        self.head = head

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x8 = self.first(images)
        for layer in self.convs:
            x8 = layer(x8)
        x8 = x8.reshape(x8.shape[0], -1)
        for layer in self.denses:
            x8 = layer(x8)
        return self.head(x8)


def i8_forward(model: nn.Module, images: torch.Tensor) -> torch.Tensor:
    """int8 engine forward: images in [-1, 1] -> logits."""
    with torch.inference_mode():
        return model(images)
