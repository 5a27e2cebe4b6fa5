"""Fake-quant (STE) training layers (torch port of :mod:`qnx.train.layers`).

The layer zoo of the reference framework: ``BinaryDense``,
``TernaryDense``, ``QuantizedDense``, ``BinaryConv2D``, ``TernaryConv2D``,
``QuantizedConv2D``, the float ``FloatDense`` and ``FloatConv2D``, and
:func:`make_activation`; plus the two flax.linen layers the models use,
:class:`BatchNorm` and :class:`Dropout`, with flax's semantics.

Each quantized layer holds its latent float kernel (the trainable
parameter, quantized on every forward) and, as 0-d float32 buffers, its
resolved weight scale ``H`` and ``lr_mult`` (1/H unless
``kernel_lr_multiplier`` is given): the JAX package's ``quant`` collection,
which the train loop's Clip constraint and gradient scaling and the
converters read.

Layouts are flax's, so a variables tree moves between the two packages
without a transpose: activations NHWC, dense kernels (in, out), conv
kernels HWIO.  The convs run ``F.conv2d`` on NCHW views of the NHWC
tensors (channels-last strides, which cuDNN takes as they are).  Every
matmul and conv runs in IEEE float32 (TF32 off) in the forward and in the
backward: :class:`_Matmul` and :class:`_Conv` are autograd functions whose
backward calls cuBLAS and cuDNN inside ``_ieee_f32`` too, since
``loss.backward()`` runs after any ``with`` block around the forward has
closed.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from qnx_torch.nn.inference import _ieee_f32
from qnx_torch.ops import quant as Q


def _resolve_h(H, fan_in: int, fan_out: int) -> float:
    if isinstance(H, str):
        if H.lower() == "glorot":
            return Q.glorot_scale(fan_in, fan_out)
        raise ValueError(f"unknown H spec {H!r}")
    return float(H)


class _Matmul(torch.autograd.Function):
    """(B, K) x (K, N) in IEEE float32, forward and backward."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        with _ieee_f32():
            return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        with _ieee_f32():
            if ctx.needs_input_grad[0]:
                gx = g @ w.t()
            if ctx.needs_input_grad[1]:
                gw = x.t() @ g
        return gx, gw


class _Conv(torch.autograd.Function):
    """NHWC x HWIO -> NHWC conv in IEEE float32, forward and backward
    (``aten.convolution_backward``, cuDNN on the card)."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        with _ieee_f32():
            y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                         stride=stride, padding=padding)
        return y.permute(0, 2, 3, 1)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False]
        with _ieee_f32():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2),
                w.permute(3, 2, 0, 1), None, list(ctx.stride),
                list(ctx.padding), [1, 1], False, [0, 0], 1, mask)
        return (None if gx is None else gx.permute(0, 2, 3, 1),
                None if gw is None else gw.permute(2, 3, 1, 0), None, None)


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """'SAME' padding (lo, hi) of one spatial dim, as XLA computes it."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, w: torch.Tensor, strides=(1, 1),
           padding: str = "SAME") -> torch.Tensor:
    """NHWC x HWIO conv, 'SAME' or 'VALID', IEEE float32 both ways: the
    counterpart of ``qnx.train.layers._conv``."""
    strides = tuple(strides)
    if padding == "VALID":
        return _Conv.apply(x, w, strides, (0, 0))
    if padding != "SAME":
        raise ValueError(f"unknown padding {padding!r}")
    (ht, hb), (wl, wr) = (_same_pads(x.shape[1], w.shape[0], strides[0]),
                          _same_pads(x.shape[2], w.shape[1], strides[1]))
    if (ht, wl) != (hb, wr):  # XLA pads the extra row/column at the end
        x = F.pad(x, (0, 0, wl, wr, ht, hb))
        ht = wl = 0
    return _Conv.apply(x, w, strides, (ht, wl))


def _fill_uniform(t: torch.Tensor, lim: float, generator) -> None:
    with torch.no_grad():
        t.uniform_(-lim, lim, generator=generator)


class _QuantKernel(nn.Module):
    """Latent kernel + the resolved ``H`` and ``lr_mult`` buffers (the JAX
    package's ``_QuantKernelMixin``), and the optional zero-initialised
    bias."""

    def __init__(self, shape: Sequence[int], fan_in: int, fan_out: int, H,
                 kernel_lr_multiplier, use_bias: bool):
        super().__init__()
        h = _resolve_h(H, fan_in, fan_out)
        lr_mult = (1.0 / h if kernel_lr_multiplier is None
                   else float(kernel_lr_multiplier))
        self.kernel = nn.Parameter(torch.empty(tuple(shape)))
        self.bias = nn.Parameter(torch.zeros(shape[-1])) if use_bias else None
        self.register_buffer("H", torch.tensor(h, dtype=torch.float32))
        self.register_buffer("lr_mult", torch.tensor(lr_mult, dtype=torch.float32))
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        """flax's initial values: the latent kernel uniform in ±H (float32
        H), the bias 0."""
        _fill_uniform(self.kernel, float(self.H), generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def _quantized(self, generator) -> torch.Tensor:
        raise NotImplementedError

    def _add_bias(self, y: torch.Tensor) -> torch.Tensor:
        return y if self.bias is None else y + self.bias


class _QuantDense(_QuantKernel):
    def __init__(self, in_features: int, features: int, H="Glorot",
                 use_bias: bool = False, kernel_lr_multiplier=None):
        super().__init__((in_features, features), in_features, features, H,
                         kernel_lr_multiplier, use_bias)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        return self._add_bias(_Matmul.apply(x, self._quantized(generator)))


class _QuantConv(_QuantKernel):
    def __init__(self, in_channels: int, features: int, kernel_size=(3, 3),
                 strides=(1, 1), padding: str = "SAME", H="Glorot",
                 use_bias: bool = False, kernel_lr_multiplier=None):
        kh, kw = kernel_size
        super().__init__((kh, kw, in_channels, features), kh * kw * in_channels,
                         kh * kw * features, H, kernel_lr_multiplier, use_bias)
        self.strides, self.padding = tuple(strides), padding

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        y = conv2d(x, self._quantized(generator), self.strides, self.padding)
        return self._add_bias(y)


class _Binary:
    """{-H, +H} weights (BinaryConnect).  With ``stochastic`` and a
    generator (training), Wb = +H with probability hard_sigmoid(w/H);
    without a generator, the deterministic sign, BinaryConnect's test-time
    rule."""

    stochastic: bool

    def _quantized(self, generator):
        if self.stochastic and generator is not None:
            return Q.binarize_stochastic(self.kernel, generator, self.H)
        return Q.binarize(self.kernel, self.H)


class _Ternary:
    """{-H, 0, +H} weights: ``style='dingke'`` thresholds at ±0.5 H,
    ``'twn'`` at 0.7 E|W| with scale alpha (arXiv:1605.04711)."""

    style: str

    def _quantized(self, generator):
        if self.style == "dingke":
            return Q.ternarize(self.kernel, self.H)
        return Q.ternarize_twn(self.kernel)


class _Grid:
    """nb-bit pow2-grid weights."""

    nb: int

    def _quantized(self, generator):
        return Q.quantize(self.kernel, self.nb, self.H)


class BinaryDense(_Binary, _QuantDense):
    def __init__(self, in_features: int, features: int, H="Glorot",
                 use_bias: bool = False, stochastic: bool = False,
                 kernel_lr_multiplier=None):
        super().__init__(in_features, features, H, use_bias, kernel_lr_multiplier)
        self.stochastic = stochastic


class TernaryDense(_Ternary, _QuantDense):
    def __init__(self, in_features: int, features: int, H="Glorot",
                 use_bias: bool = False, style: str = "dingke",
                 kernel_lr_multiplier=None):
        super().__init__(in_features, features, H, use_bias, kernel_lr_multiplier)
        self.style = style


class QuantizedDense(_Grid, _QuantDense):
    def __init__(self, in_features: int, features: int, nb: int = 4,
                 H="Glorot", use_bias: bool = False, kernel_lr_multiplier=None):
        super().__init__(in_features, features, H, use_bias, kernel_lr_multiplier)
        self.nb = nb


class BinaryConv2D(_Binary, _QuantConv):
    def __init__(self, in_channels: int, features: int, stochastic: bool = False,
                 **kw):
        super().__init__(in_channels, features, **kw)
        self.stochastic = stochastic


class TernaryConv2D(_Ternary, _QuantConv):
    def __init__(self, in_channels: int, features: int, style: str = "dingke",
                 **kw):
        super().__init__(in_channels, features, **kw)
        self.style = style


class QuantizedConv2D(_Grid, _QuantConv):
    def __init__(self, in_channels: int, features: int, nb: int = 4, **kw):
        super().__init__(in_channels, features, **kw)
        self.nb = nb


def _glorot_uniform(t: torch.Tensor, fan_in: int, fan_out: int, generator) -> None:
    """flax's ``glorot_uniform``: uniform in ±sqrt(6 / (fan_in + fan_out))."""
    _fill_uniform(t, math.sqrt(6.0 / (fan_in + fan_out)), generator)


class FloatDense(nn.Module):
    """Plain float dense (network_type 'float' and the boundary layers)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        _glorot_uniform(self.kernel, *self.kernel.shape, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        y = _Matmul.apply(x, self.kernel)
        return y if self.bias is None else y + self.bias


class FloatConv2D(nn.Module):
    """Plain float conv (the float first layer of the CIFAR models)."""

    def __init__(self, in_channels: int, features: int, kernel_size=(3, 3),
                 strides=(1, 1), padding: str = "SAME", use_bias: bool = True):
        super().__init__()
        kh, kw = kernel_size
        self.kernel = nn.Parameter(torch.empty(kh, kw, in_channels, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.strides, self.padding = tuple(strides), padding
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        kh, kw, cin, cout = self.kernel.shape
        _glorot_uniform(self.kernel, kh * kw * cin, kh * kw * cout, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        y = conv2d(x, self.kernel, self.strides, self.padding)
        return y if self.bias is None else y + self.bias


class BatchNorm(nn.Module):
    """flax.linen ``BatchNorm`` over the last axis (``torch.nn.BatchNorm*``
    is not it).

    Training normalises with the batch's biased variance computed as
    ``max(0, mean(x^2) - mean(x)^2)`` (flax's ``use_fast_variance``) and
    moves the running statistics by ``ra <- momentum * ra + (1 - momentum)
    * batch`` with that same variance (torch's layer would use the unbiased
    one, and its ``momentum`` is flax's ``1 - momentum``).  Both modes
    apply ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in flax's op
    order.  Parameters ``scale`` and ``bias``; buffers ``mean`` and
    ``var``, the ``batch_stats`` collection."""

    def __init__(self, features: int, momentum: float = 0.99,
                 epsilon: float = 1e-5):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            axes = tuple(range(x.dim() - 1))
            mean = x.mean(axes)
            var = torch.clamp(x.square().mean(axes) - mean.square(), min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return (x - mean) * mul + self.bias


def dropout(x: torch.Tensor, rate: float, generator) -> torch.Tensor:
    """flax.linen ``Dropout`` in training: keep with probability 1 - rate,
    drawn from ``generator``, and scale the kept values by 1 / (1 - rate)."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a generator (flax: a "
                         "'dropout' PRNG key)")
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    mask = torch.bernoulli(torch.full_like(x, keep), generator=generator)
    return torch.where(mask > 0, x / keep, 0.0)


def make_activation(name: str, abits: int = 1) -> Callable[[torch.Tensor], torch.Tensor]:
    """The activation of a network type: 'binary' / 'binary_tanh' ->
    binary_tanh, 'binary_sigmoid', 'quant' / 'ternary' / 'quantized_relu'
    -> quantized_relu(abits), 'quantized_tanh' -> quantized_tanh(abits),
    'relu', 'none'."""
    if name in ("binary", "binary_tanh"):
        return Q.binary_tanh
    if name == "binary_sigmoid":
        return Q.binary_sigmoid
    if name in ("quant", "ternary", "quantized_relu"):
        return lambda x: Q.quantized_relu(x, abits)
    if name == "quantized_tanh":
        return lambda x: Q.quantized_tanh(x, abits)
    if name == "relu":
        return torch.relu
    if name == "none":
        return lambda x: x
    raise ValueError(f"unknown activation {name!r}")
