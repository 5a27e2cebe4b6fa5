"""Forward values of the fake-quant ops (torch port of the forward of
:mod:`qnx.ops.quant`: ``round_through``, ``clip_through``,
``hard_sigmoid``, ``binary_sigmoid``, ``quantize``, ``quantized_relu`` and
``quantized_tanh``).

The engines use them only to encode a float layer's output as integer
codes, and the tests to hold the converters' weight grids to the
quantizer, so only the forward is here; the straight-through gradients
come with fake-quant training (ROADMAP.md §1 item 12).  Each op keeps the
JAX expression's float32 operations in their order, so the values agree bit
for bit: ``round_through(x)`` is ``x + (round(x) - x)``, not ``round(x)``.
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import torch


def round_through(x: torch.Tensor) -> torch.Tensor:
    """Forward of the rounding STE: ``x + (round(x) - x)``, ties to even."""
    return x + (torch.round(x) - x)


def clip_through(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Forward of the clipping STE: ``x + (clip(x, lo, hi) - x)``."""
    return x + (torch.clamp(x, lo, hi) - x)


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """clip((x + 1) / 2, 0, 1)."""
    return torch.clamp((x + 1.0) / 2.0, 0.0, 1.0)


def binary_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """{0, 1}: ``round_through(hard_sigmoid(x))``, 1 iff x > 0."""
    return round_through(hard_sigmoid(x))


def quantize(w: torch.Tensor, nb: int = 16, H: float = 1.0) -> torch.Tensor:
    """n-bit pow2-grid weight quantizer on [-H, H):
    ``H * clip(round(w / H * m), -m, m - 1) / m``, m = 2^(nb-1)."""
    m = float(2 ** (nb - 1))
    q = clip_through(round_through(w / H * m), -m, m - 1) / m
    return H * q


def quantized_relu(x: torch.Tensor, nb: int = 16) -> torch.Tensor:
    """n-bit activation on [0, 1 - 2^(1-nb)]: 2^(nb-1) levels spaced
    2^(1-nb) apart, ``clip(2*round(hard_sigmoid(x)*2^nb)/2^nb - 1, ...)``."""
    m = float(2**nb)
    q = 2.0 * (round_through(hard_sigmoid(x) * m) / m) - 1.0
    return clip_through(q, 0.0, 1.0 - 2.0 ** (1 - nb))


def quantized_tanh(x: torch.Tensor, nb: int = 16) -> torch.Tensor:
    """n-bit symmetric activation on ±(1 - 2^(1-nb)): the levels of
    :func:`quantized_relu` before its clip, clipped on both sides."""
    m = float(2**nb)
    q = 2.0 * (round_through(hard_sigmoid(x) * m) / m) - 1.0
    lim = 1.0 - 2.0 ** (1 - nb)
    return clip_through(q, -lim, lim)
