"""Straight-through-estimator (STE) fake-quantization ops (torch port of
:mod:`qnx.ops.quant`).

The forward values keep the JAX expressions' float32 operations in their
order, so they agree bit for bit: ``round_through(x)`` is
``x + (round(x) - x)``, not ``round(x)``.  The gradients are the JAX
package's: ``.detach()`` stands for ``lax.stop_gradient`` (``_sg``), so
``round_through`` and ``clip_through`` pass the gradient unchanged, and
:func:`hard_sigmoid` is a ``torch.autograd.Function`` whose backward is
``0.5 * 1[-1 <= x <= 1]``, inclusive at exactly ±1, as the JAX custom JVP.

Tie-breaking contract: ``torch.round`` rounds half to even, as
``jnp.round``, so ``binary_tanh(0) = 2*round(0.5) - 1 = -1``: the sign bit
is +1 iff x > 0, the strict inequality the BN-threshold folding of
:mod:`qnx_torch.transforms.bn_fold` derives its integer thresholds from.

``H`` may be a Python float or a 0-d float32 tensor (the quantized layers
pass their ``H`` buffer).  On a CUDA tensor, division by a Python scalar is
a multiplication by its reciprocal, which is not IEEE division; a 0-d
tensor on the device divides exactly, as numpy and XLA do.

The counterpart of ``REFERENCE_PRECISION`` (IEEE float32 matmuls and
convs) is TF32 off: :func:`qnx_torch.nn.inference._ieee_f32`, which the
fake-quant layers (:mod:`qnx_torch.train.layers`) hold around their
matmuls and convs in the forward and in the backward.
"""
from __future__ import annotations

import math

import torch


def round_through(x: torch.Tensor) -> torch.Tensor:
    """Round with identity gradient (STE): ``x + sg(round(x) - x)``, ties
    to even."""
    return x + (torch.round(x) - x).detach()


def clip_through(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Clip with identity gradient (STE): ``x + sg(clip(x, lo, hi) - x)``."""
    return x + (torch.clamp(x, lo, hi) - x).detach()


class _HardSigmoid(torch.autograd.Function):
    """clip((x + 1) / 2, 0, 1) with the JAX custom JVP's gradient
    ``0.5 * 1[-1 <= x <= 1]`` (``torch.clamp``'s own would be 0.25 at
    exactly |x| = 1)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp((x + 1.0) / 2.0, 0.0, 1.0)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        mask = ((x >= -1.0) & (x <= 1.0)).to(g.dtype)
        return g * 0.5 * mask


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """clip((x + 1) / 2, 0, 1); gradient 0.5 on [-1, 1], 0 outside."""
    return _HardSigmoid.apply(x)


def binary_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """{0, 1}: ``round_through(hard_sigmoid(x))``, 1 iff x > 0; hard-sigmoid
    STE backward."""
    return round_through(hard_sigmoid(x))


def binary_tanh(x: torch.Tensor) -> torch.Tensor:
    """{-1, +1}, +1 iff x > 0 (``binary_tanh(0) = -1``); backward
    ``1[|x| <= 1]``."""
    return 2.0 * round_through(hard_sigmoid(x)) - 1.0


def binarize(w: torch.Tensor, H=1.0) -> torch.Tensor:
    """Deterministic weight binarization: {-H, +H} forward, STE backward
    saturated outside [-H, H] (BinaryConnect arXiv:1511.00363 §2.3)."""
    return H * binary_tanh(w / H)


def binarize_stochastic(w: torch.Tensor, generator: torch.Generator,
                        H=1.0) -> torch.Tensor:
    """Stochastic weight binarization (BinaryConnect §1.2): +H with
    probability hard_sigmoid(w/H), else -H, drawn by ``torch.bernoulli``
    from ``generator`` (on ``w``'s device); the backward is the saturating
    STE of :func:`binarize`, through the surrogate
    ``H * (2 * hard_sigmoid(w / H) - 1)``.  Training only: evaluation uses
    :func:`binarize`.

    The value is ``wb + (surrogate - sg(surrogate))``, exactly ±H; the JAX
    op's ``surrogate + sg(wb - surrogate)`` is an ulp off ±H where the draw
    and the surrogate differ in sign.  The gradients are equal."""
    p = hard_sigmoid(w / H).detach()
    bits = torch.bernoulli(p, generator=generator)
    hv = torch.as_tensor(H, dtype=w.dtype, device=w.device)
    wb = torch.where(bits > 0, hv, -hv)
    surrogate = H * (2.0 * hard_sigmoid(w / H) - 1.0)
    return wb + (surrogate - surrogate.detach())


def ternarize(w: torch.Tensor, H=1.0) -> torch.Tensor:
    """DingKe ternarization: +H where w/H > 0.5, -H where w/H <= -0.5, else
    0; backward the identity (the latent w is clipped first by
    ``clip_through``, which passes the gradient everywhere, as the JAX
    op's)."""
    hv = torch.as_tensor(H, dtype=w.dtype, device=w.device)
    wc = clip_through(w, -hv, hv)
    r = wc / H
    tern = torch.where(r > 0.5, hv, torch.where(r <= -0.5, -hv, 0.0))
    return wc + (tern - wc).detach()


def ternarize_twn(w: torch.Tensor, _H=1.0) -> torch.Tensor:
    """TWN ternarization (arXiv:1605.04711): threshold
    delta = 0.7 * E|W|, scale alpha = E[|w_i| : |w_i| > delta]; identity
    gradient."""
    delta = 0.7 * torch.mean(torch.abs(w))
    mask = torch.abs(w) > delta
    nnz = torch.clamp(mask.sum(), min=1)
    alpha = torch.where(mask, torch.abs(w), 0.0).sum() / nnz
    tern = torch.where(mask, alpha * torch.sign(w), 0.0)
    return w + (tern - w).detach()


def quantize(w: torch.Tensor, nb: int = 16, H=1.0) -> torch.Tensor:
    """n-bit pow2-grid weight fake quant on [-H, H):
    ``H * clip(round(w / H * m), -m, m - 1) / m``, m = 2^(nb-1); the
    gradient passes straight through."""
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


def glorot_scale(fan_in: int, fan_out: int) -> float:
    """H = sqrt(1.5 / (fan_in + fan_out)), the weight scale of the quantized
    layers when H = 'Glorot'."""
    return math.sqrt(1.5 / (fan_in + fan_out))


def clip_weights(w: torch.Tensor, H=1.0) -> torch.Tensor:
    """The Clip weight constraint applied after each optimizer update:
    latent w <- clip(w, -H, H)."""
    return torch.clamp(w, -H, H)
