"""BatchNorm -> per-channel integer threshold and affine folding (torch port
of :func:`qnx.transforms.bn_fold.fold_bn_sign`, ``fold_bn_levels``,
``fold_bn_affine`` and ``fold_affine``, in numpy as the originals).

At inference every hidden block of the binary network is

    s = popcount-GEMM(x_bits, w_bits)        (exact int32, ±1 dot)
    y = gamma * (alpha*s + bias - mu) / sqrt(var + eps) + beta
    out_bit = +1  iff  y > 0                 (strict)

Since s is an integer and everything else is constant per channel, the float
epilogue collapses to one integer comparison:

    out_bit = (sgn[c] * s >= tau[c])

with ``sgn in {+1,-1}`` absorbing the sign of gamma and ``tau = floor(theta)
+ 1`` encoding the strict inequality ``s > theta`` exactly for integer s.
Thresholds are computed in float64 at conversion time.  Degenerate
gamma == 0 channels become constant bits via saturated thresholds.  A logit
head keeps the float epilogue instead, collapsed to ``y = a*s + c0``.
``tests/test_torch_config.py`` holds the folds equal to the JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

INT32_MIN = np.int32(-(2**31))
INT32_MAX = np.int32(2**31 - 1)


@dataclass(frozen=True)
class SignThreshold:
    """Per-channel integer sign test: bit[c] = (sgn[c]*s[c] >= tau[c])."""

    sgn: np.ndarray  # (C,) int32 in {+1, -1}
    tau: np.ndarray  # (C,) int32

    def __iter__(self):  # convenient (sgn, tau) unpacking
        return iter((self.sgn, self.tau))


def _strict_gt_threshold(theta: np.ndarray) -> np.ndarray:
    """Smallest int32 tau with (s >= tau) == (s > theta) for all int s."""
    tau = np.floor(theta) + 1.0
    return np.clip(tau, INT32_MIN, INT32_MAX).astype(np.int64).astype(np.int32)


def fold_bn_sign(gamma, beta, mean, var, eps: float, alpha=1.0,
                 bias=None) -> SignThreshold:
    """Fold BN + strict sign into an integer threshold test.

    Solves  gamma*(alpha*s + bias - mean)/sqrt(var+eps) + beta > 0  for the
    integer GEMM output s, per channel, in float64.
    """
    gamma = np.asarray(gamma, np.float64)
    beta = np.asarray(beta, np.float64)
    mean = np.asarray(mean, np.float64)
    var = np.asarray(var, np.float64)
    alpha = np.broadcast_to(np.asarray(alpha, np.float64), gamma.shape)
    bias = (np.zeros_like(gamma) if bias is None
            else np.broadcast_to(np.asarray(bias, np.float64), gamma.shape))
    if np.any(alpha <= 0):
        raise ValueError(
            "alpha (weight scale) must be positive: the scale is folded into "
            "the threshold by dividing through it, so a non-positive alpha "
            "would flip (or collapse) the comparison direction, which this "
            "fold expresses only via the gamma sign")
    std = np.sqrt(var + eps)
    # y > 0  <=>  gamma * (alpha*s + bias - mean) > -beta * std
    theta = (mean - bias - beta * std / np.where(gamma == 0, 1.0, gamma)) / alpha

    sgn = np.where(gamma >= 0, 1, -1).astype(np.int32)
    tau = np.where(sgn == 1, _strict_gt_threshold(theta),
                   _strict_gt_threshold(-theta)).astype(np.int32)
    # gamma == 0: y = beta, constant bit
    zero = gamma == 0
    sgn = np.where(zero, 1, sgn).astype(np.int32)
    tau = np.where(zero, np.where(beta > 0, INT32_MIN, INT32_MAX),
                   tau).astype(np.int32)
    return SignThreshold(sgn=sgn, tau=tau)


@dataclass(frozen=True)
class LevelThresholds:
    """Multi-level integer quantizer: level[c] = sum_v (sgn[c]*s >= tau[v,c]),
    thresholds ascending in v.  mode='relu' has L-1 = 2^(nb-1)-1 rows
    (quantized_relu: x = q * level); mode='tanh' has 2^nb - 2 rows
    (quantized_tanh: x = q * (level - (2^(nb-1)-1))), q = 2^(1-nb)."""

    sgn: np.ndarray   # (C,) int32 in {+1,-1}
    tau: np.ndarray   # (n_thresholds, C) int32
    q: float          # level step 2^(1-nb)


def fold_bn_levels(gamma, beta, mean, var, eps: float, nb: int, alpha=1.0,
                   bias=None, mode: str = "relu") -> LevelThresholds:
    """Fold BN + an n-bit level quantizer into per-channel integer thresholds.

    mode='relu' (quantized_relu): with y = BN(alpha*s + bias) and
    q = 2^(1-nb), the level l = clip(round(hard_sigmoid(y)*2^nb) - 2^(nb-1),
    0, 2^(nb-1)-1) is monotone in s, and

        l >= v  <=>  y > y_v = 2*(c - 1/2)/2^nb - 1,   c = v + 2^(nb-1)

    mode='tanh' (quantized_tanh): the unsigned index u = level + (L-1) over
    the symmetric grid, u >= v <=> the same test with c = v + 1, 2^nb - 2
    thresholds.  Strict '>' resolves round-half-to-even ties toward the lower
    level.  Thresholds in float64; gamma < 0 folds into sgn = -1 and
    gamma == 0 into saturated thresholds, as in :func:`fold_bn_sign`."""
    gamma = np.asarray(gamma, np.float64)
    beta = np.asarray(beta, np.float64)
    mean = np.asarray(mean, np.float64)
    var = np.asarray(var, np.float64)
    alpha = np.broadcast_to(np.asarray(alpha, np.float64), gamma.shape)
    bias = (np.zeros_like(gamma) if bias is None
            else np.broadcast_to(np.asarray(bias, np.float64), gamma.shape))
    if np.any(alpha <= 0):
        raise ValueError(
            "alpha (weight scale) must be positive: the scale is folded into "
            "the threshold by dividing through it, so a non-positive alpha "
            "would flip (or collapse) the comparison direction, which this "
            "fold expresses only via the gamma sign")
    if mode not in ("relu", "tanh"):
        raise ValueError(f"fold_bn_levels mode must be 'relu' or 'tanh', got {mode!r}")
    n_thresh = 2 ** (nb - 1) - 1 if mode == "relu" else 2**nb - 2
    q = float(2.0 ** (1 - nb))
    std = np.sqrt(var + eps)
    safe_gamma = np.where(gamma == 0, 1.0, gamma)

    sgn = np.where(gamma >= 0, 1, -1).astype(np.int32)
    taus = []
    for v in range(1, n_thresh + 1):
        c = v + 2 ** (nb - 1) if mode == "relu" else v + 1
        y_v = 2.0 * (c - 0.5) / (2.0**nb) - 1.0
        # y > y_v  <=>  gamma*(alpha*s + bias - mean) > (y_v - beta)*std
        theta = (mean - bias + (y_v - beta) * std / safe_gamma) / alpha
        tau_v = np.where(sgn == 1, _strict_gt_threshold(theta),
                         _strict_gt_threshold(-theta))
        # gamma == 0: y = beta constant -> level = const
        zero = gamma == 0
        tau_v = np.where(zero, np.where(beta > y_v, INT32_MIN, INT32_MAX), tau_v)
        taus.append(tau_v.astype(np.int32))
    return LevelThresholds(sgn=sgn, tau=np.stack(taus, axis=0), q=q)


@dataclass(frozen=True)
class AffineEpilogue:
    """Float epilogue for non-sign outputs (logits):
    y[.., c] = a[c] * s[.., c] + c0[c]."""

    a: np.ndarray  # (C,) float32
    c0: np.ndarray  # (C,) float32


def fold_bn_affine(gamma, beta, mean, var, eps, alpha=1.0, bias=None) -> AffineEpilogue:
    """Collapse BN over an integer GEMM output into y = a*s + c0 (float64
    math, float32 result)."""
    gamma = np.asarray(gamma, np.float64)
    beta = np.asarray(beta, np.float64)
    mean = np.asarray(mean, np.float64)
    var = np.asarray(var, np.float64)
    alpha = np.broadcast_to(np.asarray(alpha, np.float64), gamma.shape)
    bias = (np.zeros_like(gamma) if bias is None
            else np.broadcast_to(np.asarray(bias, np.float64), gamma.shape))
    std = np.sqrt(var + eps)
    a = gamma * alpha / std
    c0 = gamma * (bias - mean) / std + beta
    return AffineEpilogue(a=a.astype(np.float32), c0=c0.astype(np.float32))


def fold_affine(alpha=1.0, bias=None, channels: int | None = None) -> AffineEpilogue:
    """No-BN affine epilogue: y = alpha*s + bias."""
    c = channels if channels is not None else np.asarray(bias).shape[0]
    one = np.ones(c)
    return fold_bn_affine(one, np.zeros(c), np.zeros(c), one, 0.0,
                          alpha=alpha, bias=bias)
