"""Numpy counterpart of :func:`qnx.models.factory.init_model`: random
variables with the tree, names, shapes and dtypes of flax ``QuantVGG`` and
``QuantMLP``, made without jax so a CUDA host without jax can build a model.

The draws do not equal jax's.  They are chosen so the packed engine's whole
epilogue is exercised: latent kernels uniform in ±H (H by the Glorot rule of
:mod:`qnx.train.layers` unless ``cf.H`` is a number), float kernels
glorot-uniform, and BatchNorm parameters and statistics drawn around the
scale of each layer's pre-activation, with ``scale`` of both signs (so
``sgn = -1`` channels occur, also under the pool) and two channels of every
binary-threshold BN at ``scale = 0`` (constant bits: ``tau`` at
``INT32_MIN`` and ``INT32_MAX``).
"""
from __future__ import annotations

import math

import numpy as np

from qnx_torch.utils.config import Config


def glorot_scale(fan_in: int, fan_out: int) -> float:
    """H = sqrt(1.5/(fan_in+fan_out)), as :func:`qnx.ops.quant.glorot_scale`."""
    return math.sqrt(1.5 / (fan_in + fan_out))


def _resolve_h(H, fan_in: int, fan_out: int) -> float:
    if isinstance(H, str):
        if H.lower() == "glorot":
            return glorot_scale(fan_in, fan_out)
        raise ValueError(f"unknown H spec {H!r}")
    return float(H)


def init_variables(cf: Config, seed: int) -> dict:
    """Random ``{"params", "quant", "batch_stats"}`` numpy variables of a VGG
    or MLP config, from ``np.random.default_rng(seed)``."""
    if cf.architecture not in ("vgg", "mlp"):
        raise ValueError(f"unknown architecture {cf.architecture!r}")
    rng = np.random.default_rng(seed)
    params: dict = {}
    quant: dict = {}
    stats: dict = {}
    all_float = cf.weight_quantizer_name() == "float"

    def f32(x):
        return np.asarray(x, np.float32)

    def layer(name, shape, fan_in, fan_out, is_float):
        """Kernel (+bias) of one layer; returns the scale of its output."""
        if is_float:  # flax FloatDense/FloatConv2D: glorot_uniform, bias
            lim = math.sqrt(6.0 / (fan_in + fan_out))
            sigma = lim * math.sqrt(fan_in / 3.0)
            params[name] = {"kernel": f32(rng.uniform(-lim, lim, shape)),
                            "bias": f32(rng.normal(0.0, 0.1 * sigma, shape[-1]))}
            return sigma
        h = _resolve_h(cf.H, fan_in, fan_out)
        params[name] = {"kernel": f32(rng.uniform(-h, h, shape))}
        if cf.use_bias:
            params[name]["bias"] = f32(rng.normal(0.0, 0.1 * h, shape[-1]))
        lr_mult = (1.0 / h if cf.kernel_lr_multiplier is None
                   else float(cf.kernel_lr_multiplier))
        quant[name] = {"H": f32(h), "lr_mult": f32(lr_mult)}
        return h * math.sqrt(fan_in)  # scale of a ±H dot over ±1 inputs

    def batchnorm(name, c, sigma, binary_out):
        scale = rng.uniform(0.5, 1.5, c) * rng.choice([-1.0, 1.0], c)
        bias = rng.normal(0.0, 0.5, c)
        if binary_out:  # constant-bit channels: beta > 0 and beta < 0
            scale[:2] = 0.0
            bias[:2] = [abs(bias[0]) + 0.1, -abs(bias[1]) - 0.1]
        params[name] = {"scale": f32(scale), "bias": f32(bias)}
        stats[name] = {"mean": f32(rng.normal(0.0, 0.5 * sigma, c)),
                       "var": f32(sigma**2 * rng.uniform(0.5, 1.5, c))}

    if cf.architecture == "mlp":  # num_hidden dense layers of dim units
        k = math.prod(cf.input_shape)
        for i in range(cf.num_hidden):
            sigma = layer(f"dense_{i}", (k, cf.dim), k, cf.dim, all_float)
            batchnorm(f"bn_{i}", cf.dim, sigma, binary_out=True)
            k = cf.dim
        sigma = layer("dense_out", (k, cf.classes), k, cf.classes,
                      all_float or cf.last_layer_float)
        batchnorm("bn_out", cf.classes, sigma, binary_out=False)
        return {"params": params, "quant": quant, "batch_stats": stats}

    widths = [cf.width, cf.width, 2 * cf.width, 2 * cf.width,
              4 * cf.width, 4 * cf.width]
    cin = cf.input_shape[-1]
    for i, w in enumerate(widths):
        is_float = all_float or (i == 0 and cf.first_layer_float)
        sigma = layer(f"conv_{i}", (3, 3, cin, w), 9 * cin, 9 * w, is_float)
        batchnorm(f"bn_conv_{i}", w, sigma, binary_out=i > 0)
        cin = w
    hin, win, _ = cf.input_shape
    k = (hin // 8) * (win // 8) * cin
    for j in range(2):
        sigma = layer(f"dense_{j}", (k, cf.dense_units), k, cf.dense_units,
                      all_float)
        batchnorm(f"bn_dense_{j}", cf.dense_units, sigma, binary_out=True)
        k = cf.dense_units
    sigma = layer("dense_out", (k, cf.classes), k, cf.classes,
                  all_float or cf.last_layer_float)
    batchnorm("bn_out", cf.classes, sigma, binary_out=False)
    return {"params": params, "quant": quant, "batch_stats": stats}
