"""Model zoo (torch port of :mod:`qnx.models.factory`): ``build_model(cf)``
and ``init_model(cf, seed)``, the fake-quant ``QuantMLP`` and ``QuantVGG``;
``load_variables`` and ``export_variables``, which carry weights between a
module and the JAX package's variables tree; and ``init_variables``, numpy
variables for the engines' tests.

Two families, as the reference's:

* ``mlp``: the BinaryNet MNIST MLP (arXiv:1602.02830 §2), ``num_hidden``
  dense layers of ``dim`` units, each Dense -> BatchNorm -> activation
  (-> Dropout), then a Dense -> BatchNorm head (squared-hinge logits);
* ``vgg``: the BinaryNet CIFAR-10/SVHN ConvNet, three double-conv blocks
  (width, 2 width, 4 width channels) with 2x2 max pool, two dense layers
  and the head; a block ends Conv -> MaxPool -> BatchNorm -> activation,
  the pool BEFORE BN and sign, as the packed engine pools the integer conv
  outputs.

Each module holds its layers as children under the flax names
(``conv_0``, ``bn_conv_0``, ..., ``dense_out``, ``bn_out``), so the
variables tree ``{"params", "quant", "batch_stats"}`` (numpy, flax names
and layouts) maps onto the modules' parameters and buffers leaf for leaf;
the VGG flattens its NHWC activations in NHWC order, as JAX does, so
``dense_0``'s rows keep their meaning.  ``export_variables`` gives what
the converters of :mod:`qnx_torch.convert.pack_model` take.

``init_variables`` does not equal flax's draws: it is chosen so that the
packed engine's whole epilogue is exercised: latent kernels uniform in ±H,
float kernels glorot-uniform, and BatchNorm parameters and statistics
drawn around the scale of each layer's pre-activation, with ``scale`` of
both signs (so ``sgn = -1`` channels occur, also under the pool) and two
channels of every binary-threshold BN at ``scale = 0`` (constant bits:
``tau`` at ``INT32_MIN`` and ``INT32_MAX``).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from qnx_torch.train import layers as L
from qnx_torch.train.layers import _resolve_h
from qnx_torch.utils.config import Config


def _dense_layer(cf: Config, in_features: int, features: int, final: bool):
    kind = cf.weight_quantizer_name()
    if (final and cf.last_layer_float) or kind == "float":
        return L.FloatDense(in_features, features, use_bias=True)
    common = dict(H=cf.H, use_bias=cf.use_bias,
                  kernel_lr_multiplier=cf.kernel_lr_multiplier)
    if kind == "binary":
        return L.BinaryDense(in_features, features, stochastic=cf.stochastic,
                             **common)
    if kind == "ternary":
        return L.TernaryDense(in_features, features, style=cf.ternary_style,
                              **common)
    return L.QuantizedDense(in_features, features, nb=cf.wbits, **common)


def _conv_layer(cf: Config, in_channels: int, features: int, first: bool):
    kind = cf.weight_quantizer_name()
    if (first and cf.first_layer_float) or kind == "float":
        return L.FloatConv2D(in_channels, features, (3, 3), use_bias=True)
    common = dict(kernel_size=(3, 3), H=cf.H, use_bias=cf.use_bias,
                  kernel_lr_multiplier=cf.kernel_lr_multiplier)
    if kind == "binary":
        return L.BinaryConv2D(in_channels, features, stochastic=cf.stochastic,
                              **common)
    if kind == "ternary":
        return L.TernaryConv2D(in_channels, features, style=cf.ternary_style,
                               **common)
    return L.QuantizedConv2D(in_channels, features, nb=cf.wbits, **common)


class _QuantModel(nn.Module):
    """Children under their flax names; ``forward(x, train, generator)``.
    ``generator`` feeds dropout and stochastic binarization, in training
    only (the JAX package's 'dropout' and 'quant' PRNG streams)."""

    def __init__(self, cf: Config):
        super().__init__()
        self.cf = cf
        self.act = L.make_activation(cf.activation_name(), cf.abits)

    def _bn(self, features: int) -> L.BatchNorm:
        return L.BatchNorm(features, self.cf.batch_norm_momentum,
                           self.cf.batch_norm_epsilon)

    def _block(self, name: str, bn: str, x, train: bool, generator, pool=False):
        """layer -> [2x2 max pool] -> BN -> activation."""
        x = getattr(self, name)(x, generator if train else None)
        if pool:  # F.max_pool2d routes a tie's gradient to the first max, as XLA
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        return self.act(getattr(self, bn)(x, train))


class QuantMLP(_QuantModel):
    """BinaryNet-style MLP; NHWC images in, flattened."""

    def __init__(self, cf: Config):
        super().__init__(cf)
        k = math.prod(cf.input_shape)
        for i in range(cf.num_hidden):
            self.add_module(f"dense_{i}", _dense_layer(cf, k, cf.dim, False))
            self.add_module(f"bn_{i}", self._bn(cf.dim))
            k = cf.dim
        self.add_module("dense_out", _dense_layer(cf, k, cf.classes, True))
        self.add_module("bn_out", self._bn(cf.classes))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator=None) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for i in range(self.cf.num_hidden):
            x = self._block(f"dense_{i}", f"bn_{i}", x, train, generator)
            if train:
                x = L.dropout(x, self.cf.dropout_rate, generator)
        x = self.dense_out(x, generator if train else None)
        return self.bn_out(x, train)


class QuantVGG(_QuantModel):
    """BinaryNet CIFAR-10/SVHN ConvNet: (2 conv + pool) x 3, 2 dense, head."""

    def __init__(self, cf: Config):
        super().__init__(cf)
        widths = [cf.width, cf.width, 2 * cf.width, 2 * cf.width,
                  4 * cf.width, 4 * cf.width]
        cin = cf.input_shape[-1]
        for i, w in enumerate(widths):
            self.add_module(f"conv_{i}", _conv_layer(cf, cin, w, i == 0))
            self.add_module(f"bn_conv_{i}", self._bn(w))
            cin = w
        h, w, _ = cf.input_shape
        k = (h // 8) * (w // 8) * cin
        for j in range(2):
            self.add_module(f"dense_{j}", _dense_layer(cf, k, cf.dense_units, False))
            self.add_module(f"bn_dense_{j}", self._bn(cf.dense_units))
            k = cf.dense_units
        self.add_module("dense_out", _dense_layer(cf, k, cf.classes, True))
        self.add_module("bn_out", self._bn(cf.classes))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator=None) -> torch.Tensor:
        for i in range(6):
            x = self._block(f"conv_{i}", f"bn_conv_{i}", x, train, generator,
                            pool=i % 2 == 1)
        x = x.reshape(x.shape[0], -1)  # NHWC order, as JAX's flatten
        for j in range(2):
            x = self._block(f"dense_{j}", f"bn_dense_{j}", x, train, generator)
        x = self.dense_out(x, generator if train else None)
        return self.bn_out(x, train)


def build_model(cf: Config) -> nn.Module:
    """The reference's ``build_model(cf) -> keras.Model`` equivalent."""
    if cf.architecture == "mlp":
        return QuantMLP(cf)
    if cf.architecture == "vgg":
        return QuantVGG(cf)
    raise ValueError(f"unknown architecture {cf.architecture!r}")


def init_model(cf: Config, seed: int, device="cuda"):
    """``(module, variables)``, the module on ``device``, with flax's
    initial distribution, drawn from ``torch.Generator().manual_seed(seed)``
    on the CPU layer by layer: latent kernels uniform in ±H, float kernels
    glorot-uniform, biases 0, BN scale 1, bias 0, mean 0, var 1.  The draws
    do not equal jax's."""
    from qnx_torch.convert.pack_model import _check_device

    device = _check_device(device)
    module = build_model(cf)
    g = torch.Generator().manual_seed(seed)
    for layer in module.children():
        layer.reset_parameters(g)
    module = module.to(device)
    return module, export_variables(module)


def tensor_tree(module: nn.Module) -> dict:
    """``{collection: {layer: {leaf: tensor}}}``, the module's own tensors
    under the flax tree's names."""
    tree = {"params": {}, "quant": {}, "batch_stats": {}}
    for name, layer in module.named_children():
        params = dict(layer.named_parameters())
        if params:
            tree["params"][name] = params
        if isinstance(layer, L._QuantKernel):
            tree["quant"][name] = {"H": layer.H, "lr_mult": layer.lr_mult}
        if isinstance(layer, L.BatchNorm):
            tree["batch_stats"][name] = {"mean": layer.mean, "var": layer.var}
    return tree


def export_variables(module: nn.Module) -> dict:
    """The module's weights as the JAX package's variables tree: numpy
    float32, flax names and layouts; what the converters take."""
    return {c: {n: {k: v.detach().cpu().numpy().copy() for k, v in leaves.items()}
                for n, leaves in layers.items()}
            for c, layers in tensor_tree(module).items()}


def load_variables(module: nn.Module, variables: dict) -> nn.Module:
    """Copy a variables tree (numpy or tensors, flax names and layouts) into
    ``module``, in place; every leaf must be present with the same shape,
    and no other."""
    want = tensor_tree(module)
    for c, layers in want.items():
        got = variables.get(c, {})
        if set(got) != set(layers):
            raise ValueError(f"variables[{c!r}] has layers {sorted(got)}, the "
                             f"model {sorted(layers)}")
        for n, leaves in layers.items():
            if set(got[n]) != set(leaves):
                raise ValueError(f"{c}/{n}: leaves {sorted(got[n])}, the model "
                                 f"{sorted(leaves)}")
            for k, t in leaves.items():
                v = got[n][k]
                v = torch.as_tensor(v if isinstance(v, torch.Tensor)
                                    else np.asarray(v), dtype=t.dtype)
                if v.shape != t.shape:
                    raise ValueError(f"{c}/{n}/{k}: shape {tuple(v.shape)}, the "
                                     f"model {tuple(t.shape)}")
                with torch.no_grad():
                    t.copy_(v)
    return module


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
