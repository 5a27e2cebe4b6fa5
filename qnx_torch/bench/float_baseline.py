"""Float twin of the engines' architectures, the benchmark's yardstick (torch
port of :mod:`qnx.bench.float_baseline`).

The same MLP and VGG as the quantized models, with relu activations and
BinaryNet's layer order, as plain torch ops with no precision of their own:
they inherit the caller's TF32 settings, as the JAX functions inherit
``jax.default_matmul_precision``.  The strict-f32 baseline of ``bench.py``
(``"highest"``) is

    with strict_f32():
        logits = float_forward(variables, cf, x)

with TF32 off for cuBLAS and cuDNN (cuDNN allows TF32 by default).  It
consumes the variables of ``init_variables(cf.replace(network_type="float"),
seed)`` (:mod:`qnx_torch.models.factory`): numpy leaves, or tensors on
``x``'s device from :func:`float_variables`, which a timing loop converts
once.  Nothing on the serving path calls it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from qnx_torch.nn.inference import _ieee_f32, _maxpool2

#: TF32 off for cuBLAS and cuDNN around the ops inside, the counterpart of
#: ``jax.default_matmul_precision("highest")``.
strict_f32 = _ieee_f32


def float_variables(variables: dict, device) -> dict:
    """The variables tree with every leaf a tensor on ``device``."""
    return {k: float_variables(v, device) if isinstance(v, dict)
            else torch.as_tensor(v, device=device) for k, v in variables.items()}


def _bn(params, stats, name, eps, x):
    p, s = params[name], stats[name]
    mul = torch.rsqrt(s["var"] + eps) * p["scale"]
    return (x - s["mean"]) * mul + p["bias"]


def _dense(params, name, x):
    y = x @ params[name]["kernel"]
    if "bias" in params[name]:
        y = y + params[name]["bias"]
    return y


def _conv(params, name, x):
    """'SAME' 3x3 stride-1 conv, NHWC x HWIO -> NHWC (+bias)."""
    k = params[name]["kernel"]
    y = F.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1),
                 padding=(k.shape[0] // 2, k.shape[1] // 2)).permute(0, 2, 3, 1)
    if "bias" in params[name]:
        y = y + params[name]["bias"]
    return y


def float_forward(variables: dict, cf, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode forward of the float twin (relu activations, BinaryNet
    layer order: conv -> [pool] -> BN -> relu), TF32 as the caller set it."""
    v = float_variables(variables, x.device)
    params, stats = v["params"], v["batch_stats"]
    eps = cf.batch_norm_epsilon
    if cf.architecture == "mlp":
        x = x.reshape(x.shape[0], -1)
        for i in range(cf.num_hidden):
            x = torch.relu(_bn(params, stats, f"bn_{i}", eps,
                               _dense(params, f"dense_{i}", x)))
        return _bn(params, stats, "bn_out", eps, _dense(params, "dense_out", x))
    if cf.architecture == "vgg":
        for i in range(6):
            y = _conv(params, f"conv_{i}", x)
            if i % 2 == 1:
                y = _maxpool2(y)
            x = torch.relu(_bn(params, stats, f"bn_conv_{i}", eps, y))
        x = x.reshape(x.shape[0], -1)
        for j in range(2):
            x = torch.relu(_bn(params, stats, f"bn_dense_{j}", eps,
                               _dense(params, f"dense_{j}", x)))
        return _bn(params, stats, "bn_out", eps, _dense(params, "dense_out", x))
    raise ValueError(f"unknown architecture {cf.architecture!r}")
