"""The BinaryNet CIFAR-10 ConvNet (Courbariaux et al. 2016, arXiv:1602.02830):
its seeded random weights, its plain reference forward and the work of each
of its layers.

    (2x128C3)-MP2-(2x256C3)-MP2-(2x512C3)-MP2-(2x1024FC)-10

A block is conv -> [2x2 max pool] -> BatchNorm -> activation, the pool
before BatchNorm.  The first conv and the head are float; the hidden
layers take quantized weights (binary, or ternary as in TWN, arXiv:
1605.04711) and quantized activations (binary_tanh, or quantized_relu's
levels as in QNN, arXiv:1609.07061).  Widths are ``width`` x (1, 1, 2, 2,
4, 4) for the convs and ``dense_units`` for the two dense layers.

This file is the benchmark's own: it imports nothing of the program, and
the program never sees what it computes.  The variables it makes are the
``{"params", "quant", "batch_stats"}`` numpy tree (flax names and layouts:
HWIO convs, (in, out) dense kernels) that the program's converters take;
the reference works from that same tree and works out for itself whatever
a converter derives from it (weight patterns, folded thresholds, codes).
"""
from __future__ import annotations

import math
from contextlib import contextmanager

import numpy as np
import torch
import torch.nn.functional as F

INPUT_SHAPES = {"CIFAR-10": (32, 32, 3)}


def widths(spec: dict) -> list[int]:
    w = spec["width"]
    return [w, w, 2 * w, 2 * w, 4 * w, 4 * w]


def activation_planes(spec: dict) -> int:
    """Bits of one hidden activation: 1 for binary_tanh, ``abits - 1`` for
    quantized_relu's 2^(abits-1) levels."""
    return 1 if spec["abits"] == 1 else spec["abits"] - 1


def _glorot_h(fan_in: int, fan_out: int) -> float:
    return math.sqrt(1.5 / (fan_in + fan_out))


def _layer_table(spec: dict):
    """(name, bn name, kernel shape, fan_in, fan_out, float?) of each layer,
    in order."""
    h, w, cin = INPUT_SHAPES[spec["dataset"]]
    rows = []
    for i, c in enumerate(widths(spec)):
        is_float = i == 0 and spec["first_layer_float"]
        rows.append((f"conv_{i}", f"bn_conv_{i}", (3, 3, cin, c), 9 * cin,
                     9 * c, is_float))
        cin = c
    k = (h // 8) * (w // 8) * cin
    for j in range(2):
        rows.append((f"dense_{j}", f"bn_dense_{j}", (k, spec["dense_units"]),
                     k, spec["dense_units"], False))
        k = spec["dense_units"]
    rows.append(("dense_out", "bn_out", (k, spec["classes"]), k,
                 spec["classes"], spec["last_layer_float"]))
    return rows


def make_variables(spec: dict, seed: int, device="cuda") -> dict:
    """Random variables of the configuration, from ``seed``, drawn on
    ``device`` in two calls and returned as numpy float32.

    Latent kernels are uniform in +-H (H by the Glorot rule), float kernels
    glorot-uniform with a small bias.  BatchNorm parameters and statistics
    are drawn around the scale of each layer's pre-activation (for a hidden
    layer, from its weight pattern's and input codes' spread), with scales
    of both signs, so that the codes of every hidden layer take both values
    (and negative-scale channels occur under the pools); two channels of
    every hidden BatchNorm have scale 0 and so a constant output, one of
    each sign."""
    rows = _layer_table(spec)
    n_uniform = sum(math.prod(s) + 3 * s[-1] for _, _, s, *_ in rows)
    n_normal = sum(3 * s[-1] for _, _, s, *_ in rows)
    g = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(n_uniform, generator=g, device=device, dtype=torch.float64)
    z = torch.randn(n_normal, generator=g, device=device, dtype=torch.float64)
    u, z = u.cpu().numpy(), z.cpu().numpy()
    at = {"u": 0, "z": 0}

    def take(kind, n):
        src = u if kind == "u" else z
        out = src[at[kind]:at[kind] + n]
        at[kind] += n
        return out

    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    # the variance a MAC adds to a hidden pre-activation: E[t^2] E[a^2]
    # step^2 for weight patterns t and input codes a of step ``step``
    # (ternary t is nonzero half the time; levels taken uniform)
    levels = 2 ** (spec["abits"] - 1)
    spread = ((1.0 if spec["network_type"] == "full-bnn" else 0.5)
              * (1.0 if spec["abits"] == 1 else
                 (levels - 1) * (2 * levels - 1) / 6 * 4.0 ** (1 - spec["abits"])))
    params, quant, stats = {}, {}, {}
    for name, bn, shape, fan_in, fan_out, is_float in rows:
        c = shape[-1]
        if is_float:
            lim = math.sqrt(6.0 / (fan_in + fan_out))
            sigma = lim * math.sqrt(fan_in / 3.0)
            kernel = (2.0 * take("u", math.prod(shape)) - 1.0) * lim
            params[name] = {"kernel": f32(kernel.reshape(shape)),
                            "bias": f32(0.1 * sigma * take("z", c))}
        else:
            h = _glorot_h(fan_in, fan_out)
            kernel = (2.0 * take("u", math.prod(shape)) - 1.0) * h
            params[name] = {"kernel": f32(kernel.reshape(shape))}
            take("z", c)  # the bias a use_bias layer would take
            quant[name] = {"H": f32(h), "lr_mult": f32(1.0 / h)}
            sigma = h * math.sqrt(fan_in * spread)
        scale = (0.5 + take("u", c)) * np.where(take("u", c) < 0.5, -1.0, 1.0)
        bias = 0.5 * take("z", c)
        if name != "dense_out":  # constant-output channels, one of each sign
            scale[:2] = 0.0
            bias[:2] = [abs(bias[0]) + 0.1, -abs(bias[1]) - 0.1]
        params[bn] = {"scale": f32(scale), "bias": f32(bias)}
        stats[bn] = {"mean": f32(0.5 * sigma * take("z", c)),
                     "var": f32(sigma ** 2 * (0.5 + take("u", c)))}
    return {"params": params, "quant": quant, "batch_stats": stats}


# ---------------------------------------------------------------------------
# The plain reference.
# ---------------------------------------------------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 explicit mantissa bits (nearest, ties
    away from zero), as the tensor cores round their operands."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@contextmanager
def _ieee_f32():
    """float32 products in IEEE float32: no TF32 in cuBLAS or cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _float_layer(x, w, precision, conv: bool):
    """The float layers' product: in float64 (``exact``), or with both
    operands rounded to TF32 and summed in float32 (``tf32``, the control:
    the precision one step below the configuration's float32)."""
    if precision == "exact":
        x, w = x.to(torch.float64), w.to(torch.float64)
    elif precision == "tf32":
        x, w = _tf32(x), _tf32(w)
    else:
        raise ValueError(f"unknown precision {precision!r}")
    with _ieee_f32():
        y = F.conv2d(x, w, padding=1) if conv else x @ w
    return y.to(torch.float64)


def _exact_int(x, w, conv: bool):
    """An integer product (codes times weight patterns) computed in float32,
    whose every partial sum is an integer under 2^24 and so exact, rounded
    back to the integer (a Winograd or FFT convolution's error is far under
    one half)."""
    with _ieee_f32():
        y = F.conv2d(x, w, padding=1) if conv else x @ w
    return torch.round(y).to(torch.float64)


def _weight_pattern(spec, latent, h):
    """The quantized weights as (pattern, alpha): binarize is binary_tanh of
    latent / H, in float32 (2 round(clip((w/H + 1)/2, 0, 1)) - 1, ties to
    even); ternarize (the 'dingke' style) is +1 above H/2, -1 at or below
    -H/2, 0 between, with alpha = H."""
    h32 = torch.tensor(h, dtype=torch.float32, device=latent.device)
    if spec["network_type"] == "full-bnn":
        hs = torch.clamp((latent / h32 + 1.0) / 2.0, 0.0, 1.0)
        return 2.0 * torch.round(hs) - 1.0, float(h)
    if spec["network_type"] == "full-tnn" and spec["ternary_style"] == "dingke":
        r = torch.clamp(latent, -h32, h32) / h32
        t = torch.where(r > 0.5, 1.0, torch.where(r <= -0.5, -1.0, 0.0))
        return t, float(h)
    raise ValueError(f"no reference for {spec['network_type']} / "
                     f"{spec['ternary_style']}")


def _bn(y, vs, name, eps):
    """BatchNorm in float64: scale (y - mean) / sqrt(var + eps) + bias."""
    p, s = vs["params"][name], vs["batch_stats"][name]
    f = lambda a: torch.as_tensor(a, dtype=torch.float64, device=y.device)  # noqa: E731
    return f(p["scale"]) * (y - f(s["mean"])) / torch.sqrt(f(s["var"]) + eps) + f(p["bias"])


def _activate(z, spec):
    """(codes, step): binary_tanh gives +-1 codes (+1 iff z > 0), step 1;
    quantized_relu(nb) gives level indices clip(round(hard_sigmoid(z) 2^nb)
    - 2^(nb-1), 0, 2^(nb-1) - 1) (ties to even), step 2^(1-nb)."""
    nb = spec["abits"]
    if nb == 1:
        return torch.where(z > 0, 1.0, -1.0), 1.0
    hs = torch.clamp((z + 1.0) / 2.0, 0.0, 1.0)
    level = torch.round(hs * 2.0 ** nb) - 2.0 ** (nb - 1)
    return torch.clamp(level, 0.0, 2.0 ** (nb - 1) - 1.0), 2.0 ** (1 - nb)


def _pool(y):
    return F.max_pool2d(y, 2)


def reference_logits(spec: dict, variables: dict, images_u8: torch.Tensor,
                     precision: str = "exact") -> torch.Tensor:
    """Logits (B, classes) in float64 of NHWC uint8 ``images_u8``, on their
    device, from the float variables alone.

    Images become u8 / 127.5 - 1.  The float first conv and the float head
    run in float64 (``precision="exact"``) or in TF32 (``"tf32"``, the
    control); BatchNorm and the activations run in float64; every hidden
    layer is the integer product of its codes and its weight pattern,
    scaled by alpha times the input's level step, pooled before BatchNorm
    where the block pools."""
    dev = images_u8.device
    vs, eps = variables, spec["batch_norm_epsilon"]
    par = vs["params"]
    x = images_u8.to(torch.float64) / 127.5 - 1.0
    x = x.permute(0, 3, 1, 2)  # NCHW
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)  # noqa: E731

    def conv_w(name):
        return t(par[name]["kernel"]).permute(3, 2, 0, 1)  # OIHW

    step = None
    for i in range(6):
        name = f"conv_{i}"
        if name not in vs["quant"]:
            y = _float_layer(x, conv_w(name), precision, conv=True)
            y = y + t(par[name]["bias"]).to(torch.float64)[:, None, None]
        else:
            pattern, alpha = _weight_pattern(spec, conv_w(name),
                                             float(vs["quant"][name]["H"]))
            y = alpha * step * _exact_int(x, pattern, conv=True)
        if i % 2 == 1:
            y = _pool(y)
        z = _bn(y.permute(0, 2, 3, 1), vs, f"bn_conv_{i}", eps)
        x, step = _activate(z, spec)
        x = x.to(torch.float32).permute(0, 3, 1, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
    for j in range(2):
        name = f"dense_{j}"
        pattern, alpha = _weight_pattern(spec, t(par[name]["kernel"]),
                                         float(vs["quant"][name]["H"]))
        y = alpha * step * _exact_int(x, pattern, conv=False)
        x, step = _activate(_bn(y, vs, f"bn_dense_{j}", eps), spec)
        x = x.to(torch.float32)
    y = _float_layer(x * step, t(par["dense_out"]["kernel"]), precision,
                     conv=False)
    y = y + t(par["dense_out"]["bias"]).to(torch.float64)
    return _bn(y, vs, "bn_out", eps)


# ---------------------------------------------------------------------------
# The work of each layer, from the configuration's shapes.
# ---------------------------------------------------------------------------

def layer_work(spec: dict) -> list[dict]:
    """Each layer's work for one image: ``macs``, the ``unit`` that computes
    it exactly (``f32`` or ``b1``), ``b1_per_mac`` (single-bit MACs a MAC:
    one for binary x binary through AND and popcounts, two for ternary
    weights, times the activation planes), the bytes of its input and
    output at their quantized widths a image (``io_bytes``) and of its
    weights a call (``weight_bytes``), and the model's ``stage`` it sits in
    (``first``, ``convs``, ``denses``, ``head``)."""
    h, w, cin = INPUT_SHAPES[spec["dataset"]]
    planes = activation_planes(spec)
    w_bits = 1 if spec["network_type"] == "full-bnn" else 2
    act_bytes = lambda n: n * planes / 8.0  # noqa: E731
    rows = []
    for i, c in enumerate(widths(spec)):
        macs = h * w * 9 * cin * c
        out_hw = (h // 2) * (w // 2) if i % 2 == 1 else h * w
        if i == 0:  # uint8 image in, codes out, float32 weights
            rows.append(dict(name="conv_0", stage="first", macs=macs,
                             unit="f32", b1_per_mac=0,
                             io_bytes=h * w * cin + act_bytes(out_hw * c),
                             weight_bytes=4 * (9 * cin * c + c)))
        else:
            rows.append(dict(name=f"conv_{i}", stage="convs", macs=macs,
                             unit="b1", b1_per_mac=w_bits * planes,
                             io_bytes=act_bytes(h * w * cin + out_hw * c),
                             weight_bytes=9 * cin * c * w_bits / 8.0))
        if i % 2 == 1:
            h, w = h // 2, w // 2
        cin = c
    k = h * w * cin
    for j in range(2):
        n = spec["dense_units"]
        rows.append(dict(name=f"dense_{j}", stage="denses", macs=k * n,
                         unit="b1", b1_per_mac=w_bits * planes,
                         io_bytes=act_bytes(k + n),
                         weight_bytes=k * n * w_bits / 8.0))
        k = n
    rows.append(dict(name="dense_out", stage="head", macs=k * spec["classes"],
                     unit="f32", b1_per_mac=0,
                     io_bytes=act_bytes(k) + 4 * spec["classes"],
                     weight_bytes=4 * (k + 1) * spec["classes"]))
    return rows
