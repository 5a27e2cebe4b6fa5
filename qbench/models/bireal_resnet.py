"""Bi-Real Net-18 (Liu et al., ECCV 2018, arXiv:1808.00278; the authors'
PyTorch code, github.com/liuzechun/Bi-Real-net, pytorch_implementation/
BiReal18_34/birealnet.py): its seeded random variables, its plain reference
forward and the work of each of its layers.

    conv1 7x7/2 (3 -> 64), bn1, maxpool 3x3/2           (no ReLU in the code)
    layer1..4: 4 blocks each, widths 64, 128, 256, 512; each block
        out = bn1(binary_conv(sign(x))) + residual
        binary_conv: 3x3, pad 1, alpha * sign(W), alpha = mean|W| per
        output channel; stride 2 in the first block of layers 2-4, whose
        residual is downsample(x) = BN(conv1x1(avgpool2x2/2(x)))
    avgpool, fc 512 -> 1000 with a bias

Departures, for the benchmark: images become u8 / 127.5 - 1 (the published
model normalises each channel by ImageNet's mean and deviation); the sign of
0 is +1 (x >= 0), where ``torch.sign(0)`` is 0.

This file is the benchmark's own: it imports nothing of the program.  The
variables are a state dict of the published module (OIHW kernels,
BatchNorm's ``weight``, ``bias``, ``running_mean``, ``running_var``) as
numpy float32, which the program's packer takes; the reference works out
from them for itself what the packer derives (signs, alpha, the folded
BatchNorms).
"""
from __future__ import annotations

import math
from contextlib import contextmanager

import numpy as np
import torch
import torch.nn.functional as F

INPUT_SHAPES = {"ImageNet": (224, 224, 3)}
INV_127_5 = float(np.float32(1.0 / 127.5))


def blocks(spec: dict) -> list[tuple[str, int, int, int]]:
    """(name prefix, C in, N out, stride) of each binary conv."""
    rows, c = [], spec["width"]
    for stage in range(4):
        n = spec["width"] << stage
        for i in range(4):
            rows.append((f"layer{stage + 1}.{i}", c, n, 2 if stage and not i else 1))
            c = n
    return rows


def make_variables(spec: dict, seed: int, device="cuda") -> dict:
    """Random variables of the configuration from ``seed``, drawn on
    ``device`` and returned as numpy float32, under the published module's
    state-dict names.

    Kernels are glorot-uniform, the fc PyTorch's default.  BatchNorm
    statistics are drawn around the spread of each layer's pre-activation:
    the stem's from uniform images, a binary conv's alpha * sqrt(9 C), a
    shortcut's from the stream's variance (one more unit a block); the
    stem's bias is set below its scale so that its 3x3 max pool leaves
    values of both signs, and the binary convs' scales take both signs, so
    that every stage's stream has signs of both kinds."""
    g = torch.Generator(device=device).manual_seed(int(seed))

    def u(*shape):  # uniform in [0, 1), float64
        return torch.rand(shape, generator=g, device=device,
                          dtype=torch.float64).cpu().numpy()

    def z(*shape):
        return torch.randn(shape, generator=g, device=device,
                           dtype=torch.float64).cpu().numpy()

    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    out = {}

    def kernel(name, n, c, kh, kw):
        lim = math.sqrt(6.0 / ((c + n) * kh * kw))
        out[name] = f32((2.0 * u(n, c, kh, kw) - 1.0) * lim)
        return lim

    def bn(name, n, sigma, gamma, beta):
        out[f"{name}.weight"] = f32(gamma)
        out[f"{name}.bias"] = f32(beta)
        out[f"{name}.running_mean"] = f32(0.1 * sigma * z(n))
        out[f"{name}.running_var"] = f32(sigma ** 2 * (0.8 + 0.4 * u(n)))

    w = spec["width"]
    lim = kernel("conv1.weight", w, 3, 7, 7)
    gamma = 0.5 + u(w)
    # the stem's pre-activation over uniform images (variance 1/3 a pixel);
    # a 3x3 max of its BatchNorm's output sits about 1.2 scales above the
    # bias
    bn("bn1", w, lim * math.sqrt(147 / 9.0), gamma,
       -1.2 * gamma * (0.8 + 0.4 * u(w)))
    var_stream = 1.0
    for name, c, n, stride in blocks(spec):
        if stride == 2:
            lim = kernel(f"{name}.downsample.1.weight", n, c, 1, 1)
            bn(f"{name}.downsample.2", n,
               math.sqrt(0.5 * var_stream * c * lim ** 2 / 3.0), 0.5 + u(n),
               0.2 * z(n))
            var_stream = 1.0
        kernel(f"{name}.binary_conv.weights", n, c, 3, 3)
        alpha = np.mean(np.abs(out[f"{name}.binary_conv.weights"]), axis=(1, 2, 3),
                        dtype=np.float64)
        sign = np.where(u(n) < 0.5, -1.0, 1.0)
        bn(f"{name}.bn1", n, float(np.mean(alpha)) * math.sqrt(9 * c),
           sign * (0.5 + u(n)), 0.2 * z(n))
        var_stream += 1.0
    lim = 1.0 / math.sqrt(8 * w)
    out["fc.weight"] = f32((2.0 * u(spec["classes"], 8 * w) - 1.0) * lim)
    out["fc.bias"] = f32((2.0 * u(spec["classes"]) - 1.0) * lim)
    return out


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


def fold(variables: dict, name: str, eps: float, alpha=None):
    """BatchNorm ``name`` after ``alpha * y`` as ``y * scale + shift`` in
    float32: scale = alpha * weight / sqrt(var + eps), shift = bias - mean *
    weight / sqrt(var + eps), in float64, rounded once."""
    gamma, beta, mean, var = (np.asarray(variables[f"{name}.{k}"], np.float64)
                              for k in ("weight", "bias", "running_mean",
                                        "running_var"))
    inv = gamma / np.sqrt(var + eps)
    scale = inv if alpha is None else alpha * inv
    return scale.astype(np.float32), (beta - mean * inv).astype(np.float32)


def reference_logits(spec: dict, variables: dict, images_u8: torch.Tensor,
                     precision: str = "exact") -> torch.Tensor:
    """Logits (B, classes) float32 of NHWC uint8 ``images_u8``, on their
    device, from the variables alone, in float32 with TF32 off.

    ``precision="exact"``: the float convs and the fc in IEEE float32;
    ``"tf32"`` (the control, one precision below the configuration's
    float32): their operands rounded to TF32 first.  The binary convs are
    exact integer sums in either; each block's float32 epilogue is
    ``(s * scale + shift) + residual``, one rounding a step, in that order."""
    if precision not in ("exact", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    dev = images_u8.device
    eps = spec["batch_norm_epsilon"]
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    rnd = _tf32 if precision == "tf32" else (lambda a: a)

    def affine(y, name, alpha=None):  # y NHWC
        scale, shift = fold(variables, name, eps, alpha)
        return (y * t(scale)) + t(shift)

    with _ieee_f32():
        # u8 * f32(1/127.5) - 1, exact in float64, rounded once
        x = (images_u8.to(torch.float64) * INV_127_5 - 1.0).to(torch.float32)
        y = F.conv2d(rnd(x).permute(0, 3, 1, 2), rnd(t(variables["conv1.weight"])),
                     stride=2, padding=3)
        y = affine(y.permute(0, 2, 3, 1), "bn1")
        x = F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        x = x.contiguous()
        for name, c, n, stride in blocks(spec):
            latent = np.asarray(variables[f"{name}.binary_conv.weights"],
                                np.float32).reshape(n, c, 3, 3)
            alpha = np.mean(np.abs(latent.astype(np.float64)), axis=(1, 2, 3))
            sign_w = torch.where(t(latent) >= 0, 1.0, -1.0)
            a = torch.where(x >= 0, 1.0, -1.0).permute(0, 3, 1, 2)
            s = torch.round(F.conv2d(a, sign_w, stride=stride, padding=1))
            r = x
            if stride == 2:
                r = F.avg_pool2d(x.permute(0, 3, 1, 2), 2)
                r = F.conv2d(rnd(r), rnd(t(variables[f"{name}.downsample.1.weight"])))
                r = affine(r.permute(0, 2, 3, 1), f"{name}.downsample.2").contiguous()
            x = (affine(s.permute(0, 2, 3, 1), f"{name}.bn1", alpha) + r).contiguous()
        x = x.mean(dim=(1, 2))
        y = rnd(x) @ rnd(t(variables["fc.weight"])).t()
        return y + t(variables["fc.bias"])


# ---------------------------------------------------------------------------
# The work of each layer, from the configuration's shapes.
# ---------------------------------------------------------------------------

def layer_work(spec: dict) -> list[dict]:
    """Each layer's work for one image: ``macs``, the ``unit`` that computes
    it exactly (``f32``; ``b1`` for the binary convs, one single-bit MAC a
    MAC), ``b1_per_mac``, the bytes of its input and output a image
    (``io_bytes``: the float32 stream at 4 B, sign bits at 1/8 B, the image
    at 4 B once normalised) and of its weights a call (``weight_bytes``), and
    the model's ``stage`` it sits in: ``first`` (the stem), ``convs`` (the
    residual binary convs alone), ``shortcuts`` (the three float
    downsampling shortcuts, which the program runs inside its ``convs``
    child), ``denses`` (the global average pool) and ``head`` (the fc)."""
    h, w, cin = INPUT_SHAPES[spec["dataset"]]
    width = spec["width"]
    ho, wo = -(-h // 2), -(-w // 2)   # the stem's conv
    hp, wp = -(-ho // 2), -(-wo // 2)  # and its pool
    rows = [dict(name="stem", stage="first", macs=ho * wo * 49 * cin * width,
                 unit="f32", b1_per_mac=0,
                 io_bytes=4 * h * w * cin + hp * wp * width * (4 + 1 / 8),
                 weight_bytes=4 * (49 * cin * width + 2 * width))]
    h, w = hp, wp
    for name, c, n, stride in blocks(spec):
        ho, wo = -(-h // stride), -(-w // stride)
        if stride == 2:
            rows.append(dict(name=f"{name}.downsample", stage="shortcuts",
                             macs=ho * wo * c * n, unit="f32", b1_per_mac=0,
                             io_bytes=4 * (h * w * c + ho * wo * n),
                             weight_bytes=4 * (c * n + 2 * n)))
        # bits in, the residual in and the stream out at 4 B, bits out
        rows.append(dict(name=f"{name}.binary_conv", stage="convs",
                         macs=ho * wo * 9 * c * n, unit="b1", b1_per_mac=1,
                         io_bytes=h * w * c / 8 + ho * wo * n * (8 + 1 / 8),
                         weight_bytes=9 * c * n / 8 + 4 * ho * wo * n + 8 * n))
        h, w = ho, wo
    rows.append(dict(name="avgpool", stage="denses", macs=0, unit="f32",
                     b1_per_mac=0, io_bytes=4 * (h * w * n + n), weight_bytes=0))
    rows.append(dict(name="fc", stage="head", macs=n * spec["classes"], unit="f32",
                     b1_per_mac=0, io_bytes=4 * (n + spec["classes"]),
                     weight_bytes=4 * (n + 1) * spec["classes"]))
    return rows
