"""Conversion pass: trained fake-quant variables -> packed, bit-plane and
int8 models (torch port of :func:`qnx.convert.pack_model.pack_mlp` and
:func:`qnx.convert.pack_model.pack_vgg`, binary and ternary, of
:func:`qnx.convert.pack_model.pack_vgg_bitplane` in its relu and tanh
modes, and of :func:`qnx.convert.pack_model.pack_int8` for every quantized
network type and its four encodings), and :func:`pack_bireal`, the port's
own, for Bi-Real Net-18, whose variables are a state dict of the published
PyTorch module.

Input is the JAX package's variables as numpy arrays — the
``{"params", "quant", "batch_stats"}`` dict of ``jax.device_get(init_model(
...)[1])``, of a training run, or of :func:`qnx_torch.models.factory.
init_variables`.  Everything here is numpy, so the buffers equal the JAX
converter's leaves byte for byte.  Each converter returns its model on
``device``, the CUDA card unless the caller asks for ``"cpu"``; without a
card the default raises.
"""
from __future__ import annotations

import numpy as np
import torch

from qnx_torch.kernels.xnor_conv import (pack_conv_ternary_np,
                                         pack_conv_weights_np,
                                         padding_correction)
from qnx_torch.nn import bireal as R
from qnx_torch.nn import inference as I
from qnx_torch.nn import int8_engine as E
from qnx_torch.ops.packing import pack_bits_np, pack_ternary_np
from qnx_torch.transforms.bn_fold import (fold_bn_affine, fold_bn_levels,
                                          fold_bn_sign)
from qnx_torch.utils.config import Config


def _np(x):
    return np.asarray(x)


def _check_device(device) -> torch.device:
    """The device a converter builds on; a CUDA device without a card
    raises, so a model never lands on the CPU unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA card for device={str(device)!r}: the converters build "
            "on the card by default; pass device='cpu' for the CPU")
    return device


def _t(x) -> torch.Tensor:
    """numpy -> torch buffer with the JAX package's 32-bit dtypes (floats to
    float32, as ``jnp.asarray`` does without x64)."""
    x = np.asarray(x)
    if np.issubdtype(x.dtype, np.floating):
        x = x.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(x))


def _binary_pattern(latent: np.ndarray, h: float) -> np.ndarray:
    """±1 sign pattern of binarize(latent, H) in numpy float32, with the op
    order of qnx.ops.quant.binary_tanh."""
    latent = np.asarray(latent, np.float32)
    hs = np.clip((latent / np.float32(h) + np.float32(1.0)) / np.float32(2.0),
                 np.float32(0.0), np.float32(1.0)).astype(np.float32)
    return (2.0 * np.round(hs) - 1.0).astype(np.float32)


def _ternary_pattern(latent: np.ndarray, h: float, style: str):
    """{-1, 0, +1} pattern and scale alpha, the numpy mirror of the forward
    values of qnx.ops.quant.ternarize (``dingke``) and ternarize_twn."""
    latent = np.asarray(latent, np.float32)
    if style == "dingke":
        wc = np.clip(latent, -h, h).astype(np.float32)
        r = (wc / np.float32(h)).astype(np.float32)
        t = np.where(r > 0.5, 1.0, np.where(r <= -0.5, -1.0, 0.0))
        return t.astype(np.float32), h
    delta = 0.7 * np.mean(np.abs(latent), dtype=np.float32)
    mask = np.abs(latent) > delta
    nnz = max(int(mask.sum()), 1)
    alpha = float(np.sum(np.where(mask, np.abs(latent), 0.0), dtype=np.float32) / nnz)
    t = np.where(mask, np.sign(latent), 0.0).astype(np.float32)
    return t, alpha


def _quant_grid(latent: np.ndarray, h: float, nb: int):
    """Integer grid z and scale alpha of the pow2-grid weight quantizer
    (qnx.ops.quant.quantize): Wq = alpha * z with

        z = clip(round(latent/H * m), -m, m-1),  alpha = H/m,  m = 2^(nb-1),

    in quantize's float32 op order (np.round rounds half to even, as
    jnp.round); alpha * z equals H * (z / m) bit for bit, a pow2 scale being
    exact in float32.  z fits int8 for nb <= 8."""
    latent = np.asarray(latent, np.float32)
    m = float(2 ** (nb - 1))
    r = (latent / np.float32(h)).astype(np.float32)
    z = np.clip(np.round((r * np.float32(m)).astype(np.float32)), -m, m - 1)
    return z.astype(np.float32), float(h) / m


def _weight_pattern(cf: Config, latent: np.ndarray, h: float):
    """A quantized layer's weight pattern and scale alpha: ternary
    {-1, 0, +1} for ``full-tnn`` (``cf.ternary_style``), else binary ±1
    with alpha = H."""
    if cf.network_type == "full-tnn":
        return _ternary_pattern(latent, h, cf.ternary_style)
    return _binary_pattern(latent, h), h


def _bn(params: dict, stats: dict, name: str, eps: float):
    return dict(
        gamma=_np(params[name]["scale"]),
        beta=_np(params[name]["bias"]),
        mean=_np(stats[name]["mean"]),
        var=_np(stats[name]["var"]),
        eps=eps,
    )


def _engine_activation(cf: Config) -> str:
    """Canonical activation op for the real-bit engine lowering (see
    :func:`qnx.convert.pack_model._engine_activation`): the binary family
    lowers ``binary_tanh`` and ``binary_sigmoid``; a cross-family override
    trains fake-quant but has no engine lowering."""
    derived = cf.replace(activation=None).activation_name()
    canonical = {"relu": "relu", "binary": "binary_tanh",
                 "quant": "quantized_relu"}[derived]
    if cf.activation is None:
        return canonical
    family = {"relu": ("relu",),
              "binary": ("binary_tanh", "binary_sigmoid"),
              "quant": ("quantized_relu", "quantized_tanh")}[derived]
    if cf.activation not in family:
        raise ValueError(
            f"activation override {cf.activation!r} trains fake-quant but "
            f"its engine lowering is not implemented for this config's "
            f"{derived!r} activation family (implemented here: {family} or "
            "activation=None); evaluate it with the fake-quant forward "
            "instead — see docs/PARITY.md")
    return cf.activation


def _zo_fold_params(alpha: float, bias, pattern: np.ndarray, axes):
    """binary_sigmoid input coding: activations a = (t+1)/2 in {0,1}, so
    sum a*w = (s + sum_w)/2 exactly.  Returns (alpha/2, bias +
    (alpha/2) * per-channel sum_w)."""
    sumw = np.asarray(pattern, np.float64).sum(axis=axes)
    b = np.zeros_like(sumw) if bias is None else np.asarray(bias, np.float64)
    return alpha / 2.0, b + (alpha / 2.0) * sumw


def _tanh_fold_bias(alpha_q: float, bias, pattern: np.ndarray, axes, nb: int):
    """quantized_tanh input coding of the plane engine: the planes carry
    u = v + (L-1), so sum a*w = q*(sum u*w - (L-1)*sum_w); the constant
    -(L-1)*sum_w part folds into the bias (alpha_q = alpha*q)."""
    lm1 = 2 ** (nb - 1) - 1
    sumw = np.asarray(pattern, np.float64).sum(axis=axes)
    b = np.zeros_like(sumw) if bias is None else np.asarray(bias, np.float64)
    return b - alpha_q * lm1 * sumw


def validate_vgg_variables(variables: dict, cf: Config) -> None:
    """Up-front structural validation of a VGG variables tree against the
    6-conv/2-dense/head template: missing layers, broken channel chaining
    or a flatten width inconsistent with the pool schedule fail here."""
    params = variables.get("params", {})
    expected = ([f"conv_{i}" for i in range(6)]
                + [f"bn_conv_{i}" for i in range(6)]
                + ["dense_0", "dense_1", "bn_dense_0", "bn_dense_1",
                   "dense_out", "bn_out"])
    missing = [n for n in expected if n not in params]
    if missing:
        raise ValueError(
            f"VGG variables missing layers {missing}; present: "
            f"{sorted(params)} — expected the 6-conv/2-dense template "
            "(conv_0..5 + bn_conv_0..5, dense_0..1 + bn_dense_0..1, "
            "dense_out + bn_out)")

    def shape(name):
        return tuple(np.shape(params[name]["kernel"]))

    cin = cf.input_shape[-1]
    for i in range(6):
        s = shape(f"conv_{i}")
        if len(s) != 4:
            raise ValueError(f"conv_{i}: kernel must be (kh, kw, cin, cout), "
                             f"got {s}")
        if s[2] != cin:
            raise ValueError(
                f"conv_{i}: input channels {s[2]} do not chain from the "
                f"previous layer's {cin} output channels")
        cin = s[3]
        bns = np.shape(params[f"bn_conv_{i}"]["scale"])
        if bns != (cin,):
            raise ValueError(f"bn_conv_{i}: scale shape {bns} != ({cin},)")

    hin, win, _ = cf.input_shape
    fh, fw = hin // 8, win // 8  # three 2x2 pools (after conv_1/3/5)
    flat = fh * fw * cin
    s = shape("dense_0")
    if len(s) != 2:
        raise ValueError(f"dense_0: kernel must be 2-D (in, units), got {s}")
    if s[0] != flat:
        raise ValueError(
            f"dense_0: kernel {s} does not consume the flattened conv "
            f"output ({fh}x{fw}x{cin} = {flat} after three 2x2 pools of the "
            f"{hin}x{win} input)")
    k = s[1]
    for name in ("dense_1", "dense_out"):
        s = shape(name)
        if len(s) != 2:
            raise ValueError(f"{name}: kernel must be 2-D (in, units), "
                             f"got {s}")
        if s[0] != k:
            raise ValueError(
                f"{name}: input width {s[0]} does not chain from the "
                f"previous layer's {k} units")
        k = s[1]
    if k != cf.classes:
        raise ValueError(
            f"dense_out: {k} output units != cf.classes = {cf.classes}")


def _pack_dense_per_position(pattern: np.ndarray, h: int, w: int, c: int):
    """Pack a (h*w*c, N) dense pattern whose input is the flatten of packed
    (h, w, Cw) conv bits: pack along C per spatial position so the word
    layout matches the runtime flatten. Returns (wp (h*w*Cw, N), k_true)."""
    n = pattern.shape[1]
    p = pattern.reshape(h * w, c, n)
    wp = pack_bits_np(p, axis=1)  # (h*w, Cw, N)
    return wp.reshape(-1, n), h * w * c


def pack_vgg(variables: dict, cf: Config, device="cuda") -> I.PackedVGG:
    """Lower a trained binary- or ternary-weight QuantVGG with binary
    activations (``full-bnn`` / ``full-tnn``, abits=1) into a
    :class:`qnx_torch.nn.inference.PackedVGG` on ``device``."""
    device = _check_device(device)
    if cf.architecture != "vgg":
        raise ValueError("pack_vgg expects a vgg config")
    if cf.abits != 1 or cf.network_type not in ("full-bnn", "full-tnn"):
        raise ValueError(
            "packed VGG path requires binary activations (abits=1); "
            f"got {cf.network_type}/abits={cf.abits}")
    sig = _engine_activation(cf) == "binary_sigmoid"
    validate_vgg_variables(variables, cf)
    ternary = cf.network_type == "full-tnn"
    params = variables["params"]
    quant = variables.get("quant", {})
    stats = variables["batch_stats"]
    eps = cf.batch_norm_epsilon
    hin, win, _ = cf.input_shape

    def conv_weights(name):
        latent = _np(params[name]["kernel"])  # (kh,kw,C,N)
        bias = _np(params[name]["bias"]) if "bias" in params[name] else None
        h = float(quant[name]["H"]) if name in quant else None
        return latent, h, bias

    def in_fold(alpha, bias, pattern, axes=0):
        """INPUT-coding fold; binary_sigmoid also zeroes the conv border
        correction (its pad bit decodes to a = 0, the fake-quant zero pad)."""
        if sig:
            return _zo_fold_params(alpha, bias, pattern, axes=axes)
        return alpha, bias

    # ---- first conv: float path -> bits
    latent, h, bias = conv_weights("conv_0")
    if h is None:  # float first layer (cf.first_layer_float)
        w0 = latent.astype(np.float32)
    else:
        pattern, alpha = _weight_pattern(cf, latent, h)
        w0 = (pattern * alpha).astype(np.float32)
    bn = _bn(params, stats, "bn_conv_0", eps)
    first = I.FloatConvBits(
        w=_t(w0), bias=None if bias is None else _t(bias),
        bn_scale=_t(bn["gamma"]), bn_bias=_t(bn["beta"]),
        bn_mean=_t(bn["mean"]), bn_var=_t(bn["var"]), bn_eps=eps, pool=False)

    # ---- packed conv blocks 1..5 (pool after odd layers, spatial halves)
    convs = []
    sh, sw = hin, win  # spatial dims at the INPUT of each conv
    for i in range(1, 6):
        if i == 2 or i == 4:
            sh, sw = sh // 2, sw // 2
        latent, h, bias = conv_weights(f"conv_{i}")
        bn = _bn(params, stats, f"bn_conv_{i}", eps)
        pattern, alpha = _weight_pattern(cf, latent, h)
        corr = (np.zeros((sh, sw, pattern.shape[-1]), np.int32) if sig
                else padding_correction(pattern, sh, sw))
        a_eff, b_eff = in_fold(alpha, bias, pattern, axes=(0, 1, 2))
        thr = fold_bn_sign(bn["gamma"], bn["beta"], bn["mean"], bn["var"],
                           eps, alpha=a_eff, bias=b_eff)
        if ternary:
            mask, sign, nnz = pack_conv_ternary_np(pattern)
            convs.append(I.TernaryConvBits(
                mask=_t(mask), sign=_t(sign), nnz=_t(nnz), corr=_t(corr),
                sgn=_t(thr.sgn), tau=_t(thr.tau), pool=i % 2 == 1))
        else:
            wp, k = pack_conv_weights_np(pattern)
            convs.append(I.PackedConvBits(
                wp=_t(wp), corr=_t(corr), sgn=_t(thr.sgn), tau=_t(thr.tau),
                k=k, pool=i % 2 == 1))

    # ---- dense stack: dense_0 consumes the per-position packed flatten
    fh, fw = sh // 2, sw // 2  # after conv_5's pool
    c_last = _np(params["conv_5"]["kernel"]).shape[-1]
    denses = []
    for j in range(2):
        name = f"dense_{j}"
        latent = _np(params[name]["kernel"])
        h = float(quant[name]["H"])
        bias = _np(params[name]["bias"]) if "bias" in params[name] else None
        bn = _bn(params, stats, f"bn_dense_{j}", eps)
        pattern, alpha = _weight_pattern(cf, latent, h)
        a_eff, b_eff = in_fold(alpha, bias, pattern)
        thr = fold_bn_sign(bn["gamma"], bn["beta"], bn["mean"], bn["var"],
                           eps, alpha=a_eff, bias=b_eff)
        if ternary:
            if j == 0:
                mask, sign, nnz = _pack_ternary_per_position(pattern, fh, fw,
                                                             c_last)
            else:
                mask, sign, nnz = pack_ternary_np(pattern, axis=0)
            denses.append(I.TernaryDenseBits(
                mask=_t(mask), sign=_t(sign), nnz=_t(nnz), sgn=_t(thr.sgn),
                tau=_t(thr.tau)))
        else:
            if j == 0:
                wp, k = _pack_dense_per_position(pattern, fh, fw, c_last)
            else:
                wp, k = pack_bits_np(pattern, axis=0), pattern.shape[0]
            denses.append(I.PackedDenseBits(wp=_t(wp), sgn=_t(thr.sgn),
                                            tau=_t(thr.tau), k=k))

    # ---- head
    name = "dense_out"
    latent = _np(params[name]["kernel"])
    bias = _np(params[name]["bias"]) if "bias" in params[name] else None
    bn = _bn(params, stats, "bn_out", eps)
    if name not in quant:  # float head over the binary activations
        head = I.FloatDenseLogitsFromBits(
            w=_t(latent.astype(np.float32)),
            bias=None if bias is None else _t(bias),
            bn_scale=_t(bn["gamma"]), bn_bias=_t(bn["beta"]),
            bn_mean=_t(bn["mean"]), bn_var=_t(bn["var"]),
            bn_eps=eps, k=latent.shape[0], coding="zo" if sig else "pm1")
    else:
        pattern, alpha = _weight_pattern(cf, latent, float(quant[name]["H"]))
        a_eff, b_eff = in_fold(alpha, bias, pattern)
        aff = fold_bn_affine(bn["gamma"], bn["beta"], bn["mean"], bn["var"],
                             eps, alpha=a_eff, bias=b_eff)
        if ternary:
            mask, sign, nnz = pack_ternary_np(pattern, axis=0)
            head = I.TernaryDenseLogits(mask=_t(mask), sign=_t(sign),
                                        nnz=_t(nnz), a=_t(aff.a), c=_t(aff.c0))
        else:
            head = I.PackedDenseLogits(wp=_t(pack_bits_np(pattern, axis=0)),
                                       a=_t(aff.a), c=_t(aff.c0),
                                       k=latent.shape[0])

    return I.PackedVGG(first=first, convs=convs, denses=denses,
                       head=head).to(device)


def _pack_ternary_per_position(pattern: np.ndarray, h: int, w: int, c: int):
    """Ternary :func:`_pack_dense_per_position`: (mask, sign) of shape
    (h*w*Cw, N), packed along C per spatial position, and nnz (N,)."""
    n = pattern.shape[1]
    mask, sign, nnz = pack_ternary_np(pattern.reshape(h * w, c, n), axis=1)
    return mask.reshape(-1, n), sign.reshape(-1, n), nnz.sum(axis=0, dtype=np.int32)


def pack_vgg_bitplane(variables: dict, cf: Config, device="cuda") -> I.PlaneVGG:
    """Lower a trained QuantVGG with n-bit activations (abits > 1) and
    ternary or binary weights into a :class:`qnx_torch.nn.inference.PlaneVGG`
    on ``device`` (``cifar10-tnn``: ternary weights, 2-bit activations).

    Activations decompose into {0,1} planes (x = q * sum 2^j b_j), the
    effective GEMM scale becomes alpha*q, and BN + the activation fold into
    multi-level integer thresholds (``fold_bn_levels``).  quantized_relu
    levels take nb - 1 planes; quantized_tanh's signed codes become unsigned
    indices u = v + (L-1) in nb planes, whose constant part folds into each
    layer's bias (:func:`_tanh_fold_bias`), whose zero pads the
    (L-1)-scaled border term ``corr`` corrects, and which the float head
    recentres (``lvl0``)."""
    device = _check_device(device)
    if cf.architecture != "vgg":
        raise ValueError("pack_vgg_bitplane expects a vgg config")
    if cf.abits < 2 or cf.network_type not in ("full-tnn", "full-bnn"):
        raise ValueError(
            "bitplane VGG path requires abits >= 2 with ternary/binary "
            f"weights; got {cf.network_type}/abits={cf.abits}")
    tanh = _engine_activation(cf) == "quantized_tanh"
    mode = "tanh" if tanh else "relu"
    validate_vgg_variables(variables, cf)
    params = variables["params"]
    quant = variables.get("quant", {})
    stats = variables["batch_stats"]
    eps = cf.batch_norm_epsilon
    nb = cf.abits
    q = 2.0 ** (1 - nb)
    lm1 = 2 ** (nb - 1) - 1  # quantized_tanh's unsigned-index offset L-1
    hin, win, _ = cf.input_shape

    def get(name):
        latent = _np(params[name]["kernel"])
        bias = _np(params[name]["bias"]) if "bias" in params[name] else None
        h = float(quant[name]["H"]) if name in quant else None
        return latent, h, bias

    def in_bias(alpha, bias, pattern, axes=0):
        """The bias for this layer's input coding: tanh's unsigned indices
        fold their constant part in here."""
        if tanh:
            return _tanh_fold_bias(alpha * q, bias, pattern, axes, nb)
        return bias

    def levels(name, alpha, bias, pattern, axes=0):
        bn = _bn(params, stats, name, eps)
        lt = fold_bn_levels(bn["gamma"], bn["beta"], bn["mean"], bn["var"],
                            eps, nb, alpha=alpha * q,
                            bias=in_bias(alpha, bias, pattern, axes), mode=mode)
        return _t(lt.sgn), _t(lt.tau)

    # first conv: float path -> planes
    latent, h, bias = get("conv_0")
    if h is None:
        w0 = latent.astype(np.float32)
    else:
        pattern, alpha = _weight_pattern(cf, latent, h)
        w0 = (pattern * alpha).astype(np.float32)
    bn = _bn(params, stats, "bn_conv_0", eps)
    first = I.FloatConvPlanes(
        w=_t(w0), bias=None if bias is None else _t(bias),
        bn_scale=_t(bn["gamma"]), bn_bias=_t(bn["beta"]),
        bn_mean=_t(bn["mean"]), bn_var=_t(bn["var"]), bn_eps=eps, nb=nb,
        pool=False, mode=mode)

    convs = []
    sh, sw = hin, win  # spatial dims at the INPUT of each conv
    for i in range(1, 6):
        if i in (2, 4):
            sh, sw = sh // 2, sw // 2
        latent, h, bias = get(f"conv_{i}")
        pattern, alpha = _weight_pattern(cf, latent, h)
        mask, sign, _ = pack_conv_ternary_np(pattern)
        sgn, tau = levels(f"bn_conv_{i}", alpha, bias, pattern, (0, 1, 2))
        corr = _t(lm1 * padding_correction(pattern, sh, sw)) if tanh else None
        convs.append(I.PlaneConvTernary(
            mask=_t(mask), msign=_t(mask & sign), sgn=sgn, tau=tau,
            pool=i % 2 == 1, corr=corr))

    fh, fw = sh // 2, sw // 2  # after conv_5's pool
    c_last = _np(params["conv_5"]["kernel"]).shape[-1]
    denses = []
    for j in range(2):
        latent, h, bias = get(f"dense_{j}")
        pattern, alpha = _weight_pattern(cf, latent, h)
        if j == 0:  # per-position packing to match the plane flatten
            mask, sign, _ = _pack_ternary_per_position(pattern, fh, fw, c_last)
        else:
            mask, sign, _ = pack_ternary_np(pattern, axis=0)
        sgn, tau = levels(f"bn_dense_{j}", alpha, bias, pattern)
        denses.append(I.PlaneDenseTernary(mask=_t(mask), msign=_t(mask & sign),
                                          sgn=sgn, tau=tau))

    # head
    latent, h, bias = get("dense_out")
    bn = _bn(params, stats, "bn_out", eps)
    if "dense_out" not in quant:
        head = I.FloatDenseLogitsFromPlanes(
            w=_t(latent.astype(np.float32)),
            bias=None if bias is None else _t(bias),
            bn_scale=_t(bn["gamma"]), bn_bias=_t(bn["beta"]),
            bn_mean=_t(bn["mean"]), bn_var=_t(bn["var"]), bn_eps=eps,
            k=latent.shape[0], q=q, lvl0=lm1 if tanh else 0)
    else:
        pattern, alpha = _weight_pattern(cf, latent, h)
        aff = fold_bn_affine(bn["gamma"], bn["beta"], bn["mean"], bn["var"],
                             eps, alpha=alpha * q,
                             bias=in_bias(alpha, bias, pattern))
        mask, sign, _ = pack_ternary_np(pattern, axis=0)
        head = I.PlaneDenseLogits(mask=_t(mask), msign=_t(mask & sign),
                                  a=_t(aff.a), c=_t(aff.c0))

    return I.PlaneVGG(first=first, convs=convs, denses=denses,
                      head=head).to(device)


def pack_mlp(variables: dict, cf: Config, device="cuda") -> I.PackedMLP:
    """Lower a trained QuantMLP (full-bnn / full-tnn, abits=1) into a
    :class:`qnx_torch.nn.inference.PackedMLP` on ``device``."""
    device = _check_device(device)
    if cf.architecture != "mlp":
        raise ValueError("pack_mlp expects an mlp config")
    if cf.abits != 1 or cf.network_type not in ("full-bnn", "full-tnn"):
        raise ValueError(
            "packed MLP path requires binary activations "
            f"(network_type full-bnn/full-tnn, abits=1); got {cf.network_type}")
    sig = _engine_activation(cf) == "binary_sigmoid"
    ternary = cf.network_type == "full-tnn"
    params = variables["params"]
    quant = variables["quant"]
    stats = variables["batch_stats"]
    eps = cf.batch_norm_epsilon

    def layer_weights(name):
        latent = _np(params[name]["kernel"])
        h = float(quant[name]["H"])
        bias = _np(params[name]["bias"]) if "bias" in params[name] else None
        return latent, h, bias

    def in_fold(alpha, bias, pattern):
        """Fold params for this layer's INPUT coding (sigmoid: {0,1} bits)."""
        if sig:
            return _zo_fold_params(alpha, bias, pattern, axes=0)
        return alpha, bias

    # first layer: real-valued input -> float GEMM with quantized weights
    latent, h, bias = layer_weights("dense_0")
    pattern, alpha = _weight_pattern(cf, latent, h)
    bn = _bn(params, stats, "bn_0", eps)
    first = I.FloatDenseBits(
        w=_t((pattern * alpha).astype(np.float32)),
        bias=None if bias is None else _t(bias),
        bn_scale=_t(bn["gamma"]), bn_bias=_t(bn["beta"]),
        bn_mean=_t(bn["mean"]), bn_var=_t(bn["var"]), bn_eps=eps)

    hidden = []
    for i in range(1, cf.num_hidden):
        latent, h, bias = layer_weights(f"dense_{i}")
        bn = _bn(params, stats, f"bn_{i}", eps)
        pattern, alpha = _weight_pattern(cf, latent, h)
        a_eff, b_eff = in_fold(alpha, bias, pattern)
        thr = fold_bn_sign(bn["gamma"], bn["beta"], bn["mean"], bn["var"],
                           eps, alpha=a_eff, bias=b_eff)
        if ternary:
            mask, sign, nnz = pack_ternary_np(pattern, axis=0)
            hidden.append(I.TernaryDenseBits(
                mask=_t(mask), sign=_t(sign), nnz=_t(nnz),
                sgn=_t(thr.sgn), tau=_t(thr.tau)))
        else:
            hidden.append(I.PackedDenseBits(
                wp=_t(pack_bits_np(pattern, axis=0)), sgn=_t(thr.sgn),
                tau=_t(thr.tau), k=latent.shape[0]))

    # head: integer GEMM + affine epilogue (BN folded, no sign)
    latent, h, bias = layer_weights("dense_out")
    bn = _bn(params, stats, "bn_out", eps)
    pattern, alpha = _weight_pattern(cf, latent, h)
    a_eff, b_eff = in_fold(alpha, bias, pattern)
    aff = fold_bn_affine(bn["gamma"], bn["beta"], bn["mean"], bn["var"],
                         eps, alpha=a_eff, bias=b_eff)
    if ternary:
        mask, sign, nnz = pack_ternary_np(pattern, axis=0)
        head = I.TernaryDenseLogits(mask=_t(mask), sign=_t(sign), nnz=_t(nnz),
                                    a=_t(aff.a), c=_t(aff.c0))
    else:
        head = I.PackedDenseLogits(wp=_t(pack_bits_np(pattern, axis=0)),
                                   a=_t(aff.a), c=_t(aff.c0), k=latent.shape[0])
    return I.PackedMLP(first=first, hidden=hidden, head=head).to(device)


def bireal_fold(variables: dict, name: str, eps: float, alpha=None):
    """The BatchNorm ``name`` (``<name>.weight``, ``.bias``,
    ``.running_mean``, ``.running_var``) after a layer whose output is
    ``alpha * y`` (alpha per channel, or none), as ``y * scale + shift`` in
    float32: scale = alpha * weight / sqrt(var + eps) and shift = bias -
    mean * weight / sqrt(var + eps), computed in float64 and rounded once."""
    gamma, beta, mean, var = (np.asarray(variables[f"{name}.{k}"], np.float64)
                              for k in ("weight", "bias", "running_mean",
                                        "running_var"))
    inv = gamma / np.sqrt(var + eps)
    scale = inv if alpha is None else alpha * inv
    return scale.astype(np.float32), (beta - mean * inv).astype(np.float32)


def bireal_layers(cf: Config) -> list[tuple[str, int, int, int]]:
    """(name prefix, C in, N out, stride) of each binary conv of Bi-Real
    Net-18: four stages of four at widths ``cf.width`` x (1, 2, 4, 8), the
    first of stages 2-4 at stride 2."""
    rows, c = [], cf.width
    for stage in range(4):
        n = cf.width << stage
        for i in range(4):
            rows.append((f"layer{stage + 1}.{i}", c, n, 2 if stage and not i else 1))
            c = n
    return rows


def pack_bireal(variables: dict, cf: Config, device="cuda") -> R.BiRealResNet:
    """Lower Bi-Real Net-18's variables into a
    :class:`qnx_torch.nn.bireal.BiRealResNet` on ``device``.

    ``variables`` maps the published module's state-dict names
    (``conv1.weight``, ``bn1.*``, ``layer<s>.<i>.binary_conv.weights``,
    ``layer<s>.<i>.bn1.*``, ``layer<s>.0.downsample.1.weight`` and
    ``.downsample.2.*``, ``fc.weight``, ``fc.bias``) to float32 arrays, OIHW
    kernels; a binary conv's latent ``weights`` may also be the published
    (N*C*9, 1) column.  Each binary conv packs sign(W) (+1 where W >= 0) into
    the (9*Cw, N) words kernel A takes, folds alpha = mean|W| over (in, kh,
    kw) into its BatchNorm (:func:`bireal_fold`), and gets ``corr`` at its
    stride's output grid."""
    device = _check_device(device)
    if cf.architecture != "bireal18":
        raise ValueError("pack_bireal expects a bireal18 config")
    if (cf.network_type, cf.wbits, cf.abits) != ("full-bnn", 1, 1):
        raise ValueError("Bi-Real Net's convs are binary: network_type full-bnn, "
                         f"wbits 1, abits 1; got {cf.network_type}, {cf.wbits}, "
                         f"{cf.abits}")
    eps = cf.batch_norm_epsilon
    get = lambda name: np.asarray(variables[name], np.float32)  # noqa: E731
    first = R.BiRealStem(_t(get("conv1.weight")), *map(_t, bireal_fold(
        variables, "bn1", eps)))
    h, w, _ = cf.input_shape
    h, w = -(-h // 4), -(-w // 4)  # the stem's conv and pool, each at stride 2
    convs = []
    for index, (name, c, n, stride) in enumerate(bireal_layers(cf)):
        latent = get(f"{name}.binary_conv.weights").reshape(n, c, 3, 3)
        alpha = np.mean(np.abs(latent.astype(np.float64)), axis=(1, 2, 3))
        pattern = np.where(latent >= 0, 1.0, -1.0).transpose(2, 3, 1, 0)  # HWIO
        wp, k = pack_conv_weights_np(pattern)
        shortcut = None
        if stride == 2:
            shortcut = R.DownsampleShortcut(
                _t(get(f"{name}.downsample.1.weight")),
                *map(_t, bireal_fold(variables, f"{name}.downsample.2", eps)))
        convs.append(R.ResidualBinaryConv(
            _t(wp), _t(padding_correction(pattern, h, w, stride)),
            *map(_t, bireal_fold(variables, f"{name}.bn1", eps, alpha)), k=k,
            stride=stride, shortcut=shortcut, index=index))
        h, w = -(-h // stride), -(-w // stride)
    head = R.FloatLinearHead(_t(get("fc.weight")), _t(get("fc.bias")))
    return R.BiRealResNet(first, convs, R.GlobalAvgPool(), head).to(device)


def pack_int8(variables: dict, cf: Config,
              device="cuda") -> E.I8MLP | E.I8VGG:
    """Lower a trained model into the int8 engine
    (:mod:`qnx_torch.nn.int8_engine`) on ``device``: an
    :class:`~qnx_torch.nn.int8_engine.I8MLP` or
    :class:`~qnx_torch.nn.int8_engine.I8VGG`, for every quantized
    ``network_type``:

    * ``full-bnn`` / ``full-tnn`` / ``full-qnn``: the integer path.  Weights
      become int8 patterns ({-1, +1} binary, {-1, 0, +1} ternary, or
      pow2-grid integers, which need wbits <= 8), activations int8 codes:
      ``pm1`` for binary_tanh, ``zo`` for binary_sigmoid, ``levels`` for
      quantized_relu and ``tanh`` for quantized_tanh, with BN folded into
      integer thresholds (``fold_bn_sign`` for pm1 and zo,
      ``fold_bn_levels`` for the level codes, the level step q folded into
      alpha).  The codes are the activation values up to that exact step,
      so no offset or pad correction is needed.
    * ``bnn`` / ``tnn`` / ``qnn``: the relu network types, quantized
      weights stored int8 with a scalar scale and float relu activations
      (:func:`_pack_int8_relu`).
    """
    device = _check_device(device)
    if cf.network_type not in ("full-bnn", "full-tnn", "full-qnn",
                               "bnn", "tnn", "qnn"):
        raise ValueError(f"int8 engine requires a quantized network_type; "
                         f"got {cf.network_type}")
    if cf.network_type in ("full-qnn", "qnn") and cf.wbits > 8:
        raise ValueError(
            f"int8 engine holds pow2-grid weights as int8 integers, which "
            f"requires wbits <= 8; got wbits={cf.wbits}")
    act_op = _engine_activation(cf)
    if cf.architecture == "vgg":
        validate_vgg_variables(variables, cf)
    params = variables["params"]
    quant = variables.get("quant", {})
    stats = variables["batch_stats"]
    eps = cf.batch_norm_epsilon
    nb = cf.abits
    act = {"binary_tanh": "pm1", "binary_sigmoid": "zo",
           "quantized_relu": "levels", "quantized_tanh": "tanh",
           "relu": "relu"}[act_op]
    q_in = 1.0 if act in ("pm1", "zo") else 2.0 ** (1 - nb)

    def get(name):
        latent = _np(params[name]["kernel"])
        bias = _np(params[name]["bias"]) if "bias" in params[name] else None
        h = float(quant[name]["H"]) if name in quant else None
        return latent, h, bias

    def pattern_alpha(latent, h):
        if cf.network_type in ("full-tnn", "tnn"):
            return _ternary_pattern(latent, h, cf.ternary_style)
        if cf.network_type in ("full-qnn", "qnn"):
            return _quant_grid(latent, h, cf.wbits)
        return _binary_pattern(latent, h), h

    if cf.network_type in ("bnn", "tnn", "qnn"):
        return _pack_int8_relu(variables, cf, get, pattern_alpha,
                               eps).to(device)

    def bn_of(name):
        return _bn(params, stats, name, eps)

    def fold_hidden(bn, alpha, bias):
        if act in ("pm1", "zo"):
            thr = fold_bn_sign(bn["gamma"], bn["beta"], bn["mean"], bn["var"],
                               eps, alpha=alpha * q_in, bias=bias)
        else:
            thr = fold_bn_levels(bn["gamma"], bn["beta"], bn["mean"],
                                 bn["var"], eps, nb, alpha=alpha * q_in,
                                 bias=bias,
                                 mode="tanh" if act == "tanh" else "relu")
        return _t(thr.sgn), _t(thr.tau)

    def first_quant_w(latent, h):
        """First layer weights as f32 values (quantized if not float)."""
        if h is None:
            return latent.astype(np.float32)
        pattern, alpha = pattern_alpha(latent, h)
        return (pattern * alpha).astype(np.float32)

    def bn_kwargs(bn):
        return dict(bn_scale=_t(bn["gamma"]), bn_bias=_t(bn["beta"]),
                    bn_mean=_t(bn["mean"]), bn_var=_t(bn["var"]), bn_eps=eps)

    def hidden_weights(name, bn_name):
        latent, h, bias = get(name)
        pattern, alpha = pattern_alpha(latent, h)
        sgn, tau = fold_hidden(bn_of(bn_name), alpha, bias)
        return dict(w8=_t(pattern.astype(np.int8)), sgn=sgn, tau=tau, act=act)

    def head_layer(name, bn_name):
        latent, h, bias = get(name)
        bn = bn_of(bn_name)
        if name not in quant:
            return E.I8FloatHead(
                w=_t(latent.astype(np.float32)),
                bias=None if bias is None else _t(bias), q=q_in,
                **bn_kwargs(bn))
        pattern, alpha = pattern_alpha(latent, h)
        aff = fold_bn_affine(bn["gamma"], bn["beta"], bn["mean"], bn["var"],
                             eps, alpha=alpha * q_in, bias=bias)
        return E.I8DenseLogits(w8=_t(pattern.astype(np.int8)), a=_t(aff.a),
                               c=_t(aff.c0))

    def first_kwargs(name, bn_name):
        latent, h, bias = get(name)
        return dict(w=_t(first_quant_w(latent, h)),
                    bias=None if bias is None else _t(bias), act=act, nb=nb,
                    **bn_kwargs(bn_of(bn_name)))

    if cf.architecture == "mlp":
        first = E.I8FirstDense(**first_kwargs("dense_0", "bn_0"))
        hidden = [E.I8Dense(**hidden_weights(f"dense_{i}", f"bn_{i}"))
                  for i in range(1, cf.num_hidden)]
        model = E.I8MLP(first=first, hidden=hidden,
                        head=head_layer("dense_out", "bn_out"))
    elif cf.architecture == "vgg":
        first = E.I8FirstConv(**first_kwargs("conv_0", "bn_conv_0"), pool=False)
        convs = [E.I8Conv(**hidden_weights(f"conv_{i}", f"bn_conv_{i}"),
                          pool=i % 2 == 1) for i in range(1, 6)]
        denses = [E.I8Dense(**hidden_weights(f"dense_{j}", f"bn_dense_{j}"))
                  for j in range(2)]
        model = E.I8VGG(first=first, convs=convs, denses=denses,
                        head=head_layer("dense_out", "bn_out"))
    else:
        raise ValueError(f"unknown architecture {cf.architecture!r}")
    return model.to(device)


def _pack_int8_relu(variables: dict, cf: Config, get, pattern_alpha,
                    eps: float) -> E.I8MLP | E.I8VGG:
    """The relu network types (``bnn`` / ``tnn`` / ``qnn``): quantized
    weights stored int8 with a scalar dequant scale, float relu activations
    (only the weights are quantized); a float boundary layer keeps float32
    weights with alpha = 1."""
    params = variables["params"]
    stats = variables["batch_stats"]

    def layer(cls, name, bn_name, **kw):
        latent, h, bias = get(name)
        if h is None:  # float boundary layer
            w, alpha = _t(latent.astype(np.float32)), 1.0
        else:
            pattern, alpha = pattern_alpha(latent, h)
            w = _t(pattern.astype(np.int8))
        bn = _bn(params, stats, bn_name, eps)
        return cls(w=w, alpha=torch.tensor(alpha, dtype=torch.float32),
                   bias=None if bias is None else _t(bias),
                   bn_scale=_t(bn["gamma"]), bn_bias=_t(bn["beta"]),
                   bn_mean=_t(bn["mean"]), bn_var=_t(bn["var"]), bn_eps=eps,
                   **kw)

    if cf.architecture == "mlp":
        denses = [layer(E.I8WDense, f"dense_{i}", f"bn_{i}")
                  for i in range(cf.num_hidden)]
        return E.I8MLP(first=denses[0], hidden=denses[1:],
                       head=layer(E.I8WHead, "dense_out", "bn_out"))
    if cf.architecture == "vgg":
        convs = [layer(E.I8WConv, f"conv_{i}", f"bn_conv_{i}", pool=i % 2 == 1)
                 for i in range(6)]
        denses = [layer(E.I8WDense, f"dense_{j}", f"bn_dense_{j}")
                  for j in range(2)]
        return E.I8VGG(first=convs[0], convs=convs[1:], denses=denses,
                       head=layer(E.I8WHead, "dense_out", "bn_out"))
    raise ValueError(f"unknown architecture {cf.architecture!r}")
