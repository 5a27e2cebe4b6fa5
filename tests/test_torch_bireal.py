"""Bi-Real Net-18 through the port (``qnx_torch.nn.bireal``, ``pack_bireal``,
kernel A's residual epilogue ``xnor_conv_residual``) on the CPU at a small
size: the residual conv's plain version against a direct formula, the
packer against the variables, the served model against the benchmark's
plain reference ``qbench/models/bireal_resnet.py`` (the JAX package has no
residual model), and the benchmark's work rows and readers."""
import math

import numpy as np
import pytest
import torch

from qbench import checks, registry
from qnx_torch.convert.pack_model import bireal_fold, bireal_layers, pack_bireal
from qnx_torch.kernels.xnor_conv import pack_conv_weights_np, padding_correction
from qnx_torch.kernels.xnor_conv_fused import xnor_conv_residual, xnor_conv_residual_ref
from qnx_torch.nn.bireal import BiRealResNet
from qnx_torch.ops.packing import pack_bits, pack_bits_np, unpack_bits
from qnx_torch.serve import engine as serve
from qnx_torch.serve.engine import ServeEngine, normalize_u8
from qnx_torch.utils.config import CONFIGS, IMAGENET_BIREAL18

torch.set_num_threads(2)

ARCH = registry.architecture("bireal_resnet")
# 32x32 inputs, width 8, 10 classes: the stages run at 8, 4, 2 and 1 pixels
SMALL = IMAGENET_BIREAL18.replace(dataset="CIFAR-10", width=8, classes=10)
SPEC = {"width": 8, "classes": 10, "batch_norm_epsilon": 1e-5, "dataset": "ImageNet"}


def _pm1(rng, shape):
    return np.where(rng.random(shape) < 0.5, 1.0, -1.0).astype(np.float32)


def _direct(x, pattern, stride, scale, shift, res):
    """The residual conv written out: zero-padded taps at the stride, the
    exact integer s, then float32 (s * scale + shift) + res, one rounding a
    step, and the bits of x_new >= 0."""
    b, h, w, _ = x.shape
    ho, wo = -(-h // stride), -(-w // stride)
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    s = np.zeros((b, ho, wo, pattern.shape[-1]), np.int64)
    for dy in range(3):
        for dx in range(3):
            patch = xp[:, dy:dy + stride * (ho - 1) + 1:stride,
                       dx:dx + stride * (wo - 1) + 1:stride]
            s += np.rint(np.einsum("bhwc,cn->bhwn", patch.astype(np.float64),
                                   pattern[dy, dx])).astype(np.int64)
    v = s.astype(np.float32) * scale
    v = v + shift
    v = v + res
    return v, pack_bits_np(np.where(v >= 0, 1.0, -1.0), axis=-1)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("n", [32, 64, 128])
@pytest.mark.parametrize("c", [32, 64, 96])
def test_residual_conv_plain_version_is_the_formula(c, n, stride):
    rng = np.random.default_rng(c * 1000 + n * 10 + stride)
    b, h, w = 2, 7, 6
    ho, wo = -(-h // stride), -(-w // stride)
    x = _pm1(rng, (b, h, w, c))
    pattern = _pm1(rng, (3, 3, c, n))
    scale = (rng.uniform(0.01, 0.2, n) * _pm1(rng, n)).astype(np.float32)
    shift = rng.normal(0, 1, n).astype(np.float32)
    res = rng.normal(0, 2, (b, ho, wo, n)).astype(np.float32)
    wp, k = pack_conv_weights_np(pattern)
    t = torch.from_numpy
    got_v, got_bits = xnor_conv_residual(
        t(pack_bits_np(x, axis=-1)), t(wp), k, t(padding_correction(pattern, h, w, stride)),
        t(scale), t(shift), t(res), stride)
    want_v, want_bits = _direct(x, pattern, stride, scale, shift, res)
    assert got_v.dtype == torch.float32 and got_v.shape == (b, ho, wo, n)
    np.testing.assert_array_equal(got_v.numpy().view(np.int32), want_v.view(np.int32))
    np.testing.assert_array_equal(got_bits.numpy(), want_bits)
    assert (want_bits != 0).any() and (want_bits != -1).any()


def test_residual_conv_pad_bits_and_shapes():
    """A channel count that leaves a partial word: the last word's pad bits
    0; and the wrapper's checks."""
    rng = np.random.default_rng(3)
    c, n = 8, 40
    x = _pm1(rng, (1, 4, 4, c))
    pattern = _pm1(rng, (3, 3, c, n))
    wp, k = pack_conv_weights_np(pattern)
    t = torch.from_numpy
    args = [t(pack_bits_np(x, axis=-1)), t(wp), k, t(padding_correction(pattern, 4, 4, 2)),
            t(np.full(n, 0.5, np.float32)), t(np.zeros(n, np.float32)),
            t(np.full((1, 2, 2, n), -100.0, np.float32))]
    v, bits = xnor_conv_residual(*args, stride=2)
    want_v, want_bits = _direct(x, pattern, 2, np.float32(0.5), np.float32(0), -100.0)
    np.testing.assert_array_equal(v.numpy(), want_v)
    assert bits.shape == (1, 2, 2, 2) and (bits == 0).all()  # every x_new < 0
    args[-1] = t(np.full((1, 2, 2, n), 100.0, np.float32))
    assert (xnor_conv_residual(*args, stride=2)[1][..., 1] == 0xFF).all()
    with pytest.raises(ValueError, match="stride"):
        xnor_conv_residual(*args, stride=3)
    with pytest.raises(ValueError, match="corr"):
        xnor_conv_residual(*args, stride=1)


def test_padding_correction_at_stride_two_counts_the_outside_taps():
    rng = np.random.default_rng(4)
    pattern = _pm1(rng, (3, 3, 5, 3))
    h, w = 6, 7
    corr = padding_correction(pattern, h, w, 2)
    assert corr.shape == (3, 4, 3)
    wsum = pattern.sum(axis=2)
    for y in range(3):
        for x in range(4):
            want = sum((wsum[dy, dx] for dy in range(3) for dx in range(3)
                        if not (0 <= 2 * y + dy - 1 < h and 0 <= 2 * x + dx - 1 < w)),
                       np.zeros(3))
            np.testing.assert_array_equal(corr[y, x], want)
    np.testing.assert_array_equal(padding_correction(pattern, h, w, 1),
                                  padding_correction(pattern, h, w))


@pytest.mark.parametrize("shape,axis", [((3, 5, 8), -1), ((2, 64), 0), ((4, 7, 96), 1),
                                        ((1, 33), -1)])
def test_pack_bits_is_the_host_packer(shape, axis):
    """pack_bits' uint8 byte sums against the host's uint32 words, zeros and
    -0.0 included, on floats and on the stream's ``x >= 0``."""
    x = torch.randn(shape, generator=torch.Generator().manual_seed(sum(shape)))
    x.view(-1)[0] = 0.0
    x.view(-1)[1] = -0.0
    for v in (x, x >= 0):
        got = pack_bits(v, axis=axis)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), pack_bits_np(v.numpy(), axis=axis))


def _variables(seed=11):
    return ARCH.make_variables(SPEC, seed, "cpu")


def test_pack_bireal_words_alpha_and_fold():
    v = _variables()
    model = pack_bireal(v, SMALL, device="cpu")
    eps = SMALL.batch_norm_epsilon
    assert len(model.convs) == 16 and [c.stride for c in model.convs].count(2) == 3
    for conv, (name, c, n, stride) in zip(model.convs, bireal_layers(SMALL)):
        latent = v[f"{name}.binary_conv.weights"]
        assert latent.shape == (n, c, 3, 3)
        words = conv.wp.reshape(9, -1, n)  # tap-major (9 * Cw, N)
        got = unpack_bits(words, c, axis=1, dtype=torch.float32).reshape(3, 3, c, n)
        want = np.where(latent >= 0, 1.0, -1.0).transpose(2, 3, 1, 0)
        np.testing.assert_array_equal(got.numpy(), want)
        alpha = np.mean(np.abs(latent.astype(np.float64)), axis=(1, 2, 3))
        gamma, beta, mean, var = (v[f"{name}.bn1.{k}"].astype(np.float64) for k in
                                  ("weight", "bias", "running_mean", "running_var"))
        inv = gamma / np.sqrt(var + eps)
        # alpha is mean|W| and the fold is rounded once
        np.testing.assert_allclose(conv.scale.numpy() / inv, alpha, rtol=2**-23)
        scale = conv.scale.numpy().astype(np.float64)
        assert (np.abs(scale - alpha * inv) <= np.spacing(np.abs(conv.scale.numpy())) / 2).all()
        # the folded affine against the unfolded BatchNorm of alpha * s, on
        # integer s, in ulps of the larger term: scale's rounding (up to 1
        # once times s), shift's (1/2), the product's (1/2), the sum's (up to
        # 1, the sum reaching twice the term)
        s = np.arange(-9 * c, 9 * c + 1, 7, dtype=np.float64)[:, None]
        folded = (s.astype(np.float32) * conv.scale.numpy()) + conv.shift.numpy()
        exact = gamma * (alpha * s - mean) / np.sqrt(var + eps) + beta
        terms = np.maximum(np.abs(s * scale), np.abs(conv.shift.numpy()))
        assert (np.abs(folded - exact) <= 3 * np.spacing(terms.astype(np.float32))).all()
        assert (conv.stride == 2) == (conv.shortcut is not None)
    np.testing.assert_array_equal(model.first.w.numpy(), v["conv1.weight"])
    np.testing.assert_array_equal(model.head.bias.numpy(), v["fc.bias"])
    scale, shift = bireal_fold(v, "bn1", eps)
    np.testing.assert_array_equal(model.first.scale.numpy(), scale)


def _images(n, seed, shape=(32, 32, 3)):
    return np.random.default_rng(seed).integers(0, 256, (n, *shape), dtype=np.uint8)


@pytest.mark.parametrize("seed", [5, 2**31 + 19])
def test_served_model_equals_the_reference(seed):
    """``ServeEngine`` over ``pack_bireal`` on the CPU against the plain
    reference, every image within the benchmark's gate (``ATOL_REL`` of the
    image's largest |logit| plus ``RTOL``); the control (TF32) outside it."""
    v = ARCH.make_variables(SPEC, seed, "cpu")
    images = _images(40, seed)
    with ServeEngine(pack_bireal(v, SMALL, device="cpu"), batch_size=16) as engine:
        logits = engine.predict(images)
    x = torch.from_numpy(images)
    ref = ARCH.reference_logits(SPEC, v, x).numpy()
    assert logits.shape == (40, 10)
    assert not checks.mismatched(logits, ref).any()
    ctl = ARCH.reference_logits(SPEC, v, x, "tf32").numpy()
    assert checks.mismatched(ctl, ref).mean() > 0.5


@pytest.mark.parametrize("precision", ["exact", "tf32"])
def test_the_reference_leaves_tf32_as_it_found_it(precision, monkeypatch):
    """The reference turns TF32 off for itself alone: its logits do not
    depend on the flags it is called under, and it restores them."""
    v = _variables(13)
    x = torch.from_numpy(_images(6, 13))
    want = ARCH.reference_logits(SPEC, v, x, precision)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    got = ARCH.reference_logits(SPEC, v, x, precision)
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    assert got.dtype == torch.float32 and got.shape == (6, 10)
    assert torch.equal(got, want)


def test_every_stage_stream_takes_both_signs():
    model = pack_bireal(_variables(17), SMALL, device="cpu")
    with torch.inference_mode():
        x, bits = model.first(normalize_u8(torch.from_numpy(_images(8, 17))))
        streams = [x]
        for conv in model.convs:
            x, bits = conv(x, bits)
            streams.append(x)
    for s in streams:
        assert (s >= 0).any() and (s < 0).any()


def test_counters_count_and_time_the_parts():
    model = pack_bireal(_variables(), SMALL, device="cpu")
    x = normalize_u8(torch.from_numpy(_images(4, 1)))
    with torch.inference_mode():
        model(x)
        model(x)  # no profiler: not timed
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            model(x)
    c = model.counters()
    assert (c["forwards"], c["images"], c["timed_forwards"]) == (3, 12, 1)
    assert (c["resconv_stride1"], c["resconv_stride2"], c["shortcut_calls"]) == (39, 9, 9)
    assert all(c[f"{p}_ms"] > 0 for p in ("stem", "resconv", "shortcut", "pool_head"))


def test_the_first_forward_is_not_timed():
    model = pack_bireal(_variables(), SMALL, device="cpu")
    with torch.inference_mode(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        model(normalize_u8(torch.from_numpy(_images(2, 1))))
    c = model.counters()
    assert c["forwards"] == 1 and c["timed_forwards"] == 0 and c["resconv_ms"] == 0.0


def test_layer_work_at_224():
    spec = registry._json(registry.HERE / "configs" / "imagenet-bireal18.json")
    rows = ARCH.layer_work(spec)
    by = lambda stage: [r for r in rows if r["stage"] == stage]  # noqa: E731
    assert sum(r["macs"] for r in by("convs")) == 1_676_279_808
    assert all(r["unit"] == "b1" and r["b1_per_mac"] == 1 for r in by("convs"))
    assert [sum(r["macs"] for r in by(s)) for s in ("first", "shortcuts", "head")] == [
        118_013_952, 19_267_584, 512_000]
    assert len(by("convs")) == 16 and len(by("shortcuts")) == 3
    # the residual convs are bound by the float32 stream's bytes
    from qbench.leasttime import bytes_s, compute_s
    assert all(bytes_s(r, 1024) > compute_s(r, 1024) for r in by("convs"))
    assert (sum(bytes_s(r, 1024) for r in by("convs"))
            > 10 * sum(compute_s(r, 1024) for r in by("convs")))


def test_preset_and_config_file():
    cf = CONFIGS["imagenet-bireal18"]
    assert cf is IMAGENET_BIREAL18 and cf.input_shape == (224, 224, 3)
    assert (cf.architecture, cf.width, cf.classes, cf.batch_norm_epsilon) == (
        "bireal18", 64, 1000, 1e-5)
    model = pack_bireal(ARCH.make_variables({**SPEC, "width": 4, "classes": 3}, 1, "cpu"),
                        cf.replace(width=4, classes=3), device="cpu")
    assert isinstance(model, BiRealResNet)
    assert model.convs[-1].corr.shape == (7, 7, 32)  # 224 -> 56 -> 28, 14, 7
    with pytest.raises(ValueError, match="bireal18"):
        pack_bireal({}, CONFIGS["cifar10-bnn"], device="cpu")


class _Counting:
    def __init__(self, counters):
        self.model = type("M", (), {"counters": lambda _: counters})()


@pytest.mark.parametrize("name,want", [
    ("resconv_roofline", lambda ctx: 100 * ctx.least_s("convs") / 0.004),
    ("shortcut_ms", lambda ctx: 1.5)])
def test_model_counter_readers(name, want, monkeypatch):
    from qbench.run import Context

    ctx = Context(least_s=lambda stage=None: 1e-3 if stage == "convs" else 2e-3)
    monkeypatch.setattr(serve, "last_started", lambda: _Counting(
        {"timed_forwards": 4, "resconv_ms": 16.0, "shortcut_ms": 6.0}))
    assert registry.reader(name).read(ctx) == pytest.approx(want(ctx))
    monkeypatch.setattr(serve, "last_started", lambda: _Counting(
        {"timed_forwards": 0, "resconv_ms": 0.0, "shortcut_ms": 0.0}))
    assert registry.reader(name).read(ctx) is None
    monkeypatch.setattr(serve, "last_started", lambda: None)
    assert registry.reader(name).read(ctx) is None
    assert math.isfinite(ctx.least_s("convs"))
