"""The qnx_torch packed VGG, binary and ternary weights, against the JAX
package on the same numpy variables: the variable tree, the packed buffers, every packed layer's
output words, the logits, and the serving engine.  Off the card every packed
layer runs its kernel's plain version."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from engine_test_utils import VGG_CF
from qnx.convert.pack_model import pack_vgg as jax_pack_vgg
from qnx.kernels.ternary_gemm import ternary_gemm as jax_ternary_gemm
from qnx.kernels.xnor_gemm import xnor_gemm_popcount as jax_xnor_gemm_popcount
from qnx.models.factory import build_model, init_model
from qnx.nn.inference import PackedDenseLogits as JaxPackedDenseLogits
from qnx.nn.inference import TernaryDenseLogits as JaxTernaryDenseLogits
from qnx.nn.inference import vgg_forward as jax_vgg_forward
from qnx.ops.packing import unpack_bits as jax_unpack_bits
from qnx.serve.engine import ServeEngine as JaxServeEngine
from qnx.utils.config import CIFAR10_BNN, CIFAR10_TNN
from qnx_torch.convert.pack_model import pack_vgg, pack_vgg_bitplane
from qnx_torch.models.factory import init_variables
from qnx_torch.nn.inference import vgg_forward
from qnx_torch.ops.packing import unpack_bits
from qnx_torch.serve.engine import ServeEngine, normalize_u8

torch.set_num_threads(2)

# the smallest VGG whose channel counts are whole packed words
SMALL_CF = VGG_CF.replace(width=32)
SIG_CF = SMALL_CF.replace(activation="binary_sigmoid")
# the JAX suite's own VGG (width 8: 8, 16 and 32 channels, dense 64), and
# with the binary packed head (PackedDenseLogits, kernel B)
HEAD_CF = VGG_CF.replace(last_layer_float=False)
# ternary weights with binary activations (abits 1): dingke and twn, the
# {0,1} input coding, and the ternary packed head (TernaryDenseLogits,
# kernel C); kernel A' conv and dense
TNN_CF = VGG_CF.replace(network_type="full-tnn", wbits=2)
TWN_CF = TNN_CF.replace(ternary_style="twn")
TNN_SIG_CF = SMALL_CF.replace(network_type="full-tnn", wbits=2,
                              activation="binary_sigmoid")
TNN_HEAD_CF = TNN_CF.replace(last_layer_float=False)
TERNARY_CFS = [TNN_CF, TWN_CF, TNN_SIG_CF, TNN_HEAD_CF]
TERNARY_IDS = ["ternary-width8", "twn", "ternary-binary_sigmoid",
               "ternary-head"]
# logits: equal bits feed the same float head; only the f32 summation order
# of the first conv and the head differ between XLA and torch
RTOL, ATOL_REL = 1e-5, 1e-4


def _images(n, seed, cf=SMALL_CF):
    u8 = np.random.default_rng(seed).integers(
        0, 256, (n, *cf.input_shape), dtype=np.uint8)
    return u8, normalize_u8(torch.from_numpy(u8)).numpy()


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_shapes(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = (tuple(np.shape(v)), np.dtype(v.dtype))
    return out


@pytest.mark.parametrize("cf,evaluate", [(VGG_CF, True), (CIFAR10_BNN, False)],
                         ids=["VGG_CF", "cifar10-bnn"])
def test_init_variables_tree_matches_flax(cf, evaluate):
    if evaluate:
        _, flax_vars = init_model(cf, jax.random.PRNGKey(0))
    else:  # full width: shapes only
        dummy = jnp.zeros((1, *cf.input_shape), jnp.float32)
        flax_vars = jax.eval_shape(
            lambda r: build_model(cf).init(r, dummy, train=False),
            jax.random.PRNGKey(0))
    assert _shapes(init_variables(cf, seed=0)) == _shapes(flax_vars)


def _jax_layers(jm):
    return [("first", jm.first), *[(f"convs.{i}", l) for i, l in enumerate(jm.convs)],
            *[(f"denses.{j}", l) for j, l in enumerate(jm.denses)],
            ("head", jm.head)]


@pytest.mark.parametrize("cf", [SMALL_CF, SIG_CF, CIFAR10_BNN, VGG_CF, HEAD_CF,
                                *TERNARY_CFS, CIFAR10_TNN.replace(abits=1)],
                         ids=["width32", "binary_sigmoid", "cifar10-bnn",
                              "width8", "binary-head", *TERNARY_IDS,
                              "cifar10-tnn-abits1"])
def test_pack_vgg_buffers_equal_jax_leaves(cf):
    variables = init_variables(cf, seed=3)
    jm, tm = jax_pack_vgg(variables, cf), pack_vgg(variables, cf, device="cpu")
    tlayers = dict(tm.named_modules())
    for name, jlayer in _jax_layers(jm):
        tlayer = tlayers[name]
        assert type(tlayer).__name__ == type(jlayer).__name__, name
        for f in dataclasses.fields(jlayer):
            want, got = getattr(jlayer, f.name), getattr(tlayer, f.name)
            if want is None or isinstance(want, (int, float, str, bool)):
                assert got == want, f"{name}.{f.name}"
            else:
                want = np.asarray(want)
                assert got.numpy().dtype == want.dtype, f"{name}.{f.name}"
                np.testing.assert_array_equal(got.numpy(), want,
                                              err_msg=f"{name}.{f.name}")
    # the random BN draws reach both threshold directions and both extremes
    for conv in tm.convs:
        assert (conv.sgn == -1).any() and (conv.sgn == 1).any()
        assert conv.tau.min() == -2**31 and conv.tau.max() == 2**31 - 1


@pytest.mark.parametrize("cf", [SMALL_CF, SIG_CF, VGG_CF, HEAD_CF, *TERNARY_CFS],
                         ids=["width32", "binary_sigmoid", "width8", "binary-head",
                              *TERNARY_IDS])
def test_packed_layers_bit_exact_vs_jax(cf):
    """Fed the same input bits, every packed layer's words equal JAX's."""
    variables = init_variables(cf, seed=5)
    jm, tm = jax_pack_vgg(variables, cf), pack_vgg(variables, cf, device="cpu")
    _, x = _images(4, seed=6, cf=cf)
    bits = jm.first(jnp.asarray(x))
    with torch.inference_mode():
        for i, (jl, tl) in enumerate(zip(jm.convs, tm.convs)):
            want = jl(bits)
            got = tl(torch.tensor(np.asarray(bits)))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"conv_{i + 1}")
            bits = want
        bits = bits.reshape(bits.shape[0], -1)
        for j, (jl, tl) in enumerate(zip(jm.denses, tm.denses)):
            want = jl(bits)
            got = tl(torch.tensor(np.asarray(bits)))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"dense_{j}")
            bits = want
        tbits = torch.tensor(np.asarray(bits))
        if isinstance(jm.head, JaxPackedDenseLogits):  # the head's int32 s
            np.testing.assert_array_equal(
                tm.head.scores(tbits).numpy(),
                np.asarray(jax_xnor_gemm_popcount(bits, jm.head.wp, jm.head.k)))
        if isinstance(jm.head, JaxTernaryDenseLogits):
            np.testing.assert_array_equal(
                tm.head.scores(tbits).numpy(),
                np.asarray(jax_ternary_gemm(bits, jm.head.mask, jm.head.sign,
                                            jm.head.nnz)))
        np.testing.assert_allclose(tm.head(tbits).numpy(),
                                   np.asarray(jm.head(bits)), rtol=RTOL, atol=1e-6)


def test_first_layer_bits_differ_only_near_zero():
    """XLA's and torch's f32 convs sum in different orders, so a first-layer
    bit may differ only where the BN output z is within rounding of 0."""
    variables = init_variables(CIFAR10_BNN, seed=0)
    jm = jax_pack_vgg(variables, CIFAR10_BNN)
    tm = pack_vgg(variables, CIFAR10_BNN, device="cpu")
    _, x = _images(8, seed=7, cf=CIFAR10_BNN)
    jbits = np.asarray(jax_unpack_bits(jm.first(jnp.asarray(x)), 128))
    with torch.inference_mode():
        tbits = tm.first(torch.from_numpy(x))
    tbits = unpack_bits(tbits, 128).numpy()
    differ = jbits != tbits
    assert differ.mean() <= 1e-4
    if differ.any():  # float64 z at the differing positions
        f = tm.first
        w = f.w.double().numpy()
        xp = np.pad(x.astype(np.float64), ((0, 0), (1, 1), (1, 1), (0, 0)))
        y = sum(np.einsum("bhwc,cn->bhwn", xp[:, dy:dy + 32, dx:dx + 32], w[dy, dx])
                for dy in range(3) for dx in range(3)) + f.bias.double().numpy()
        z = ((y - f.bn_mean.double().numpy())
             / np.sqrt(f.bn_var.double().numpy() + f.bn_eps)
             * f.bn_scale.double().numpy() + f.bn_bias.double().numpy())
        assert np.abs(z[differ]).max() < 1e-5


@pytest.mark.parametrize("cf", [SMALL_CF, SIG_CF, VGG_CF, HEAD_CF, *TERNARY_CFS],
                         ids=["width32", "binary_sigmoid", "width8", "binary-head",
                              *TERNARY_IDS])
def test_logits_match_jax_vgg_forward(cf):
    variables = init_variables(cf, seed=8)
    _, x = _images(8, seed=9, cf=cf)
    want = np.asarray(jax_vgg_forward(jax_pack_vgg(variables, cf), jnp.asarray(x)))
    got = vgg_forward(pack_vgg(variables, cf, device="cpu"),
                      torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_REL * np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("allow", [True, False], ids=["tf32-on", "tf32-off"])
def test_forward_leaves_the_callers_tf32_flags(allow):
    """The float layers switch TF32 off only around their own ops."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    model = pack_vgg(init_variables(SMALL_CF, seed=12), SMALL_CF, device="cpu")
    _, x = _images(2, seed=13)
    try:
        torch.backends.cuda.matmul.allow_tf32 = allow
        torch.backends.cudnn.allow_tf32 = allow
        vgg_forward(model, torch.from_numpy(x))
        assert torch.backends.cuda.matmul.allow_tf32 is allow
        assert torch.backends.cudnn.allow_tf32 is allow
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def test_serve_engine_matches_direct_forward():
    model = pack_vgg(init_variables(SMALL_CF, seed=10), SMALL_CF, device="cpu")
    u8, _ = _images(15, seed=11)
    engine = ServeEngine(model, batch_size=8, max_wait_ms=50.0)
    # queued before start: [3] + [5 of 10] | [5 carried] + [2] + 1 pad
    futs = [f for chunk in (u8[:3], u8[3:13], u8[13:])
            for f in engine.submit_many(chunk)]
    with engine:
        got = np.stack([f.result(timeout=120) for f in futs])
    stats = engine.stats()
    assert (stats["batches"], stats["images"]) == (2, 15)
    assert stats["pad_fraction"] == 1 / 16
    assert 0 < stats["wall_throughput_ips"] <= stats["throughput_ips"]
    want = vgg_forward(model, normalize_u8(torch.from_numpy(u8))).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=1e-6 * np.abs(want).max())
    # a float chunk in a uint8 batch: the uint8 chunk is normalised on the host
    engine = ServeEngine(model, batch_size=8, max_wait_ms=50.0)
    futs = (engine.submit_many(u8[:2])
            + engine.submit_many(normalize_u8(torch.from_numpy(u8[:2])).numpy()))
    with engine:
        mixed = np.stack([f.result(timeout=120) for f in futs])
    np.testing.assert_allclose(mixed, np.concatenate([want[:2], want[:2]]),
                               rtol=RTOL, atol=1e-6 * np.abs(want).max())


def test_uint8_normalisation_is_the_jax_engines_bit_for_bit():
    u8 = np.arange(256, dtype=np.uint8).reshape(256, 1, 1, 1)
    jax_engine = JaxServeEngine({}, batch_size=256, forward=lambda m, x: x)
    with jax_engine:
        want = jax_engine.predict(u8)
    got = normalize_u8(torch.from_numpy(u8)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_unported_variants_raise():
    """A mesh, served since the port has parallelism, still raises without
    a joined world; quantized_tanh, which raised before the bit-plane
    engine lowered it, builds in tanh mode (its parity with JAX is in
    tests/test_torch_activations.py); pack_vgg still refuses abits > 1."""
    model = pack_vgg(init_variables(SMALL_CF, seed=0), SMALL_CF, device="cpu")
    with pytest.raises(RuntimeError, match="mesh"):
        ServeEngine(model, mesh=object())
    cf = SMALL_CF.replace(network_type="full-tnn", wbits=2, abits=2,
                          activation="quantized_tanh")
    tanh = pack_vgg_bitplane(init_variables(cf, seed=0), cf, device="cpu")
    assert tanh.first.mode == "tanh" and tanh.head.lvl0 == 1
    assert all(conv.corr is not None for conv in tanh.convs)
    with pytest.raises(ValueError, match="abits=1"):
        pack_vgg(init_variables(cf, seed=0), cf, device="cpu")
