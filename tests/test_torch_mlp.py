"""The qnx_torch packed MLP (binary and ternary) against the JAX package on
the same numpy variables: the variable tree, the packed buffers, every
layer's output words, the heads' int32 s, the logits, and the serving
engine.  Off the card every packed layer runs its kernel's plain version."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from engine_test_utils import MLP_CF
from qnx.convert.pack_model import pack_mlp as jax_pack_mlp
from qnx.kernels.ternary_gemm import ternary_gemm as jax_ternary_gemm
from qnx.kernels.xnor_gemm import xnor_gemm_popcount as jax_xnor_gemm_popcount
from qnx.models.factory import build_model, init_model
from qnx.nn import inference as JI
from qnx.ops.packing import unpack_bits as jax_unpack_bits
from qnx.utils.config import MNIST_BNN, MNIST_TNN
from qnx_torch.convert.pack_model import pack_mlp
from qnx_torch.models.factory import init_variables
from qnx_torch.nn import inference as TI
from qnx_torch.serve.engine import ServeEngine, normalize_u8

torch.set_num_threads(2)

TNN_CF = MLP_CF.replace(network_type="full-tnn", wbits=2)
# logits: equal bits and equal s feed the same affine head; only the f32
# summation order of the first matmul can differ between XLA and torch
RTOL, ATOL_REL = 1e-5, 1e-4

SMALL = {
    "bnn": MLP_CF,
    "tnn-dingke": TNN_CF,
    "tnn-twn": TNN_CF.replace(ternary_style="twn"),
    "binary_sigmoid": MLP_CF.replace(activation="binary_sigmoid"),
    "tnn-binary_sigmoid": TNN_CF.replace(activation="binary_sigmoid"),
    "bnn-dim80": MLP_CF.replace(dim=80),
    "tnn-dim80": TNN_CF.replace(dim=80),
}


def _images(n, seed):
    u8 = np.random.default_rng(seed).integers(0, 256, (n, 28, 28, 1),
                                              dtype=np.uint8)
    return u8, normalize_u8(torch.from_numpy(u8)).numpy()


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_shapes(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = (tuple(np.shape(v)), np.dtype(v.dtype))
    return out


@pytest.mark.parametrize("cf,evaluate", [
    (MLP_CF, True), (TNN_CF.replace(dim=80, use_bias=True), True),
    (MNIST_BNN, False), (MNIST_TNN, False)],
    ids=["MLP_CF", "tnn-dim80-bias", "mnist-bnn", "mnist-tnn"])
def test_init_variables_tree_matches_flax(cf, evaluate):
    if evaluate:
        _, flax_vars = init_model(cf, jax.random.PRNGKey(0))
    else:  # full width: shapes only
        dummy = jnp.zeros((1, *cf.input_shape), jnp.float32)
        flax_vars = jax.eval_shape(
            lambda r: build_model(cf).init(r, dummy, train=False),
            jax.random.PRNGKey(0))
    assert _shapes(init_variables(cf, seed=0)) == _shapes(flax_vars)


def test_init_variables_draws_exercise_the_epilogue():
    """Ternary latents uniform in ±H: about half of the dingke weights are 0;
    BN scales of both signs, two constant-bit channels per hidden BN."""
    cf = TNN_CF.replace(dim=256)
    v = init_variables(cf, seed=4)
    tm = pack_mlp(v, cf, device="cpu")
    for layer in tm.hidden:
        share = 1.0 - float(layer.nnz.sum()) / (layer.mask.shape[0] * 32
                                                * layer.mask.shape[1])
        assert 0.4 < share < 0.6
        assert (layer.sgn == -1).any() and (layer.sgn == 1).any()
        assert layer.tau.min() == -2**31 and layer.tau.max() == 2**31 - 1
    for i in range(cf.num_hidden):
        assert (v["params"][f"bn_{i}"]["scale"] == 0).sum() == 2


def _jax_layers(jm):
    return [("first", jm.first), *[(f"hidden.{i}", l) for i, l in enumerate(jm.hidden)],
            ("head", jm.head)]


def _assert_buffers_equal(jm, tm):
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


@pytest.mark.parametrize("cf", list(SMALL.values()), ids=list(SMALL))
def test_pack_mlp_buffers_equal_jax_leaves(cf):
    variables = init_variables(cf, seed=3)
    _assert_buffers_equal(jax_pack_mlp(variables, cf),
                          pack_mlp(variables, cf, device="cpu"))


@pytest.mark.parametrize("cf", [MNIST_BNN, MNIST_TNN], ids=["mnist-bnn", "mnist-tnn"])
def test_pack_mlp_buffers_equal_jax_leaves_full_width(cf):
    variables = init_variables(cf, seed=0)
    tm = pack_mlp(variables, cf, device="cpu")
    _assert_buffers_equal(jax_pack_mlp(variables, cf), tm)
    # FloatDenseBits -> 2 hidden layers -> integer head
    kind = "Ternary" if cf.network_type == "full-tnn" else "Packed"
    assert [type(l).__name__ for l in tm.hidden] == [f"{kind}DenseBits"] * 2
    assert type(tm.head).__name__ == f"{kind}DenseLogits"


def _head_s(head, bits):
    """The JAX head's int32 s through its own kernel (interpret mode)."""
    if isinstance(head, JI.TernaryDenseLogits):
        return jax_ternary_gemm(bits, head.mask, head.sign, head.nnz)
    return jax_xnor_gemm_popcount(bits, head.wp, head.k)


@pytest.mark.parametrize("cf", list(SMALL.values()), ids=list(SMALL))
def test_packed_layers_bit_exact_vs_jax(cf):
    """Fed the same input bits, every hidden layer's words and the head's
    int32 s equal JAX's; the first layer's words may differ only where the
    BN output is within rounding of 0."""
    variables = init_variables(cf, seed=5)
    jm, tm = jax_pack_mlp(variables, cf), pack_mlp(variables, cf, device="cpu")
    _, x = _images(6, seed=6)
    x = x.reshape(6, -1)
    bits = jm.first(jnp.asarray(x))
    with torch.inference_mode():
        first = tm.first(torch.from_numpy(x)).numpy()
        k = cf.dim
        differ = (np.asarray(jax_unpack_bits(bits, k))
                  != np.asarray(jax_unpack_bits(jnp.asarray(first), k)))
        if differ.any():  # float64 BN output at the differing positions
            f = {k: v.double().numpy() for k, v in tm.first.named_buffers()}
            y = x.astype(np.float64) @ f["w"] + f.get("bias", 0.0)
            z = ((y - f["bn_mean"]) / np.sqrt(f["bn_var"] + tm.first.bn_eps)
                 * f["bn_scale"] + f["bn_bias"])
            assert np.abs(z[differ]).max() < 1e-5
        for i, (jl, tl) in enumerate(zip(jm.hidden, tm.hidden)):
            want = jl(bits)
            got = tl(torch.tensor(np.asarray(bits)))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"hidden {i + 1}")
            bits = want
        tbits = torch.tensor(np.asarray(bits))
        np.testing.assert_array_equal(tm.head.scores(tbits).numpy(),
                                      np.asarray(_head_s(jm.head, bits)))
        np.testing.assert_allclose(tm.head(tbits).numpy(),
                                   np.asarray(jm.head(bits)), rtol=RTOL,
                                   atol=1e-6)


@pytest.mark.parametrize("cf", list(SMALL.values()), ids=list(SMALL))
def test_logits_match_jax_mlp_forward(cf):
    variables = init_variables(cf, seed=8)
    _, x = _images(8, seed=9)
    want = np.asarray(JI.mlp_forward(jax_pack_mlp(variables, cf), jnp.asarray(x)))
    got = TI.mlp_forward(pack_mlp(variables, cf, device="cpu"),
                         torch.from_numpy(x)).numpy()
    assert got.shape == (8, cf.classes) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_REL * np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_float_dense_logits_matches_jax():
    """FloatDenseLogits (no converter builds it) against the JAX class on
    ±1 inputs, with and without a bias."""
    rng = np.random.default_rng(14)
    x = np.where(rng.random((5, 70)) < 0.5, 1.0, -1.0).astype(np.float32)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    for bias in (f32(10), None):
        leaves = dict(w=f32(70, 10), bias=bias, bn_scale=f32(10),
                      bn_bias=f32(10), bn_mean=f32(10),
                      bn_var=rng.uniform(0.5, 2.0, 10).astype(np.float32))
        jl = JI.FloatDenseLogits(**{k: None if v is None else jnp.asarray(v)
                                    for k, v in leaves.items()}, bn_eps=1e-3)
        tl = TI.FloatDenseLogits(**{k: None if v is None else torch.from_numpy(v)
                                    for k, v in leaves.items()}, bn_eps=1e-3)
        want = np.asarray(jl(jnp.asarray(x)))
        with torch.inference_mode():
            got = tl(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


def test_serve_engine_serves_the_mlp():
    """uint8 (B, 28, 28, 1) requests through the engine equal the direct
    forward, across a split chunk and a padded tail."""
    model = pack_mlp(init_variables(TNN_CF, seed=10), TNN_CF, device="cpu")
    u8, _ = _images(11, seed=11)
    engine = ServeEngine(model, batch_size=4, max_wait_ms=50.0)
    futs = [f for chunk in (u8[:3], u8[3:9], u8[9:])
            for f in engine.submit_many(chunk)]
    with engine:
        got = np.stack([f.result(timeout=120) for f in futs])
    stats = engine.stats()
    assert (stats["batches"], stats["images"]) == (3, 11)
    want = TI.mlp_forward(model, normalize_u8(torch.from_numpy(u8))).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=1e-6 * np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_pack_mlp_rejects_what_it_does_not_lower():
    with pytest.raises(ValueError, match="mlp"):
        pack_mlp({}, MLP_CF.replace(architecture="vgg"), device="cpu")
    with pytest.raises(ValueError, match="binary activations"):
        pack_mlp({}, MLP_CF.replace(network_type="full-qnn", wbits=2, abits=2),
                 device="cpu")
    with pytest.raises(ValueError, match="activation override"):
        pack_mlp({}, MLP_CF.replace(activation="quantized_relu"), device="cpu")
