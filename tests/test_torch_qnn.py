"""The wbits > 1 and relu network types of the qnx_torch int8 engine against
the JAX package on the same numpy inputs: ``full-qnn`` (pow2-grid int8
weights through kernel E and ``_int_mm``, the activations' integer codes)
and the relu network types ``bnn``, ``tnn`` and ``qnn`` (int8 weights and a
scale, dequantized and run in float32: ``I8WConv``, ``I8WDense``,
``I8WHead``).  The quantizer and the weight grid bit for bit, kernel E's
plain version on grid weights down to -128 against the unfused JAX
``I8Conv``, every layer class, the converted leaves byte for byte, every
layer's codes and the logits."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from engine_test_utils import MLP_CF, VGG_CF
from qnx.convert import pack_model as jax_pm
from qnx.nn import int8_engine as JE
from qnx.ops import quant as jax_quant
from qnx_torch.convert import pack_model as PM
from qnx_torch.convert.pack_model import pack_int8
from qnx_torch.kernels import i8_conv_fused as K
from qnx_torch.models.factory import init_variables
from qnx_torch.nn import int8_engine as TE
from qnx_torch.ops import quant
from test_torch_int8 import _assert_leaves_equal, _np_leaves, _pair

torch.set_num_threads(2)

# logits: equal codes feed the same float head or affine; only the f32
# summation order of the first layer and of a float head differ.  The relu
# network types are float all the way down (six convs or three dense
# layers and the head, in XLA's and torch's f32 summation orders), and at
# these sizes they stay within the same tolerance
RTOL, ATOL_REL = 1e-5, 1e-4

QNN_CONFIGS = {f"{arch}-w{wbits}-a{abits}": base.replace(
    network_type="full-qnn", wbits=wbits, abits=abits)
    for arch, base in (("mlp", MLP_CF), ("vgg", VGG_CF))
    for wbits in (2, 4, 8) for abits in (1, 2)}
RELU_CONFIGS = {f"{arch}-{nt}": base.replace(network_type=nt, wbits=wbits)
                for arch, base in (("mlp", MLP_CF), ("vgg", VGG_CF))
                for nt, wbits in (("bnn", 1), ("tnn", 2), ("qnn", 4))}


# ------------------------------------------------------------ the grid


@pytest.mark.parametrize("nb", [2, 4, 8])
def test_quant_grid_is_the_quantizer_bit_for_bit(nb):
    """_quant_grid equals the JAX converter's, and alpha * z equals both
    quantizers' values bit for bit (the division by m = 2^(nb-1) is
    exact), the grid's ends included."""
    rng = np.random.default_rng(nb)
    h = 0.0625 if nb == 4 else 1.0
    m = 2 ** (nb - 1)
    ends = np.float32([-h, -h * (m - 0.5) / m, h * (m - 0.5) / m, h, 0.0])
    latent = np.concatenate([rng.uniform(-1.2 * h, 1.2 * h, 5000), ends,
                             (np.arange(-m, m) + 0.5) * h / m]).astype(np.float32)
    z, alpha = PM._quant_grid(latent, h, nb)
    jz, jalpha = jax_pm._quant_grid(latent, h, nb)
    np.testing.assert_array_equal(z, jz)
    assert alpha == jalpha == h / m
    assert z.min() == -m and z.max() == m - 1
    want = np.asarray(jax_quant.quantize(jnp.asarray(latent), nb, h))
    got = quant.quantize(torch.from_numpy(latent), nb, h).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    deq = (torch.from_numpy(z.astype(np.int8)).float()
           * torch.tensor(alpha, dtype=torch.float32)).numpy()
    np.testing.assert_array_equal(deq.view(np.uint32), want.view(np.uint32))


# ------------------------------------------------------------ kernel E


# (wbits, encoding, thresholds, pool, (b, h, w, c, n))
GRID_CASES = [(4, "levels", 1, True, (2, 6, 8, 16, 24)),
              (4, "pm1", 1, False, (3, 5, 7, 40, 33)),
              (8, "levels", 3, True, (2, 8, 8, 32, 48)),
              (8, "pm1", 1, True, (2, 7, 9, 16, 10))]


@pytest.mark.parametrize("wbits,encoding,n_thresh,pool,shape", GRID_CASES,
                         ids=[f"w{w}-{e}{t}-pool{p}-{s}"
                              for w, e, t, p, s in GRID_CASES])
def test_kernel_e_on_grid_weights_matches_jax_i8conv(wbits, encoding, n_thresh,
                                                     pool, shape):
    """Grid weights in [-2^(wbits-1), 2^(wbits-1) - 1], -128 included at
    wbits 8, through the plain version and the wrapper (with and without
    the K-major copy)."""
    b, h, w, c, n = shape
    rng = np.random.default_rng(sum(shape) + wbits)
    m = 2 ** (wbits - 1)
    wgt = rng.integers(-m, m, (3, 3, c, n), dtype=np.int8)
    wgt[0, 0, 0, :] = -m
    x = (np.where(rng.random((b, h, w, c)) < 0.5, 1, -1) if encoding == "pm1"
         else rng.integers(0, n_thresh + 1, (b, h, w, c))).astype(np.int8)
    sgn = rng.choice(np.array([1, -1], np.int32), n)
    lim = int(np.sqrt(9 * c)) * m * (n_thresh + 1)
    tau = np.sort(rng.integers(-lim, lim, (n_thresh, n)), axis=0).astype(np.int32)
    if encoding == "pm1":
        tau = tau[0]
    want = np.asarray(JE.I8Conv(w8=jnp.asarray(wgt), sgn=jnp.asarray(sgn),
                                tau=jnp.asarray(tau), act=encoding,
                                pool=pool)(jnp.asarray(x)))
    args = [torch.from_numpy(a) for a in (x, wgt, sgn, tau)]
    got = K.i8_conv_fused_ref(*args, encoding=encoding, pool=pool).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        K.i8_conv_fused(*args, encoding=encoding, pool=pool,
                        wk=K.k_major(args[1])).numpy(), want)
    assert len(np.unique(got)) > 1


# ------------------------------------------------------------ relu layers


def _relu_layer_cases():
    """(name, JAX layer, port layer, input) for I8WDense, I8WConv, I8WHead
    on int8 grid weights and on float32 weights (alpha = 1)."""
    rng = np.random.default_rng(50)
    cases = []
    bn = dict(bn_scale=(16,), bn_bias=(16,), bn_mean=(16,), bn_var=(16,))
    x = rng.standard_normal((3, 6, 6, 8)).astype(np.float32)
    xd = rng.standard_normal((5, 40)).astype(np.float32)
    for kind in ("int8", "f32"):
        def weights(shape):
            if kind == "f32":
                return (rng.standard_normal(shape).astype(np.float32),
                        np.array(1.0, np.float32))
            return (rng.integers(-8, 8, shape, dtype=np.int8),
                    np.array(0.03125, np.float32))

        for pool in (False, True):
            w, alpha = weights((3, 3, 8, 16))
            leaves = dict(_np_leaves(rng, bias=(16,), **bn), w=w, alpha=alpha)
            j, t = _pair(JE.I8WConv, TE.I8WConv, leaves, pool=pool)
            cases.append((f"I8WConv-{kind}-pool{pool}", j, t, x))
        w, alpha = weights((40, 16))
        leaves = dict(_np_leaves(rng, bias=(16,), **bn), w=w, alpha=alpha)
        cases.append((f"I8WDense-{kind}", *_pair(JE.I8WDense, TE.I8WDense, leaves),
                      xd))
        w, alpha = weights((40, 10))
        leaves = dict(_np_leaves(rng, bias=(10,), bn_scale=(10,), bn_bias=(10,),
                                 bn_mean=(10,), bn_var=(10,)), w=w, alpha=alpha)
        cases.append((f"I8WHead-{kind}", *_pair(JE.I8WHead, TE.I8WHead, leaves), xd))
    return cases


RELU_LAYER_CASES = _relu_layer_cases()


@pytest.mark.parametrize("name,jl,tl,x", RELU_LAYER_CASES,
                         ids=[c[0] for c in RELU_LAYER_CASES])
def test_relu_layers_match_jax_class(name, jl, tl, x):
    """The dequantized weights equal JAX's bit for bit; the outputs agree
    within the float summation order, relu's zeros included."""
    np.testing.assert_array_equal(
        tl.weights().numpy(),
        np.asarray(jnp.asarray(jl.w).astype(jnp.float32) * jl.alpha))
    want = np.asarray(jax.jit(lambda m, a: m(a))(jl, jnp.asarray(x)))
    with torch.inference_mode():
        got = tl(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)
    if not name.startswith("I8WHead"):
        assert (got == 0).any() and (got > 0).any()


# ------------------------------------------------------------ pack_int8


def _check_pack(cf, seed):
    """Leaves byte for byte; fed JAX's input, every integer layer's codes
    equal JAX's and take two values or more (the first layer's but where
    the BN output is within rounding of a level boundary); the logits of
    the forward match ``i8_forward`` with identical argmax.  Returns the
    port's model."""
    variables = init_variables(cf, seed=seed)
    jm, tm = jax_pm.pack_int8(variables, cf), pack_int8(variables, cf, device="cpu")
    _assert_leaves_equal(jm, tm)
    x = np.random.default_rng(seed + 1).uniform(
        -1, 1, (8, *cf.input_shape)).astype(np.float32)
    if cf.architecture == "mlp":
        x = x.reshape(8, -1)
    if cf.network_type == "full-qnn":
        j8 = np.asarray(jm.first(jnp.asarray(x)))
        with torch.inference_mode():
            t8 = tm.first(torch.from_numpy(x)).numpy()
            assert (t8 != j8).mean() <= 1e-4
            jls = list(jm.hidden) if cf.architecture == "mlp" else [*jm.convs,
                                                                    *jm.denses]
            tls = list(tm.hidden) if cf.architecture == "mlp" else [*tm.convs,
                                                                    *tm.denses]
            for i, (jl, tl) in enumerate(zip(jls, tls)):
                if isinstance(tl, TE.I8Dense):
                    j8 = j8.reshape(j8.shape[0], -1)
                want = np.asarray(jl(jnp.asarray(j8)))
                np.testing.assert_array_equal(tl(torch.tensor(j8)).numpy(), want,
                                              err_msg=f"hidden {i}")
                assert len(np.unique(want)) > 1, f"hidden {i}"
                j8 = want
    want = np.asarray(JE.i8_forward(jm, jnp.asarray(x)))
    got = TE.i8_forward(tm, torch.from_numpy(x)).numpy()
    assert got.shape == (8, cf.classes) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_REL * np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    return tm


@pytest.mark.parametrize("cf", list(QNN_CONFIGS.values()), ids=list(QNN_CONFIGS))
def test_pack_int8_full_qnn_matches_jax(cf):
    tm = _check_pack(cf, 3)
    m = 2 ** (cf.wbits - 1)
    hidden = list(tm.hidden) if cf.architecture == "mlp" else [*tm.convs, *tm.denses]
    for layer in hidden:
        w = layer.w8.numpy()
        assert w.min() >= -m and w.max() <= m - 1
        assert len(np.unique(w)) > 2 ** min(cf.wbits, 4) - 2
    if cf.wbits == 8:  # the grid's bottom, -128, reaches kernel E
        assert any((layer.w8 == -128).any() for layer in hidden)


@pytest.mark.parametrize("cf", list(RELU_CONFIGS.values()), ids=list(RELU_CONFIGS))
def test_pack_int8_relu_types_match_jax(cf):
    """The relu network types' I8W layers: int8 weights of the pattern or
    grid (f32 with alpha 1 at a float boundary)."""
    tm = _check_pack(cf, 5)
    layers = [tm.first, *(tm.hidden if cf.architecture == "mlp" else
                          [*tm.convs, *tm.denses]), tm.head]
    assert {type(l).__name__ for l in layers} <= {"I8WDense", "I8WConv", "I8WHead"}
    for layer in layers:
        float_layer = layer.w.dtype == torch.float32
        assert float_layer == (layer is tm.first and cf.first_layer_float
                               or layer is tm.head and cf.last_layer_float)
        if float_layer:
            assert float(layer.alpha) == 1.0


def test_pack_int8_rejects_grid_weights_above_8_bits():
    for nt in ("full-qnn", "qnn"):
        cf = MLP_CF.replace(network_type=nt, wbits=9, abits=2)
        variables = init_variables(cf, seed=0)
        for pack in (jax_pm.pack_int8, lambda v, c: pack_int8(v, c, device="cpu")):
            with pytest.raises(ValueError, match="wbits <= 8"):
                pack(variables, cf)
