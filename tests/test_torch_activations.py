"""The other activations of the qnx_torch engines against the JAX package on
the same numpy inputs: binary_sigmoid (the int8 engine's ``zo`` codes) and
quantized_tanh (the int8 engine's signed ``tanh`` codes, and the bit-plane
engine's tanh mode: unsigned indices in nb planes, the (L-1)-scaled border
term ``corr`` in kernel D's conv, the float head's ``lvl0``).  The ops bit
for bit, kernel E's and kernel D's plain versions against the unfused JAX
``I8Conv`` and the JAX ``PlaneConvTernary`` (Pallas in interpret mode),
every layer, the converted leaves byte for byte, every layer's codes or
planes and the logits.  Off the card the wrappers run their plain versions;
``chip_smoke.py`` holds the CUDA kernels against them on the card."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from engine_test_utils import MLP_CF, VGG_CF
from qnx.convert.pack_model import pack_int8 as jax_pack_int8
from qnx.convert.pack_model import pack_vgg_bitplane as jax_pack_vgg_bitplane
from qnx.kernels.xnor_conv import padding_correction as jax_padding_correction
from qnx.nn import inference as JI
from qnx.nn import int8_engine as JE
from qnx.ops import quant as jax_quant
from qnx_torch.convert.pack_model import pack_int8, pack_vgg_bitplane
from qnx_torch.kernels import i8_conv_fused as K
from qnx_torch.kernels import plane_gemm as PG
from qnx_torch.kernels.xnor_conv import pack_conv_ternary_np, padding_correction
from qnx_torch.models.factory import init_variables
from qnx_torch.nn import inference as TI
from qnx_torch.nn import int8_engine as TE
from qnx_torch.ops import quant
from qnx_torch.ops.packing import unpack_bits
from test_torch_int8 import _assert_leaves_equal, _np_leaves, _pair, _tie_values

torch.set_num_threads(2)

I32 = np.iinfo(np.int32)
# logits: equal codes or planes feed the same float head or affine; only
# the f32 summation order of the first layer and of a float head differ
RTOL, ATOL_REL = 1e-5, 1e-4

TNN = dict(network_type="full-tnn", wbits=2)
ZO, TANH = dict(activation="binary_sigmoid"), dict(activation="quantized_tanh")
INT8_CONFIGS = {
    "mlp-zo": MLP_CF.replace(**ZO),
    "mlp-tnn-zo": MLP_CF.replace(**TNN, **ZO),
    "mlp-tanh-a2": MLP_CF.replace(**TNN, abits=2, **TANH),
    "mlp-tanh-a3": MLP_CF.replace(**TNN, abits=3, **TANH),
    "vgg-zo": VGG_CF.replace(**ZO),
    "vgg-tanh-a2": VGG_CF.replace(**TNN, abits=2, **TANH),
    "vgg-tanh-a3": VGG_CF.replace(**TNN, abits=3, **TANH),
    "vgg-bnn-tanh-a2-binary-head": VGG_CF.replace(abits=2, last_layer_float=False,
                                                  **TANH),
}
PLANE_CONFIGS = {
    "tnn-tanh-a2": VGG_CF.replace(**TNN, abits=2, **TANH),
    "tnn-tanh-a3-int-head": VGG_CF.replace(**TNN, abits=3, last_layer_float=False,
                                           **TANH),
    "bnn-tanh-a2": VGG_CF.replace(abits=2, **TANH),
}


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ------------------------------------------------------------ ops


@pytest.mark.parametrize("nb", [2, 3, 4])
def test_sigmoid_and_tanh_ops_match_jax_bit_for_bit(nb):
    """binary_sigmoid, quantized_tanh and the signed tanh code, on random
    values, the rounding ties and their neighbours; every code occurs."""
    x = _tie_values(nb)
    tx = torch.from_numpy(x)
    pairs = [(quant.binary_sigmoid(tx), jax_quant.binary_sigmoid(x)),
             (quant.quantized_tanh(tx, nb), jax_quant.quantized_tanh(x, nb)),
             (quant.quantized_tanh(tx, nb),
              jax.jit(jax_quant.quantized_tanh, static_argnums=1)(x, nb))]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want).view(np.uint32))
    codes = TI._tanh_levels_from_float(tx, nb).numpy()
    np.testing.assert_array_equal(codes, np.asarray(
        jax.jit(JI._tanh_levels_from_float, static_argnums=1)(x, nb)))
    lm1 = 2 ** (nb - 1) - 1
    assert set(codes.tolist()) == set(range(-lm1, lm1 + 1))
    assert set(quant.binary_sigmoid(tx).numpy().tolist()) == {0.0, 1.0}


# ------------------------------------------------------------ kernel E


def _codes(rng, shape, encoding, n_thresh):
    if encoding == "zo":
        return rng.integers(0, 2, shape, dtype=np.int8)
    lm1 = n_thresh // 2
    return rng.integers(-lm1, lm1 + 1, shape, dtype=np.int8)


def _e_case(seed, b, h, w, c, n, encoding, n_thresh):
    """zo or signed tanh codes, ternary weights, mixed threshold directions
    around the spread of s, and int32-extreme thresholds."""
    rng = np.random.default_rng(seed)
    x = _codes(rng, (b, h, w, c), encoding, n_thresh)
    wgt = rng.integers(-1, 2, (3, 3, c, n), dtype=np.int8)
    sgn = rng.choice(np.array([1, -1], np.int32), n)
    sgn[1] = -1
    lim = int(np.sqrt(9 * c)) * max(1, n_thresh // 2) + 1
    tau = np.sort(rng.integers(-lim, lim, (n_thresh, n)), axis=0).astype(np.int32)
    tau[:, 0], tau[:, 1], tau[:, 2] = I32.min, I32.max, I32.min
    return x, wgt, sgn, tau[0] if encoding == "zo" else tau


# (encoding, thresholds, pool, (b, h, w, c, n)): tanh at nb 2, 3 and 8
# (2, 6 and 254 thresholds: codes down to -127)
E_CASES = [
    ("zo", 1, False, (3, 5, 7, 16, 48)),
    ("zo", 1, True, (2, 6, 8, 40, 33)),
    ("tanh", 2, False, (3, 5, 7, 8, 24)),
    ("tanh", 2, True, (2, 8, 8, 32, 64)),
    ("tanh", 6, True, (2, 7, 9, 16, 10)),
    ("tanh", 254, True, (2, 6, 6, 24, 16)),
]


@pytest.mark.parametrize("encoding,n_thresh,pool,shape", E_CASES,
                         ids=[f"{e}{t}-pool{p}-{s}" for e, t, p, s in E_CASES])
def test_kernel_e_zo_and_tanh_match_jax_i8conv(encoding, n_thresh, pool, shape):
    """The plain version and the wrapper (with and without the K-major
    weights) give the unfused JAX I8Conv's codes (the JAX fused kernel has
    no zo or tanh epilogue); the int32-extreme channels hold the top and
    bottom codes."""
    x, wgt, sgn, tau = _e_case(sum(shape) + pool, *shape, encoding, n_thresh)
    want = np.asarray(JE.I8Conv(w8=jnp.asarray(wgt), sgn=jnp.asarray(sgn),
                                tau=jnp.asarray(tau), act=encoding,
                                pool=pool)(jnp.asarray(x)))
    args = _t(x, wgt, sgn, tau)
    got = K.i8_conv_fused_ref(*args, encoding=encoding, pool=pool).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    for wk in (None, K.k_major(args[1])):
        np.testing.assert_array_equal(
            K.i8_conv_fused(*args, encoding=encoding, pool=pool, wk=wk).numpy(),
            want)
    top, bottom = (1, 0) if encoding == "zo" else (n_thresh // 2, -(n_thresh // 2))
    assert (got[..., 0] == top).all() and (got[..., 1] == bottom).all()
    assert (got[..., 2] == top).all()
    assert len(np.unique(got)) >= (3 if encoding == "tanh" else 2)


@pytest.mark.parametrize("encoding,n_thresh", [("pm1", 1), ("zo", 1),
                                               ("levels", 3), ("tanh", 6)])
def test_code_affine_gives_each_encodings_codes(encoding, n_thresh):
    """Kernel E's epilogue takes an encoding as ``mul * k - off`` of the k
    thresholds passed: that form equals the plain epilogue's codes for
    every k."""
    mul, off = K.code_affine(encoding, n_thresh)
    n = 5
    tau = torch.arange(n_thresh, dtype=torch.int32)[:, None].expand(n_thresh, n)
    tau = tau.contiguous()
    s = torch.arange(-1, n_thresh + 1, dtype=torch.int32)[:, None].expand(-1, n)
    sgn = torch.ones(n, dtype=torch.int32)
    k = PG.multi_threshold(s, sgn, tau)
    want = K.act_epilogue(encoding, s, sgn, tau[0] if n_thresh == 1 and
                          encoding in ("pm1", "zo") else tau)
    np.testing.assert_array_equal((mul * k - off).numpy(), want.numpy())
    assert mul > 0  # nondecreasing in sgn * s: the pool of s before the codes


def test_kernel_e_wrapper_checks_the_encodings_thresholds():
    x, wgt, sgn, tau = _t(*_e_case(1, 2, 4, 4, 8, 8, "tanh", 6))
    with pytest.raises(ValueError, match="tau"):
        K.i8_conv_fused(x, wgt, sgn, tau[:5], encoding="tanh")  # odd count
    with pytest.raises(ValueError, match="tau"):
        K.i8_conv_fused(x, wgt, sgn, tau, encoding="zo")
    with pytest.raises(ValueError, match="encoding"):
        K.i8_conv_fused(x, wgt, sgn, tau, encoding="relu")


# ------------------------------------------------------------ int8 layers


def _layer_cases():
    """(name, JAX layer, port layer, input) for each layer class in the zo
    and tanh encodings."""
    rng = np.random.default_rng(30)
    cases = []
    bn = dict(bn_scale=(16,), bn_bias=(16,), bn_mean=(16,), bn_var=(16,))
    x = rng.uniform(-1, 1, (3, 6, 6, 3)).astype(np.float32)
    for act, nb, pool in (("zo", 1, False), ("tanh", 2, True), ("tanh", 3, False)):
        leaves = _np_leaves(rng, w=(3, 3, 3, 16), bias=(16,), **bn)
        j, t = _pair(JE.I8FirstConv, TE.I8FirstConv, leaves, act=act, nb=nb,
                     pool=pool, bn_eps=1e-3)
        cases.append((f"I8FirstConv-{act}{nb}", j, t, x))
    xd = rng.uniform(-1, 1, (5, 40)).astype(np.float32)
    for act, nb in (("zo", 1), ("tanh", 3)):
        leaves = _np_leaves(rng, w=(40, 16), bias=(16,), **bn)
        j, t = _pair(JE.I8FirstDense, TE.I8FirstDense, leaves, act=act, nb=nb)
        cases.append((f"I8FirstDense-{act}{nb}", j, t, xd))
    for act, n_thresh in (("zo", 1), ("tanh", 2), ("tanh", 6)):
        xc, wgt, sgn, tau = _e_case(31 + n_thresh, 2, 6, 6, 16, 24, act, n_thresh)
        j, t = _pair(JE.I8Conv, TE.I8Conv, dict(w8=wgt, sgn=sgn, tau=tau),
                     act=act, pool=True)
        cases.append((f"I8Conv-{act}{n_thresh}", j, t, xc))
        wd = rng.integers(-1, 2, (100, 24), dtype=np.int8)
        j, t = _pair(JE.I8Dense, TE.I8Dense, dict(w8=wd, sgn=sgn, tau=tau), act=act)
        cases.append((f"I8Dense-{act}{n_thresh}", j, t,
                      xc.reshape(2, -1)[:, :100]))
    leaves = _np_leaves(rng, w=(64, 10), bias=(10,), bn_scale=(10,),
                        bn_bias=(10,), bn_mean=(10,), bn_var=(10,))
    j, t = _pair(JE.I8FloatHead, TE.I8FloatHead, leaves, q=0.25)
    cases.append(("I8FloatHead-tanh3", j, t,
                  rng.integers(-3, 4, (4, 64), dtype=np.int8)))
    return cases


LAYER_CASES = _layer_cases()


@pytest.mark.parametrize("name,jl,tl,x", LAYER_CASES,
                         ids=[c[0] for c in LAYER_CASES])
def test_zo_and_tanh_layers_match_jax_class(name, jl, tl, x):
    want = np.asarray(jax.jit(lambda m, a: m(a))(jl, jnp.asarray(x)))
    with torch.inference_mode():
        got = tl(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == np.int8:
        np.testing.assert_array_equal(got, want)
        assert len(np.unique(got)) > 1
        if "tanh" in name:
            assert (got < 0).any() and (got == 0).any() and (got > 0).any()
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


# ------------------------------------------------------------ pack_int8


def _hidden_codes(tm):
    return list(tm.hidden) if isinstance(tm, TE.I8MLP) else [*tm.convs, *tm.denses]


@pytest.mark.parametrize("cf", list(INT8_CONFIGS.values()), ids=list(INT8_CONFIGS))
def test_pack_int8_zo_and_tanh_leaves_equal_jax(cf):
    variables = init_variables(cf, seed=3)
    tm = pack_int8(variables, cf, device="cpu")
    _assert_leaves_equal(jax_pack_int8(variables, cf), tm)
    act = "zo" if cf.activation == "binary_sigmoid" else "tanh"
    for layer in _hidden_codes(tm):
        assert layer.act == act
        n = layer.w8.shape[-1]
        assert layer.tau.shape == ((n,) if act == "zo" else (2**cf.abits - 2, n))
    if isinstance(tm.head, TE.I8FloatHead):
        assert tm.head.q == (1.0 if act == "zo" else 2.0 ** (1 - cf.abits))


@pytest.mark.parametrize("cf", list(INT8_CONFIGS.values()), ids=list(INT8_CONFIGS))
def test_pack_int8_zo_and_tanh_codes_and_logits_match_jax(cf):
    """The first layer's codes equal JAX's but where the BN output is within
    rounding of a level boundary (XLA and torch sum the f32 conv or matmul
    in different orders); fed JAX's input, every hidden layer's codes equal
    JAX's, and every layer's take at least two values (at abits 2, tanh's
    three); the logits of the forward match ``i8_forward``."""
    variables = init_variables(cf, seed=8)
    jm, tm = jax_pack_int8(variables, cf), pack_int8(variables, cf, device="cpu")
    x = np.random.default_rng(9).uniform(-1, 1, (8, *cf.input_shape)).astype(np.float32)
    if cf.architecture == "mlp":
        x = x.reshape(8, -1)
    zo = cf.activation == "binary_sigmoid"

    def check_values(codes, what):
        values = set(np.unique(codes).tolist())
        if zo or cf.abits == 2:
            assert values == ({0, 1} if zo else {-1, 0, 1}), what
        else:
            assert len(values) > 2, what

    j8 = np.asarray(jm.first(jnp.asarray(x)))
    with torch.inference_mode():
        t8 = tm.first(torch.from_numpy(x)).numpy()
        assert t8.shape == j8.shape and t8.dtype == j8.dtype
        assert np.abs(t8.astype(int) - j8).max() <= 1
        assert (t8 != j8).mean() <= 1e-4
        check_values(j8, "first")
        jax_layers = list(jm.hidden) if cf.architecture == "mlp" else [
            *jm.convs, *jm.denses]
        for i, (jl, tl) in enumerate(zip(jax_layers, _hidden_codes(tm))):
            if isinstance(tl, TE.I8Dense):
                j8 = j8.reshape(j8.shape[0], -1)
            want = np.asarray(jl(jnp.asarray(j8)))
            np.testing.assert_array_equal(tl(torch.tensor(j8)).numpy(), want,
                                          err_msg=f"hidden {i}")
            check_values(want, f"hidden {i}")
            j8 = want
    want = np.asarray(JE.i8_forward(jm, jnp.asarray(x)))
    got = TE.i8_forward(tm, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_REL * np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


# ------------------------------------------------------------ kernel D, tanh


def _tanh_planes(rng, nb, shape):
    """nb packed planes of quantized_tanh's unsigned indices u in
    [0, 2^nb - 2]: (nb, *shape[:-1], Cw)."""
    u = rng.integers(0, 2**nb - 1, shape)
    return PG.levels_to_planes(torch.from_numpy(u), nb).numpy()


def _tanh_conv_case(seed, nb, b, h, w, c, n):
    """Planes, ternary weights and their (L-1)-scaled border term, and
    tanh-mode thresholds (2^nb - 2, mixed directions, int32 extremes)."""
    rng = np.random.default_rng(seed)
    planes = _tanh_planes(rng, nb, (b, h, w, c))
    pattern = rng.choice(np.array([-1.0, 0.0, 1.0], np.float32), (3, 3, c, n),
                         p=[0.3, 0.4, 0.3])
    mask, sign, _ = pack_conv_ternary_np(pattern)
    corr = (2 ** (nb - 1) - 1) * padding_correction(pattern, h, w)
    sgn = rng.choice(np.array([1, -1], np.int32), n)
    sgn[1] = -1
    n_thresh = 2**nb - 2
    lim = int(np.sqrt(9 * c)) * 2 ** (nb - 1) + 9 * c * 2 ** (nb - 1)
    tau = np.sort(rng.integers(-lim, lim, (n_thresh, n)), axis=0).astype(np.int32)
    tau[:, 0], tau[:, 1] = I32.min, I32.max
    return planes, mask, mask & sign, sgn, tau, corr


# (nb, (b, h, w, c, n), pool): P = nb planes at nb 2, 3 and 8 (254
# thresholds); N = 33, 48
CORR_CASES = [(2, (2, 8, 8, 16, 32), True), (2, (1, 5, 7, 40, 48), False),
              (3, (2, 4, 6, 32, 33), True), (8, (1, 4, 4, 8, 8), True)]


@pytest.mark.parametrize("nb,shape,pool", CORR_CASES,
                         ids=[f"nb{nb}-{s}-pool{p}" for nb, s, p in CORR_CASES])
def test_plane_conv_with_corr_matches_jax_tanh_layer(nb, shape, pool):
    """Kernel D's plain version and its wrapper with the border term give
    the JAX tanh-mode PlaneConvTernary's planes (plane_conv in interpret
    mode, + corr, thresholds, pool of the levels, nb planes); the corr is
    the JAX converter's."""
    planes, mask, msign, sgn, tau, corr = _tanh_conv_case(sum(shape) + nb, nb,
                                                          *shape)
    assert corr.dtype == np.int32 and corr.any()
    layer = JI.PlaneConvTernary(*_j(mask, msign, sgn, tau), corr=jnp.asarray(corr),
                                nb=nb, pool=pool, mode="tanh")
    want = np.asarray(layer(jnp.asarray(planes)))
    assert want.shape[0] == nb
    args = _t(planes, mask, msign, sgn, tau)
    for fn in (PG.plane_conv_fused, PG.plane_conv_fused_ref):
        got = fn(*args, pool=pool, corr=torch.from_numpy(corr))
        np.testing.assert_array_equal(got.numpy(), want)
    without = PG.plane_conv_fused(*args, pool=pool).numpy()
    assert not np.array_equal(without, want)  # the border term matters


def test_padding_correction_matches_jax():
    rng = np.random.default_rng(4)
    pattern = rng.choice(np.array([-1.0, 0.0, 1.0], np.float32), (3, 3, 24, 10))
    for h, w in ((4, 4), (5, 7), (1, 3)):
        np.testing.assert_array_equal(padding_correction(pattern, h, w),
                                      jax_padding_correction(pattern, h, w))


def test_plane_conv_corr_shape_is_checked():
    planes, mask, msign, sgn, tau, corr = _tanh_conv_case(5, 2, 1, 4, 4, 8, 8)
    with pytest.raises(ValueError, match="corr"):
        PG.plane_conv_fused(*_t(planes, mask, msign, sgn, tau),
                            corr=torch.from_numpy(corr[:3]))
    with pytest.raises(TypeError, match="corr"):
        PG.plane_conv_fused(*_t(planes, mask, msign, sgn, tau),
                            corr=torch.from_numpy(corr).long())


@pytest.mark.parametrize("nb", [2, 3])
def test_float_layers_of_tanh_mode_match_jax(nb):
    """FloatConvPlanes in tanh mode makes nb planes of u = v + (L-1), equal
    but where the BN output is within rounding of a level boundary;
    FloatDenseLogitsFromPlanes recentres them by lvl0."""
    rng = np.random.default_rng(40 + nb)
    bn = dict(bn_scale=(16,), bn_bias=(16,), bn_mean=(16,), bn_var=(16,))
    leaves = _np_leaves(rng, w=(3, 3, 3, 16), bias=(16,), **bn)
    j, t = _pair(JI.FloatConvPlanes, TI.FloatConvPlanes, leaves, nb=nb,
                 mode="tanh")
    x = rng.uniform(-1, 1, (4, 8, 8, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda m, a: m(a))(j, jnp.asarray(x)))
    with torch.inference_mode():
        got = t(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.shape[0] == nb
    differ = np.unpackbits(np.bitwise_xor(got, want).view(np.uint8)).mean()
    assert differ <= 1e-3
    planes = _tanh_planes(rng, nb, (4, 40))
    leaves = _np_leaves(rng, w=(40, 10), bias=(10,), bn_scale=(10,),
                        bn_bias=(10,), bn_mean=(10,), bn_var=(10,))
    lvl0 = 2 ** (nb - 1) - 1
    j, t = _pair(JI.FloatDenseLogitsFromPlanes, TI.FloatDenseLogitsFromPlanes,
                 leaves, k=40, q=2.0 ** (1 - nb), lvl0=lvl0)
    want = np.asarray(jax.jit(lambda m, a: m(a))(j, jnp.asarray(planes)))
    with torch.inference_mode():
        got = t(torch.from_numpy(planes)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


# ------------------------------------------------------------ pack_vgg_bitplane


def _jax_plane_layers(jm):
    return [("first", jm.first), *[(f"convs.{i}", l) for i, l in enumerate(jm.convs)],
            *[(f"denses.{j}", l) for j, l in enumerate(jm.denses)],
            ("head", jm.head)]


@pytest.mark.parametrize("cf", list(PLANE_CONFIGS.values()), ids=list(PLANE_CONFIGS))
def test_pack_vgg_bitplane_tanh_leaves_equal_jax(cf):
    """Every leaf equal, corr and lvl0 included; the plane layers' nb and
    mode are what their input's nb planes carry in the port."""
    variables = init_variables(cf, seed=3)
    jm = jax_pack_vgg_bitplane(variables, cf)
    tm = pack_vgg_bitplane(variables, cf, device="cpu")
    tlayers = dict(tm.named_modules())
    for name, jlayer in _jax_plane_layers(jm):
        tlayer = tlayers[name]
        assert type(tlayer).__name__ == type(jlayer).__name__, name
        for f in dataclasses.fields(jlayer):
            want = getattr(jlayer, f.name)
            if not hasattr(tlayer, f.name):
                assert (f.name, want) in (("nb", cf.abits), ("mode", "tanh")), name
                continue
            got = getattr(tlayer, f.name)
            if want is None or isinstance(want, (int, float, str, bool)):
                assert got == want, f"{name}.{f.name}"
            else:
                want = np.asarray(want)
                assert got.numpy().dtype == want.dtype, f"{name}.{f.name}"
                np.testing.assert_array_equal(got.numpy(), want,
                                              err_msg=f"{name}.{f.name}")
    assert tm.first.mode == "tanh"
    for conv in tm.convs:
        assert conv.corr is not None and conv.corr.any()
        assert conv.tau.shape == (2**cf.abits - 2, conv.sgn.shape[0])


@pytest.mark.parametrize("cf", list(PLANE_CONFIGS.values()), ids=list(PLANE_CONFIGS))
def test_tanh_plane_layers_bit_exact_vs_jax(cf):
    """Fed the same input planes, every plane layer's nb planes (and the
    integer head's int32 s) equal JAX's; at abits 2 all three codes
    (u = 0, 1, 2) occur at every layer."""
    variables = init_variables(cf, seed=5)
    jm = jax_pack_vgg_bitplane(variables, cf)
    tm = pack_vgg_bitplane(variables, cf, device="cpu")
    x = np.random.default_rng(6).uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    planes = jm.first(jnp.asarray(x))
    assert planes.shape[0] == cf.abits

    def levels(p, n):
        """The set of unsigned indices that planes p hold over n channels."""
        bits = [(unpack_bits(torch.tensor(np.asarray(p[j])), n,
                             dtype=torch.int32) + 1) // 2 for j in range(p.shape[0])]
        return set(np.unique(sum(b << j for j, b in enumerate(bits))).tolist())

    with torch.inference_mode():
        for i, (jl, tl) in enumerate(zip(jm.convs, tm.convs)):
            want = jl(planes)
            got = tl(torch.tensor(np.asarray(planes)))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"conv_{i + 1}")
            if cf.abits == 2:
                assert levels(want, tl.mask.shape[1]) == {0, 1, 2}, f"conv_{i + 1}"
            planes = want
        planes = planes.reshape(planes.shape[0], planes.shape[1], -1)
        for j, (jl, tl) in enumerate(zip(jm.denses, tm.denses)):
            want = jl(planes)
            got = tl(torch.tensor(np.asarray(planes)))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"dense_{j}")
            planes = want
        tplanes = torch.tensor(np.asarray(planes))
        np.testing.assert_allclose(tm.head(tplanes).numpy(),
                                   np.asarray(jm.head(planes)), rtol=RTOL,
                                   atol=1e-6)


@pytest.mark.parametrize("cf", list(PLANE_CONFIGS.values()), ids=list(PLANE_CONFIGS))
def test_tanh_plane_vgg_logits_match_jax(cf):
    variables = init_variables(cf, seed=8)
    x = np.random.default_rng(9).uniform(-1, 1, (8, 32, 32, 3)).astype(np.float32)
    jm = jax_pack_vgg_bitplane(variables, cf)
    want = np.asarray(jax.jit(lambda m, v: m(v))(jm, jnp.asarray(x)))
    got = TI.plane_forward(pack_vgg_bitplane(variables, cf, device="cpu"),
                           torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_REL * np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
