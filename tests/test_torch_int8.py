"""The qnx_torch int8 engine (pack_int8, I8VGG, I8MLP, kernel E's plain
version) and the float twin against the JAX package on the same numpy
inputs: quant ops bit for bit, kernel E's codes against the unfused JAX
I8Conv and the Pallas kernel in interpret mode, every layer class, the
converted leaves byte for byte, every layer's codes and the logits of the
forward, the serving engine, and ``float_forward``.  Off the card kernel E
runs its plain version; ``chip_smoke.py`` holds the CUDA kernel against it
on the card."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from engine_test_utils import MLP_CF, VGG_CF
from qnx.bench.float_baseline import float_forward as jax_float_forward
from qnx.convert.pack_model import pack_int8 as jax_pack_int8
from qnx.kernels.i8_conv_fused import i8_conv_fused as jax_i8_conv_fused
from qnx.nn import int8_engine as JE
from qnx.nn.inference import _levels_from_float as jax_levels_from_float
from qnx.ops import quant as jax_quant
from qnx.serve.engine import ServeEngine as JaxServeEngine
from qnx_torch.bench.float_baseline import float_forward, strict_f32
from qnx_torch.convert.pack_model import pack_int8, pack_mlp, pack_vgg
from qnx_torch.kernels import i8_conv_fused as K
from qnx_torch.models.factory import init_variables
from qnx_torch.nn import int8_engine as TE
from qnx_torch.nn.inference import _levels_from_float
from qnx_torch.ops import quant
from qnx_torch.serve.engine import ServeEngine, normalize_u8
from qnx_torch.utils.config import CIFAR10_TNN

torch.set_num_threads(2)

I32 = np.iinfo(np.int32)
# logits: equal codes feed the same float head or affine; only the f32
# summation order of the first layer and of a float head differ
RTOL, ATOL_REL = 1e-5, 1e-4

TNN2 = dict(network_type="full-tnn", wbits=2, abits=2)
CONFIGS = {
    "mlp-bnn": MLP_CF,
    "mlp-tnn-abits1": MLP_CF.replace(network_type="full-tnn", wbits=2),
    "mlp-tnn-abits2": MLP_CF.replace(**TNN2),
    "mlp-tnn-abits3": MLP_CF.replace(**TNN2).replace(abits=3),
    "vgg-bnn": VGG_CF,
    "vgg-tnn-abits2": VGG_CF.replace(**TNN2),
    "vgg-tnn-abits3": VGG_CF.replace(**TNN2).replace(abits=3),
    "vgg-bnn-binary-head": VGG_CF.replace(last_layer_float=False),
}


def _images(n, seed, cf):
    u8 = np.random.default_rng(seed).integers(
        0, 256, (n, *cf.input_shape), dtype=np.uint8)
    return u8, normalize_u8(torch.from_numpy(u8)).numpy()


# ------------------------------------------------------------ quant ops


def _tie_values(nb):
    """Random floats around [-1, 1], the exact ties where hard_sigmoid(x)
    * 2^nb is an integer plus one half, and their float32 neighbours."""
    rng = np.random.default_rng(nb)
    m = 2**nb
    ties = (2.0 * (np.arange(-2, m + 2) + 0.5) / m - 1.0).astype(np.float32)
    near = np.concatenate([np.nextafter(ties, np.float32(-2)),
                           np.nextafter(ties, np.float32(2))])
    return np.concatenate([rng.uniform(-1.5, 1.5, 4000).astype(np.float32),
                           ties, near, np.float32([0.0, -0.0, 1.0, -1.0])])


@pytest.mark.parametrize("nb", [2, 3, 4])
def test_quant_ops_match_jax_bit_for_bit(nb):
    x = _tie_values(nb)
    tx = torch.from_numpy(x)
    m = float(2**nb)
    pairs = [
        (quant.hard_sigmoid(tx), jax_quant.hard_sigmoid(x)),
        (quant.round_through(tx * m), jax_quant.round_through(x * m)),
        (quant.clip_through(tx, 0.0, 0.75), jax_quant.clip_through(x, 0.0, 0.75)),
        (quant.quantized_relu(tx, nb), jax_quant.quantized_relu(x, nb)),
        (quant.quantized_relu(tx, nb),
         jax.jit(jax_quant.quantized_relu, static_argnums=1)(x, nb)),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want).view(np.uint32))
    levels = _levels_from_float(tx, nb).numpy()
    np.testing.assert_array_equal(levels, np.asarray(
        jax.jit(jax_levels_from_float, static_argnums=1)(x, nb)))
    # every level occurs, and a tie rounds to even
    assert set(levels.tolist()) == set(range(2 ** (nb - 1)))
    hs = quant.hard_sigmoid(tx) * m
    tie = hs == torch.floor(hs) + 0.5
    assert tie.any()
    assert (torch.round(hs[tie]) % 2 == 0).all()


# ------------------------------------------------------------ kernel E


def _conv_case(seed, b, h, w, c, n, encoding, n_thresh):
    """Codes of the encoding, ternary weights, mixed threshold directions
    around the spread of s, and int32-extreme thresholds."""
    rng = np.random.default_rng(seed)
    if encoding == "pm1":
        x = np.where(rng.random((b, h, w, c)) < 0.5, 1, -1).astype(np.int8)
    else:
        x = rng.integers(0, n_thresh + 1, (b, h, w, c), dtype=np.int8)
    wgt = rng.integers(-1, 2, (3, 3, c, n), dtype=np.int8)
    sgn = rng.choice(np.array([1, -1], np.int32), n)
    sgn[1] = -1
    lim = 2 * int(np.sqrt(9 * c)) + 1
    tau = np.sort(rng.integers(-lim, lim, (n_thresh, n)), axis=0).astype(np.int32)
    tau[:, 0] = I32.min
    tau[:, 1] = I32.max
    if n > 2:
        tau[:, 2] = I32.min  # sgn may be -1 here: constant, under the pool too
    if encoding == "pm1":
        tau = tau[0]
    return x, wgt, sgn, tau


# (encoding, thresholds, pool, (b, h, w, c, n)); the JAX Pallas kernel takes
# neither a pool of odd H or W nor one levels threshold
E_CASES = [
    ("pm1", 1, False, (3, 5, 7, 16, 48)),
    ("pm1", 1, True, (3, 6, 8, 16, 48)),
    ("pm1", 1, True, (2, 7, 9, 8, 8)),
    ("levels", 3, False, (3, 5, 7, 8, 8)),
    ("levels", 3, True, (2, 8, 8, 32, 64)),
    ("levels", 1, False, (3, 5, 7, 16, 24)),
    ("levels", 1, True, (3, 7, 5, 8, 24)),
]


@pytest.mark.parametrize("encoding,n_thresh,pool,shape", E_CASES,
                         ids=[f"{e}{t}-pool{p}-{s}" for e, t, p, s in E_CASES])
def test_kernel_e_plain_version_matches_jax(encoding, n_thresh, pool, shape):
    x, wgt, sgn, tau = _conv_case(sum(shape) + pool, *shape, encoding, n_thresh)
    want = np.asarray(JE.I8Conv(w8=jnp.asarray(wgt), sgn=jnp.asarray(sgn),
                                tau=jnp.asarray(tau), act=encoding,
                                pool=pool)(jnp.asarray(x)))
    args = [torch.from_numpy(a) for a in (x, wgt, sgn, tau)]
    got = K.i8_conv_fused_ref(*args, encoding=encoding, pool=pool).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        K.i8_conv_fused(*args, encoding=encoding, pool=pool).numpy(), want)
    b, h, w, c, n = shape
    if (encoding == "pm1" or n_thresh > 1) and not (pool and (h % 2 or w % 2)):
        fused = jax_i8_conv_fused(jnp.asarray(x), jnp.asarray(wgt),
                                  jnp.asarray(sgn), jnp.asarray(tau),
                                  levels=n_thresh, pool=pool, interpret=True)
        np.testing.assert_array_equal(got, np.asarray(fused))
    # the constant channels: tau = INT32_MIN is the top code, MAX the bottom
    top, bottom = (1, -1) if encoding == "pm1" else (n_thresh, 0)
    assert (got[..., 0] == top).all() and (got[..., 1] == bottom).all()
    assert len(np.unique(got)) > 1


def test_one_levels_threshold_is_levels_not_sign():
    """The JAX I8Conv(fused=True) passes levels = tau.shape[0] = 1, which
    its kernel takes as the sign encoding: {-1, +1} where the unfused I8Conv
    (the layer pack_int8 builds) gives {0, 1}.  The port follows I8Conv."""
    x, wgt, sgn, tau = _conv_case(0, 2, 8, 8, 32, 16, "levels", 1)
    layer = dict(w8=jnp.asarray(wgt), sgn=jnp.asarray(sgn),
                 tau=jnp.asarray(tau), act="levels")
    unfused = np.asarray(JE.I8Conv(**layer)(jnp.asarray(x)))
    fused = np.asarray(JE.I8Conv(**layer, fused=True)(jnp.asarray(x)))
    assert set(np.unique(unfused)) == {0, 1}
    assert set(np.unique(fused)) == {-1, 1}
    got = K.i8_conv_fused(*(torch.from_numpy(a) for a in (x, wgt, sgn, tau)),
                          encoding="levels")
    np.testing.assert_array_equal(got.numpy(), unfused)


def test_kernel_e_cpu_tensors_never_count_launches_and_bad_operands_raise():
    x, wgt, sgn, tau = (torch.from_numpy(a) for a in
                        _conv_case(1, 2, 4, 4, 8, 8, "pm1", 1))
    K.i8_conv_fused.launches = 0
    K.i8_conv_fused(x, wgt, sgn, tau, encoding="pm1", pool=True)
    assert K.i8_conv_fused.launches == 0
    with pytest.raises(TypeError, match="int8"):
        K.i8_conv_fused(x.int(), wgt, sgn, tau, encoding="pm1")
    with pytest.raises(TypeError, match="int32"):
        K.i8_conv_fused(x, wgt, sgn.long(), tau, encoding="pm1")
    with pytest.raises(ValueError, match="w8"):
        K.i8_conv_fused(x, wgt[:, :, :4], sgn, tau, encoding="pm1")
    with pytest.raises(ValueError, match="tau"):
        K.i8_conv_fused(x, wgt, sgn, tau, encoding="levels")
    with pytest.raises(ValueError, match="tau"):
        K.i8_conv_fused(x, wgt, sgn, tau[None], encoding="pm1")
    # the zo and tanh encodings run, on the CPU without a launch
    for act, t, codes in (("zo", tau, {0, 1}),
                          ("tanh", torch.stack([tau, tau]), {-1, 0, 1})):
        out = K.i8_conv_fused(x, wgt, sgn, t, encoding=act, pool=True)
        assert out.dtype == torch.int8 and out.shape == (2, 2, 2, 8)
        assert set(out.unique().tolist()) <= codes
    assert K.i8_conv_fused.launches == 0


# (encoding, thresholds, pool, (b, h, w, c, n)): C = 8, 40 (not a multiple
# of the 16-channel tap alignment), 96, pool on and off
KMAJOR_CASES = [(enc, nt, pool, (2, 6, 4, c, n)) for enc, nt in (("pm1", 1), ("levels", 3))
                for pool in (False, True) for c, n in ((8, 10), (40, 33), (96, 24))]


@pytest.mark.parametrize("c", [8, 16, 40, 96])
def test_i8conv_holds_its_weights_k_major(c):
    """I8Conv's wk is w8.reshape(9C, N).T with each tap's C channels
    zero-padded to a multiple of 16: (N, 9 Cp), K contiguous per channel."""
    _, wgt, sgn, tau = _conv_case(c, 1, 2, 2, c, 12, "pm1", 1)
    layer = TE.I8Conv(*(torch.from_numpy(a) for a in (wgt, sgn, tau)))
    cp = -(-c // 16) * 16
    assert layer.wk.shape == (12, 9 * cp) and layer.wk.dtype == torch.int8
    assert layer.wk.is_contiguous()
    np.testing.assert_array_equal(layer.w8.numpy(), wgt)  # the JAX layout
    wk = layer.wk.numpy().reshape(12, 9, cp)
    np.testing.assert_array_equal(wk[:, :, :c].reshape(12, 9 * c),
                                  wgt.reshape(9 * c, 12).T)
    assert (wk[:, :, c:] == 0).all()
    if c % 16 == 0:
        np.testing.assert_array_equal(layer.wk.numpy(), wgt.reshape(9 * c, 12).T)
    np.testing.assert_array_equal(K.k_major(torch.from_numpy(wgt)).numpy(),
                                  layer.wk.numpy())


@pytest.mark.parametrize("encoding,n_thresh,pool,shape", KMAJOR_CASES,
                         ids=[f"{e}{t}-pool{p}-{s}" for e, t, p, s in KMAJOR_CASES])
def test_kernel_e_k_major_weights_match_jax(encoding, n_thresh, pool, shape):
    """The K-major weights give the kernel's K order the conv's s (patches
    zero-padded per tap, times wk^T), and the wrapper with and without the
    keyword gives the codes of the JAX unfused I8Conv and of the JAX kernel
    (interpret mode), mixed sgn."""
    b, h, w, c, n = shape
    x, wgt, sgn, tau = _conv_case(sum(shape) + pool + 7, *shape, encoding, n_thresh)
    assert (sgn == 1).any() and (sgn == -1).any()
    args = [torch.from_numpy(a) for a in (x, wgt, sgn, tau)]
    wk = K.k_major(args[1])
    cp = wk.shape[1] // 9
    xpad = np.zeros((b, h + 2, w + 2, cp), np.int64)
    xpad[:, 1:h + 1, 1:w + 1, :c] = x
    patches = np.concatenate([xpad[:, dy:dy + h, dx:dx + w]
                              for dy in range(3) for dx in range(3)], axis=-1)
    s = patches.reshape(-1, 9 * cp) @ wk.numpy().astype(np.int64).T
    np.testing.assert_array_equal(s.reshape(b, h, w, n),
                                  K.conv3x3_s_ref(*args[:2]).numpy())
    want = np.asarray(JE.I8Conv(w8=jnp.asarray(wgt), sgn=jnp.asarray(sgn),
                                tau=jnp.asarray(tau), act=encoding,
                                pool=pool)(jnp.asarray(x)))
    fused = jax_i8_conv_fused(*(jnp.asarray(a) for a in (x, wgt, sgn, tau)),
                              levels=n_thresh, pool=pool, interpret=True)
    np.testing.assert_array_equal(np.asarray(fused), want)
    kw = dict(encoding=encoding, pool=pool)
    np.testing.assert_array_equal(K.i8_conv_fused(*args, **kw, wk=wk).numpy(), want)
    np.testing.assert_array_equal(K.i8_conv_fused(*args, **kw).numpy(), want)
    with pytest.raises(ValueError, match="wk"):
        K.i8_conv_fused(*args, **kw, wk=wk[:, :-16])
    with pytest.raises(TypeError, match="wk"):
        K.i8_conv_fused(*args, **kw, wk=wk.int())


# ------------------------------------------------------------ layers


def _np_leaves(rng, **shapes):
    out = {}
    for name, shape in shapes.items():
        out[name] = rng.standard_normal(shape).astype(np.float32)
    out["bn_var"] = rng.uniform(0.5, 2.0, out["bn_var"].shape).astype(np.float32)
    return out


def _pair(jcls, tcls, leaves, **static):
    j = jcls(**{k: jnp.asarray(v) for k, v in leaves.items()}, **static)
    t = tcls(**{k: torch.from_numpy(v) for k, v in leaves.items()}, **static)
    return j, t


def _layer_cases():
    """(name, JAX layer, port layer, input) for every layer class."""
    rng = np.random.default_rng(20)
    cases = []
    bn = dict(bn_scale=(16,), bn_bias=(16,), bn_mean=(16,), bn_var=(16,))
    x = rng.uniform(-1, 1, (3, 6, 6, 3)).astype(np.float32)
    for act, nb, pool in (("pm1", 1, False), ("levels", 2, True),
                          ("levels", 3, False)):
        leaves = _np_leaves(rng, w=(3, 3, 3, 16), bias=(16,), **bn)
        j, t = _pair(JE.I8FirstConv, TE.I8FirstConv, leaves, act=act, nb=nb,
                     pool=pool, bn_eps=1e-3)
        cases.append((f"I8FirstConv-{act}{nb}", j, t, x))
    x = rng.uniform(-1, 1, (5, 40)).astype(np.float32)
    for act, nb in (("pm1", 1), ("levels", 3)):
        leaves = _np_leaves(rng, w=(40, 16), bias=(16,), **bn)
        j, t = _pair(JE.I8FirstDense, TE.I8FirstDense, leaves, act=act, nb=nb)
        cases.append((f"I8FirstDense-{act}{nb}", j, t, x))
    for act, n_thresh in (("pm1", 1), ("levels", 3)):
        xc, wgt, sgn, tau = _conv_case(21, 2, 6, 6, 16, 24, act, n_thresh)
        leaves = dict(w8=wgt, sgn=sgn, tau=tau)
        j, t = _pair(JE.I8Conv, TE.I8Conv, leaves, act=act, pool=True)
        cases.append((f"I8Conv-{act}", j, t, xc))
        xd = xc.reshape(2, -1)[:, :100]
        wd = rng.integers(-1, 2, (100, 24), dtype=np.int8)
        j, t = _pair(JE.I8Dense, TE.I8Dense, dict(w8=wd, sgn=sgn, tau=tau),
                     act=act)
        cases.append((f"I8Dense-{act}", j, t, xd))
    xd = np.where(rng.random((4, 64)) < 0.5, 1, -1).astype(np.int8)
    leaves = dict(w8=rng.integers(-1, 2, (64, 10), dtype=np.int8),
                  a=rng.uniform(0.01, 0.1, 10).astype(np.float32),
                  c=rng.standard_normal(10).astype(np.float32))
    j, t = _pair(JE.I8DenseLogits, TE.I8DenseLogits, leaves)
    cases.append(("I8DenseLogits", j, t, xd))
    for q in (1.0, 0.5):
        leaves = _np_leaves(rng, w=(64, 10), bias=(10,), bn_scale=(10,),
                            bn_bias=(10,), bn_mean=(10,), bn_var=(10,))
        j, t = _pair(JE.I8FloatHead, TE.I8FloatHead, leaves, q=q)
        cases.append((f"I8FloatHead-q{q}", j, t, np.abs(xd) if q < 1 else xd))
    return cases


LAYER_CASES = _layer_cases()


@pytest.mark.parametrize("name,jl,tl,x", LAYER_CASES,
                         ids=[c[0] for c in LAYER_CASES])
def test_layer_matches_jax_class(name, jl, tl, x):
    want = np.asarray(jax.jit(lambda m, a: m(a))(jl, jnp.asarray(x)))
    with torch.inference_mode():
        got = tl(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == np.int8:
        np.testing.assert_array_equal(got, want)
        assert len(np.unique(got)) > 1
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
    if isinstance(tl, TE.I8DenseLogits):  # the head's int32 s
        np.testing.assert_array_equal(
            tl.scores(torch.from_numpy(x)).numpy(),
            np.asarray(JE._dot_i8(jnp.asarray(x), jl.w8)))


@pytest.mark.parametrize("m,k,n", [(5, 20, 10), (16, 64, 16), (17, 24, 8),
                                   (40, 100, 33)])
def test_int_mm_padding_is_exact(m, k, n):
    """The card's ``torch._int_mm`` path pads M to 17 and K, N to multiples
    of 8 with zeros, keeping a column-major weight column-major; here the
    CPU ``_int_mm`` runs the same padded call."""
    rng = np.random.default_rng(m + k + n)
    x8 = torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8))
    w8 = torch.from_numpy(rng.integers(-128, 128, (k, n), dtype=np.int8))
    want = x8.to(torch.int32) @ w8.to(torch.int32)
    for w in (w8, TE._column_major(w8)):
        got = TE._int_mm_padded(x8, w)
        assert got.dtype == torch.int32 and got.shape == (m, n)
        np.testing.assert_array_equal(got.numpy(), want.numpy())


# ------------------------------------------------------------ pack_int8


def _jax_layers(jm):
    if isinstance(jm, JE.I8MLP):
        return [("first", jm.first),
                *[(f"hidden.{i}", l) for i, l in enumerate(jm.hidden)],
                ("head", jm.head)]
    return [("first", jm.first), *[(f"convs.{i}", l) for i, l in enumerate(jm.convs)],
            *[(f"denses.{j}", l) for j, l in enumerate(jm.denses)],
            ("head", jm.head)]


def _assert_leaves_equal(jm, tm):
    assert type(tm).__name__ == type(jm).__name__
    tlayers = dict(tm.named_modules())
    for name, jlayer in _jax_layers(jm):
        tlayer = tlayers[name]
        assert type(tlayer).__name__ == type(jlayer).__name__, name
        for f in dataclasses.fields(jlayer):
            want = getattr(jlayer, f.name)
            if f.name == "fused":  # the port has one route, kernel E
                assert want is False
                continue
            got = getattr(tlayer, f.name)
            if want is None or isinstance(want, (int, float, str, bool)):
                assert got == want, f"{name}.{f.name}"
            else:
                want = np.asarray(want)
                assert got.numpy().dtype == want.dtype, f"{name}.{f.name}"
                np.testing.assert_array_equal(got.numpy(), want,
                                              err_msg=f"{name}.{f.name}")


@pytest.mark.parametrize("cf", list(CONFIGS.values()), ids=list(CONFIGS))
def test_pack_int8_leaves_equal_jax(cf):
    variables = init_variables(cf, seed=3)
    tm = pack_int8(variables, cf, device="cpu")
    _assert_leaves_equal(jax_pack_int8(variables, cf), tm)
    hidden = list(tm.hidden) if cf.architecture == "mlp" else [*tm.convs, *tm.denses]
    for layer in tm.modules():  # torch._int_mm's fast layout, same values
        if isinstance(layer, (TE.I8Dense, TE.I8DenseLogits)):
            assert layer.w8.stride() == (1, layer.w8.shape[0])
    for layer in hidden:
        assert (layer.sgn == -1).any() and (layer.sgn == 1).any()
        # the constant channels (BN scale 0): beta < 0 saturates at the top
        assert layer.tau.max() == I32.max
        if cf.abits == 1:
            assert layer.tau.min() == I32.min
        assert layer.tau.shape == ((layer.w8.shape[-1],) if cf.abits == 1 else
                                   (2 ** (cf.abits - 1) - 1, layer.w8.shape[-1]))


def test_pack_int8_leaves_equal_jax_full_width_cifar10_tnn():
    """cifar10-tnn (full-tnn, wbits 2, abits 2) packs to level codes with
    one threshold, ternary weights about half zero."""
    variables = init_variables(CIFAR10_TNN, seed=0)
    tm = pack_int8(variables, CIFAR10_TNN, device="cpu")
    _assert_leaves_equal(jax_pack_int8(variables, CIFAR10_TNN), tm)
    assert [type(l).__name__ for l in tm.children()] == [
        "I8FirstConv", "ModuleList", "ModuleList", "I8FloatHead"]
    for conv in tm.convs:
        assert conv.act == "levels" and conv.tau.shape == (1, conv.w8.shape[-1])
        assert 0.3 < float((conv.w8 == 0).float().mean()) < 0.7
    assert tm.head.q == 0.5


def _forward_codes(jm, tm, x):
    """Every layer's codes on both sides, each port layer fed the JAX
    layer's input; returns the last codes (JAX) for the head."""
    j8 = jm.first(jnp.asarray(x.reshape(x.shape[0], -1)
                              if isinstance(jm, JE.I8MLP) else x))
    with torch.inference_mode():
        t8 = tm.first(torch.from_numpy(x.reshape(x.shape[0], -1)
                                       if isinstance(jm, JE.I8MLP) else x))
        np.testing.assert_array_equal(t8.numpy(), np.asarray(j8),
                                      err_msg="first")
        if isinstance(jm, JE.I8MLP):
            chain = [("hidden", jm.hidden, tm.hidden)]
        else:
            chain = [("conv", jm.convs, tm.convs), ("dense", jm.denses, tm.denses)]
        for kind, jls, tls in chain:
            if kind == "dense":
                j8 = j8.reshape(j8.shape[0], -1)
            for i, (jl, tl) in enumerate(zip(jls, tls)):
                want = jl(j8)
                got = tl(torch.from_numpy(np.array(j8)))
                np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                              err_msg=f"{kind}_{i}")
                j8 = want
    return j8


@pytest.mark.parametrize("cf", list(CONFIGS.values()), ids=list(CONFIGS))
def test_int8_forward_codes_and_logits_match_i8_forward(cf):
    variables = init_variables(cf, seed=8)
    jm, tm = jax_pack_int8(variables, cf), pack_int8(variables, cf, device="cpu")
    _, x = _images(8, seed=9, cf=cf)
    j8 = _forward_codes(jm, tm, x)
    with torch.inference_mode():
        t8 = torch.from_numpy(np.array(j8))
        if isinstance(jm.head, JE.I8DenseLogits):
            np.testing.assert_array_equal(
                tm.head.scores(t8).numpy(),
                np.asarray(JE._dot_i8(j8, jm.head.w8)))
        np.testing.assert_allclose(tm.head(t8).numpy(), np.asarray(jm.head(j8)),
                                   rtol=RTOL, atol=1e-6)
    want = np.asarray(JE.i8_forward(jm, jnp.asarray(x)))
    got = TE.i8_forward(tm, torch.from_numpy(x)).numpy()
    assert got.shape == (8, cf.classes) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_REL * np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("cf", [CONFIGS["vgg-tnn-abits2"], CONFIGS["mlp-bnn"]],
                         ids=["vgg-tnn-abits2", "mlp-bnn"])
def test_serve_engine_matches_the_jax_engine(cf):
    """20 uint8 images through both engines, in chunks that split and a
    padded tail."""
    variables = init_variables(cf, seed=10)
    u8, _ = _images(20, seed=11, cf=cf)
    with JaxServeEngine(jax_pack_int8(variables, cf), batch_size=8) as engine:
        want = engine.predict(u8)
    engine = ServeEngine(pack_int8(variables, cf, device="cpu"), batch_size=8,
                         max_wait_ms=50.0)
    futs = [f for chunk in (u8[:3], u8[3:13], u8[13:])
            for f in engine.submit_many(chunk)]
    with engine:
        got = np.stack([f.result(timeout=120) for f in futs])
    assert engine.stats()["images"] == 20 and engine.stats()["batches"] == 3
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_REL * np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


# ------------------------------------------------------------ float twin


@pytest.mark.parametrize("cf", [VGG_CF, MLP_CF], ids=["vgg", "mlp"])
def test_float_forward_matches_jax_highest(cf):
    fcf = cf.replace(network_type="float")
    variables = init_variables(fcf, seed=4)
    _, x = _images(6, seed=5, cf=cf)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda v, a: jax_float_forward(v, fcf, a))(
            variables, jnp.asarray(x)))
    with strict_f32():
        got = float_forward(variables, fcf, torch.from_numpy(x)).numpy()
    assert got.shape == (6, cf.classes)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_REL * np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


# ------------------------------------------------------------ scope, device


@pytest.mark.parametrize("change", [
    dict(network_type="full-qnn", wbits=2, abits=2),
    dict(activation="binary_sigmoid"),
    dict(network_type="full-tnn", wbits=2, abits=2, activation="quantized_tanh"),
    dict(network_type="bnn"), dict(network_type="tnn", wbits=2),
    dict(network_type="qnn", wbits=2),
    dict(network_type="full-qnn", wbits=9, abits=2)],
    ids=["full-qnn", "zo", "tanh", "bnn", "tnn", "qnn", "full-qnn-wbits9"])
def test_pack_int8_unported_variants_raise(change):
    """The variants that raised before the port lowered them (full-qnn, the
    zo and tanh encodings, the relu network types) now give the JAX
    pack_int8's leaves and its i8_forward's logits; wbits 9 raises
    ValueError in both, as int8 cannot hold its grid."""
    cf = MLP_CF.replace(**change)
    variables = init_variables(cf, seed=0)
    if cf.wbits > 8:
        for pack in (jax_pack_int8, lambda v, c: pack_int8(v, c, device="cpu")):
            with pytest.raises(ValueError, match="wbits <= 8"):
                pack(variables, cf)
        return
    jm, tm = jax_pack_int8(variables, cf), pack_int8(variables, cf, device="cpu")
    _assert_leaves_equal(jm, tm)
    _, x = _images(8, seed=1, cf=cf)
    want = np.asarray(JE.i8_forward(jm, jnp.asarray(x)))
    got = TE.i8_forward(tm, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_REL * np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_pack_int8_rejects_float():
    cf = MLP_CF.replace(network_type="float")
    with pytest.raises(ValueError, match="quantized"):
        pack_int8(init_variables(cf, seed=0), cf, device="cpu")


@pytest.mark.parametrize("pack,cf", [(pack_mlp, MLP_CF), (pack_vgg, VGG_CF),
                                     (pack_int8, MLP_CF)],
                         ids=["pack_mlp", "pack_vgg", "pack_int8"])
def test_converters_build_on_the_card_unless_asked_for_the_cpu(pack, cf):
    variables = init_variables(cf, seed=0)
    if torch.cuda.is_available():
        assert all(b.is_cuda for b in pack(variables, cf).buffers())
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pack(variables, cf)
    model = pack(variables, cf, device="cpu")
    assert all(b.device.type == "cpu" for b in model.buffers())
