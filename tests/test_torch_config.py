"""The port's own config, BN folds and numpy weight packing
(qnx_torch.utils.config, qnx_torch.transforms.bn_fold: sign, levels, affine;
qnx_torch.kernels.xnor_conv.pack_conv_ternary_np) against the JAX package's
originals, which the port does not import."""
import dataclasses

import numpy as np
import pytest
import torch

from qnx.transforms import bn_fold as jax_bn_fold
from qnx.utils import config as jax_config
from qnx_torch.transforms import bn_fold
from qnx_torch.utils import config

torch.set_num_threads(2)


def test_config_fields_and_defaults_match():
    ours = [(f.name, f.default) for f in dataclasses.fields(config.Config)]
    want = [(f.name, f.default) for f in dataclasses.fields(jax_config.Config)]
    assert ours == want
    assert config.NETWORK_TYPES == jax_config.NETWORK_TYPES


@pytest.mark.parametrize("name", sorted(jax_config.CONFIGS))
def test_config_preset_matches(name):
    ours, want = config.CONFIGS[name], jax_config.CONFIGS[name]
    assert dataclasses.asdict(ours) == dataclasses.asdict(want)
    assert ours.input_shape == want.input_shape
    assert ours.weight_quantizer_name() == want.weight_quantizer_name()
    assert ours.activation_name() == want.activation_name()
    for act in ("binary_sigmoid", "quantized_relu"):
        assert (ours.replace(activation=act).activation_name()
                == want.replace(activation=act).activation_name())


def _bn(rng, c):
    gamma = rng.normal(0.0, 1.0, c)
    gamma[:4] = 0.0  # constant-bit channels
    beta = rng.normal(0.0, 1.0, c)
    beta[:2] = [0.5, -0.5]
    mean = rng.normal(0.0, 20.0, c)
    var = rng.uniform(0.1, 400.0, c)
    return gamma, beta, mean, var


@pytest.mark.parametrize("alpha,with_bias", [
    (1.0, False), (0.0625, True), ("per-channel", True), (1e-9, False)],
    ids=["unit", "H-and-bias", "per-channel", "tiny-alpha-saturates"])
def test_fold_bn_sign_matches(alpha, with_bias):
    rng = np.random.default_rng(0)
    c = 64
    gamma, beta, mean, var = _bn(rng, c)
    if alpha == "per-channel":
        alpha = rng.uniform(0.01, 2.0, c)
    bias = rng.normal(0.0, 1.0, c) if with_bias else None
    got = bn_fold.fold_bn_sign(gamma, beta, mean, var, 1e-4, alpha=alpha,
                               bias=bias)
    want = jax_bn_fold.fold_bn_sign(gamma, beta, mean, var, 1e-4, alpha=alpha,
                                    bias=bias)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    assert (got.sgn == -1).any()
    assert got.tau[0] == bn_fold.INT32_MIN and got.tau[1] == bn_fold.INT32_MAX


def test_fold_bn_sign_rejects_non_positive_alpha():
    one = np.ones(3)
    for alpha in (0.0, -1.0):
        with pytest.raises(ValueError, match="alpha"):
            bn_fold.fold_bn_sign(one, one, one, one, 1e-4, alpha=alpha)
        with pytest.raises(ValueError, match="alpha"):
            jax_bn_fold.fold_bn_sign(one, one, one, one, 1e-4, alpha=alpha)


def _affine_fields(epi):
    return [(f.name, getattr(epi, f.name)) for f in dataclasses.fields(epi)]


@pytest.mark.parametrize("alpha,with_bias", [
    (1.0, False), (0.0625, True), ("per-channel", True), (-0.5, True)],
    ids=["unit", "H-and-bias", "per-channel", "negative-alpha"])
def test_fold_bn_affine_matches(alpha, with_bias):
    rng = np.random.default_rng(1)
    c = 48
    gamma, beta, mean, var = _bn(rng, c)
    if alpha == "per-channel":
        alpha = rng.uniform(0.01, 2.0, c)
    bias = rng.normal(0.0, 1.0, c) if with_bias else None
    got = bn_fold.fold_bn_affine(gamma, beta, mean, var, 1e-4, alpha=alpha,
                                 bias=bias)
    want = jax_bn_fold.fold_bn_affine(gamma, beta, mean, var, 1e-4,
                                      alpha=alpha, bias=bias)
    assert [n for n, _ in _affine_fields(got)] == [n for n, _ in _affine_fields(want)]
    for (name, g), (_, w) in zip(_affine_fields(got), _affine_fields(want)):
        assert g.dtype == w.dtype == np.float32, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    # gamma == 0 channels collapse to the constant beta
    np.testing.assert_array_equal(got.a[:4], 0.0)
    np.testing.assert_array_equal(got.c0[:4], beta[:4].astype(np.float32))


@pytest.mark.parametrize("kwargs", [
    dict(alpha=0.25, bias=np.linspace(-1.0, 1.0, 10)),
    dict(alpha=np.linspace(0.1, 1.0, 7), channels=7),
    dict(bias=np.arange(5.0))], ids=["bias", "channels", "unit-alpha"])
def test_fold_affine_matches(kwargs):
    got = bn_fold.fold_affine(**kwargs)
    want = jax_bn_fold.fold_affine(**kwargs)
    for (name, g), (_, w) in zip(_affine_fields(got), _affine_fields(want)):
        assert g.dtype == w.dtype == np.float32, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("nb,mode,alpha,with_bias", [
    (2, "relu", 1.0, False), (3, "relu", 0.0625, True),
    (4, "relu", "per-channel", True), (3, "tanh", 0.5, True),
    (2, "relu", 1e-9, False)],
    ids=["nb2", "nb3-H-and-bias", "nb4-per-channel", "tanh-nb3",
         "tiny-alpha-saturates"])
def test_fold_bn_levels_matches(nb, mode, alpha, with_bias):
    rng = np.random.default_rng(2)
    c = 64
    gamma, beta, mean, var = _bn(rng, c)
    gamma[4:8] = -np.abs(gamma[4:8])  # gamma < 0: sgn = -1
    beta[2:4] = [1.5, -1.5]  # gamma == 0 channels above and below every y_v
    if alpha == "per-channel":
        alpha = rng.uniform(0.01, 2.0, c)
    bias = rng.normal(0.0, 1.0, c) if with_bias else None
    got = bn_fold.fold_bn_levels(gamma, beta, mean, var, 1e-4, nb,
                                 alpha=alpha, bias=bias, mode=mode)
    want = jax_bn_fold.fold_bn_levels(gamma, beta, mean, var, 1e-4, nb,
                                      alpha=alpha, bias=bias, mode=mode)
    assert got.q == want.q == 2.0 ** (1 - nb)
    for g, w in ((got.sgn, want.sgn), (got.tau, want.tau)):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    n_thresh = 2 ** (nb - 1) - 1 if mode == "relu" else 2**nb - 2
    assert got.tau.shape == (n_thresh, c)
    assert (got.sgn[4:8] == -1).all()
    # gamma == 0: constant levels at the int32 extremes
    assert (got.tau[:, 2] == bn_fold.INT32_MIN).all()
    assert (got.tau[:, 3] == bn_fold.INT32_MAX).all()


def test_fold_bn_levels_rejects_bad_alpha_and_mode():
    one = np.ones(3)
    for fold in (bn_fold.fold_bn_levels, jax_bn_fold.fold_bn_levels):
        with pytest.raises(ValueError, match="alpha"):
            fold(one, one, one, one, 1e-4, 2, alpha=0.0)
        with pytest.raises(ValueError, match="mode"):
            fold(one, one, one, one, 1e-4, 2, mode="sigmoid")


@pytest.mark.parametrize("shape", [(3, 3, 40, 16), (3, 3, 128, 10), (1, 1, 32, 3)])
def test_pack_conv_ternary_np_matches(shape):
    """The port's copy of the numpy-only ternary conv weight packing."""
    from qnx.kernels.xnor_conv import pack_conv_ternary_np as jax_pack
    from qnx_torch.kernels.xnor_conv import pack_conv_ternary_np

    rng = np.random.default_rng(sum(shape))
    w = rng.choice(np.array([-1.0, 0.0, 1.0], np.float32), shape)
    for got, want in zip(pack_conv_ternary_np(w), jax_pack(w)):
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
