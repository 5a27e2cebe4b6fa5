"""The committed full-width goldens (tests/data/torch_port_golden_*.npz)
that ``chip_smoke.py`` holds the card's runs against, for the packed, the
bit-plane and the int8 engine: regenerated here with the JAX package, and matched by the
port's CPU path."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from qnx_torch.convert.pack_model import (pack_int8, pack_mlp, pack_vgg,
                                          pack_vgg_bitplane)
from qnx_torch.models.factory import init_variables
from qnx_torch.serve.engine import normalize_u8

torch.set_num_threads(2)

DATA = Path(__file__).with_name("data")
RTOL, ATOL_REL = 1e-5, 1e-4  # as chip_smoke.py


def _maker():
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_golden", DATA / "make_torch_port_golden.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MAKER = _maker()


def _check_regenerates(name):
    committed = np.load(MAKER.path(name))
    fresh = MAKER.golden(name)
    assert set(committed.files) == set(fresh)
    np.testing.assert_array_equal(committed["images"], fresh["images"])
    assert int(committed["variables_seed"]) == int(fresh["variables_seed"])
    np.testing.assert_allclose(fresh["logits"], committed["logits"],
                               rtol=RTOL, atol=1e-6)


def _check_port_matches(name):
    g = np.load(MAKER.path(name))
    cf = MAKER.config_of(name)
    if name.endswith(MAKER.INT8):
        assert str(g["engine"]) == "int8"
        pack = pack_int8
    elif cf.architecture == "mlp":
        pack = pack_mlp
    else:
        pack = pack_vgg_bitplane if cf.abits > 1 else pack_vgg
    model = pack(init_variables(cf, int(g["variables_seed"])), cf,
                 device="cpu")
    with torch.inference_mode():
        got = model(normalize_u8(torch.from_numpy(g["images"]))).numpy()
    want = g["logits"]
    assert got.shape == (8, cf.classes) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_REL * np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_golden_regenerates_from_the_jax_package():
    _check_regenerates("cifar10_bnn")


def test_port_cpu_path_matches_golden():
    _check_port_matches("cifar10_bnn")


@pytest.mark.parametrize("name", ["mnist_bnn", "mnist_tnn"])
def test_mlp_golden_regenerates_from_the_jax_package(name):
    _check_regenerates(name)


@pytest.mark.parametrize("name", ["mnist_bnn", "mnist_tnn"])
def test_port_cpu_path_matches_mlp_golden(name):
    _check_port_matches(name)


INT8_NAMES = ["cifar10_bnn_int8", "cifar10_tnn_int8", "mnist_bnn_int8"]


@pytest.mark.parametrize("name", INT8_NAMES)
def test_int8_golden_regenerates_from_the_jax_package(name):
    _check_regenerates(name)


@pytest.mark.parametrize("name", INT8_NAMES)
def test_port_cpu_path_matches_int8_golden(name):
    _check_port_matches(name)


# cifar10-tnn through the bit-plane engine (abits 2, and abits 3 with the
# integer head) and the ternary packed VGG (abits 1)
TNN_NAMES = ["cifar10_tnn", "cifar10_tnn_a1", "cifar10_tnn_a3"]


@pytest.mark.parametrize("name", TNN_NAMES)
def test_tnn_golden_regenerates_from_the_jax_package(name):
    _check_regenerates(name)


@pytest.mark.parametrize("name", TNN_NAMES)
def test_port_cpu_path_matches_tnn_golden(name):
    _check_port_matches(name)


# the other activations and the wbits > 1 network types at full width: zo
# and signed tanh codes, full-qnn's 4-bit grid weights and the relu type
# qnn through the int8 engine, and quantized_tanh through the bit-plane
# engine
ACT_NAMES = ["cifar10_bnn_zo_int8", "cifar10_tnn_tanh_int8", "cifar10_qnn_int8",
             "cifar10_qnn_relu_int8", "cifar10_tnn_tanh"]


@pytest.mark.parametrize("name", ACT_NAMES)
def test_activation_golden_regenerates_from_the_jax_package(name):
    _check_regenerates(name)


def _hidden_values(model, x):
    """The sets of values each hidden layer's output takes on images x: the
    int8 codes, the bit-plane engine's unsigned indices, or the relu
    types' float activations' signs."""
    from qnx_torch.ops.packing import unpack_bits

    out = []
    with torch.inference_mode():
        a = model.first(x)
        for layer in [*model.convs, *model.denses]:
            if layer is model.denses[0]:
                a = a.reshape(*a.shape[:-3], -1)
            a = layer(a)
            if a.dtype == torch.int32:  # planes: the level index
                n = layer.mask.shape[1]
                a_lvl = sum(((unpack_bits(a[j], n, dtype=torch.int32) + 1) // 2) << j
                            for j in range(a.shape[0]))
                out.append(set(a_lvl.unique().tolist()))
            else:
                out.append(set(torch.sign(a).unique().tolist())
                           if a.is_floating_point() else set(a.unique().tolist()))
    return out


@pytest.mark.parametrize("name", ACT_NAMES)
def test_port_cpu_path_matches_activation_golden(name):
    """The port's CPU path matches the golden, and no hidden layer's output
    is constant at full width: zo's two codes, tanh's three, the level
    codes' two or more, the relu types' zeros and positives."""
    _check_port_matches(name)
    g = np.load(MAKER.path(name))
    cf = MAKER.config_of(name)
    pack = pack_vgg_bitplane if not name.endswith(MAKER.INT8) else pack_int8
    model = pack(init_variables(cf, int(g["variables_seed"])), cf, device="cpu")
    want = {"cifar10_bnn_zo_int8": {0, 1}, "cifar10_tnn_tanh_int8": {-1, 0, 1},
            "cifar10_tnn_tanh": {0, 1, 2}, "cifar10_qnn_relu_int8": {0.0, 1.0}}
    for i, values in enumerate(_hidden_values(
            model, normalize_u8(torch.from_numpy(g["images"])))):
        if name in want:
            assert values == want[name], f"{name} layer {i}: {values}"
        else:
            assert len(values) >= 2, f"{name} layer {i}: {values}"
