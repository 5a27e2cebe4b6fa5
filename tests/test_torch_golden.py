"""The committed full-width golden (tests/data/torch_port_golden_cifar10_bnn.npz)
that ``chip_smoke.py`` holds the card's run against: regenerated here with
the JAX package, and matched by the port's CPU path."""
import importlib.util
from pathlib import Path

import numpy as np
import torch

from qnx_torch.convert.pack_model import pack_vgg
from qnx_torch.models.factory import init_variables
from qnx_torch.nn.inference import vgg_forward
from qnx_torch.serve.engine import normalize_u8
from qnx_torch.utils.config import CIFAR10_BNN

torch.set_num_threads(2)

DATA = Path(__file__).with_name("data")
RTOL, ATOL_REL = 1e-5, 1e-4  # as chip_smoke.py


def _maker():
    spec = importlib.util.spec_from_file_location(
        "make_torch_port_golden", DATA / "make_torch_port_golden.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_golden_regenerates_from_the_jax_package():
    maker = _maker()
    committed = np.load(maker.GOLDEN)
    fresh = maker.golden()
    assert set(committed.files) == set(fresh)
    np.testing.assert_array_equal(committed["images"], fresh["images"])
    assert int(committed["variables_seed"]) == int(fresh["variables_seed"])
    np.testing.assert_allclose(fresh["logits"], committed["logits"],
                               rtol=RTOL, atol=1e-6)


def test_port_cpu_path_matches_golden():
    g = np.load(DATA / "torch_port_golden_cifar10_bnn.npz")
    model = pack_vgg(init_variables(CIFAR10_BNN, int(g["variables_seed"])),
                     CIFAR10_BNN)
    x = normalize_u8(torch.from_numpy(g["images"]))
    got = vgg_forward(model, x).numpy()
    want = g["logits"]
    assert got.shape == (8, CIFAR10_BNN.classes) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_REL * np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
