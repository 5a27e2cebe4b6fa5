"""The port's full-width parity run (``qnx_torch.experiments.parity_fullwidth``,
the port of ``experiments/parity_fullwidth.py``) on the CPU at a small
width: every engine's argmax equals the fake-quant model's on both weight
sources, its legacy-layout serializer equals the JAX script's, and the
legacy HDF5 files each package writes read back through the other's reader
to the same leaves.  The full width runs on the card (chip_smoke.py)."""
import json
import sys

import numpy as np
import pytest
import torch

from experiments import parity_fullwidth as jax_parity
from qnx.convert.keras_h5 import variables_from_keras_h5 as jax_read_h5
from qnx.convert.keras_h5 import write_legacy_h5 as jax_write_h5
from qnx.utils.config import CIFAR10_BNN as JAX_CIFAR10_BNN
from qnx.utils.config import CIFAR10_TNN as JAX_CIFAR10_TNN
from qnx_torch.convert.keras_h5 import variables_from_keras_h5, write_legacy_h5
from qnx_torch.experiments import parity_fullwidth
from qnx_torch.models.factory import init_variables
from qnx_torch.utils.config import CIFAR10_BNN, CIFAR10_TNN

torch.set_num_threads(2)

SMALL = dict(width=16, dense_units=32)
TYPES = {"full-bnn": (CIFAR10_BNN, JAX_CIFAR10_BNN, "popcount(pack_vgg)"),
         "full-tnn": (CIFAR10_TNN, JAX_CIFAR10_TNN, "bitplane(pack_vgg_bitplane)")}


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, (*prefix, k))
        else:
            yield (*prefix, k), np.asarray(v)


def assert_same_tree(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert list(got) == list(want)
    for path, a in got.items():
        assert a.dtype == want[path].dtype, path
        np.testing.assert_array_equal(a, want[path], err_msg=str(path))


@pytest.mark.parametrize("network_type", sorted(TYPES))
def test_every_engine_matches_on_both_weight_sources(network_type, capsys):
    rc = parity_fullwidth.main(["--batch", "16", "--steps", "2", "--network-type",
                                network_type, "--width", "16", "--dense-units", "32",
                                "--device", "cpu"])
    out = capsys.readouterr()
    lines = [json.loads(l) for l in out.out.splitlines() if l.startswith("{")]
    engine = TYPES[network_type][2]
    assert [(r["engine"], r["weights_source"]) for r in lines] == [
        (e, s) for e in (engine, "int8(pack_int8)") for s in ("native", "legacy-h5")]
    assert all(r["argmax_match_vs_fakequant"] == 1.0 for r in lines)
    assert all(r["network_type"] == network_type and r["width"] == 16
               and r["batch"] == 16 and r["device"].startswith("cpu") for r in lines)
    assert rc == 0 and "# PARITY OK at width=16 batch=16" in out.err


@pytest.mark.parametrize("network_type", sorted(TYPES))
def test_legacy_layers_equal_the_jax_scripts(network_type):
    v = init_variables(TYPES[network_type][0].replace(**SMALL), 0)
    got, want = parity_fullwidth._legacy_layers(v), jax_parity._legacy_layers(v)
    assert [name for name, _ in got] == [name for name, _ in want]
    for (_, ws), (_, wj) in zip(got, want):
        assert [n for n, _ in ws] == [n for n, _ in wj]
        for (_, a), (_, b) in zip(ws, wj):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("network_type", sorted(TYPES))
def test_legacy_h5_reads_back_through_either_reader(tmp_path, network_type, writer):
    """A file one package writes reads back through the other's reader to
    the same leaves as through its own, and to the written variables'
    params and batch statistics."""
    cf, jcf, _ = TYPES[network_type]
    cf, jcf = cf.replace(**SMALL), jcf.replace(**SMALL)
    v = init_variables(cf, 0)
    path = str(tmp_path / "fullwidth.h5")
    if writer == "port":
        write_legacy_h5(path, parity_fullwidth._legacy_layers(v))
    else:
        jax_write_h5(path, jax_parity._legacy_layers(v))
    got = variables_from_keras_h5(path, cf)
    want = {c: {n: {k: np.asarray(a) for k, a in leaves.items()}
                for n, leaves in layers.items()}
            for c, layers in jax_read_h5(path, jcf).items()}
    assert_same_tree(got, want)
    for c in ("params", "batch_stats"):
        assert_same_tree(got[c], v[c])


def test_without_h5py_no_legacy_h5_line(monkeypatch, capsys):
    """The card's machine has no h5py: the round trip is not run, no line
    claims a match for it, and one stderr line says so."""
    monkeypatch.setitem(sys.modules, "h5py", None)  # its import now raises
    rc = parity_fullwidth.main(["--batch", "16", "--steps", "2", "--width", "16",
                                "--dense-units", "32", "--device", "cpu"])
    out = capsys.readouterr()
    lines = [json.loads(l) for l in out.out.splitlines() if l.startswith("{")]
    assert [r["weights_source"] for r in lines] == ["native", "native"]
    assert rc == 0 and out.err.count("h5py is not installed") == 1
