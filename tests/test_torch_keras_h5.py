"""The port's Keras HDF5 reader (qnx_torch.convert.keras_h5) against the JAX
package's (qnx.convert.keras_h5) on the same files: the cases of
tests/test_keras_h5.py, the leaves byte for byte in the legacy and the
Keras-3 layouts at full width, and the packed and int8 forwards built from
the file against the JAX engines' logits.  Every file is written here, from
numpy variables made from a seed."""
import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from engine_test_utils import VGG_CF
from qnx.convert import keras_h5 as JK
from qnx.convert.pack_model import pack_int8 as jax_pack_int8
from qnx.convert.pack_model import pack_mlp as jax_pack_mlp
from qnx.convert.pack_model import pack_vgg as jax_pack_vgg
from qnx.nn.inference import mlp_forward as jax_mlp_forward
from qnx.nn.inference import vgg_forward as jax_vgg_forward
from qnx.nn.int8_engine import i8_forward as jax_i8_forward
from qnx_torch.convert import keras_h5 as K
from qnx_torch.convert.pack_model import pack_int8, pack_mlp, pack_vgg
from qnx_torch.models.factory import glorot_scale, init_variables
from qnx_torch.nn.inference import mlp_forward, vgg_forward
from qnx_torch.nn.int8_engine import i8_forward
from qnx_torch.utils.config import Config

torch.set_num_threads(2)

# logits of equal bits or codes: only the f32 summation order of the float
# first layer (and a float head) differs between XLA and torch
RTOL, ATOL_REL = 1e-5, 1e-4

CF = Config(dataset="digits", architecture="mlp", dim=64, num_hidden=2,
            network_type="full-bnn", H=1.0)
VGG_FULL = Config(dataset="CIFAR-10", architecture="vgg",
                  network_type="full-bnn", width=128,
                  first_layer_float=True, last_layer_float=True)
VGG_COMPUTE = [f"conv_{i}" for i in range(6)] + ["dense_0", "dense_1",
                                                 "dense_out"]
VGG_BNS = [f"bn_conv_{i}" for i in range(6)] + ["bn_dense_0", "bn_dense_1",
                                                "bn_out"]


def _mlp_layers(variables, cf):
    """MLP variables in the reference's legacy h5 shape (layer groups with
    ``weight_names``), as tests/test_keras_h5.py writes them."""
    p, s = variables["params"], variables["batch_stats"]
    layers = []
    names = [f"dense_{i}" for i in range(cf.num_hidden)] + ["dense_out"]
    bns = [f"bn_{i}" for i in range(cf.num_hidden)] + ["bn_out"]
    for i, (dn, bn) in enumerate(zip(names, bns)):
        dvars = [(f"{dn}/kernel:0", p[dn]["kernel"])]
        if "bias" in p[dn]:
            dvars.append((f"{dn}/bias:0", p[dn]["bias"]))
        layers.append((f"binary_dense_{i+1}", dvars))
        layers.append((f"batch_normalization_{i+1}", [
            (f"{bn}/gamma:0", p[bn]["scale"]),
            (f"{bn}/beta:0", p[bn]["bias"]),
            (f"{bn}/moving_mean:0", s[bn]["mean"]),
            (f"{bn}/moving_variance:0", s[bn]["var"]),
        ]))
    return layers


def _vgg_ordered_weights(variables):
    """The VGG's weights in model order, one list per h5 'layer'."""
    p, s = variables["params"], variables["batch_stats"]
    out = []
    for cn, bn in zip(VGG_COMPUTE, VGG_BNS):
        ws = [p[cn]["kernel"]] + ([p[cn]["bias"]] if "bias" in p[cn] else [])
        out.append((cn, ws))
        out.append((bn, [p[bn]["scale"], p[bn]["bias"], s[bn]["mean"],
                         s[bn]["var"]]))
    return out


def _vgg_layers(variables):
    return [(f"layer_{i}_{name}",
             [(f"{name}/w_{j}:0", a) for j, a in enumerate(ws)])
            for i, (name, ws) in enumerate(_vgg_ordered_weights(variables))]


def _write(tmp_path, name, layers):
    path = str(tmp_path / name)
    K.write_legacy_h5(path, layers)
    return path


def _assert_trees_byte_equal(got, want):
    """Every leaf of ``want`` in ``got``, same dtype and shape, same bytes."""
    assert set(got) == set(want)
    for coll in want:
        assert set(got[coll]) == set(want[coll]), coll
        for lname in want[coll]:
            assert set(got[coll][lname]) == set(want[coll][lname])
            for vname, w in want[coll][lname].items():
                g, w = np.asarray(got[coll][lname][vname]), np.asarray(w)
                assert (g.dtype, g.shape) == (w.dtype, w.shape), \
                    f"{coll}/{lname}/{vname}"
                assert g.tobytes() == w.tobytes(), f"{coll}/{lname}/{vname}"


def _assert_buffers_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    for name in sa:
        assert sa[name].dtype == sb[name].dtype, name
        assert torch.equal(sa[name], sb[name]), name


def _x(n, shape, seed):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, *shape)).astype(np.float32)


def _assert_logits_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_REL * np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.fixture(scope="module")
def mlp_file(tmp_path_factory):
    variables = init_variables(CF, seed=0)
    path = _write(tmp_path_factory.mktemp("mlp"), "ref.h5",
                  _mlp_layers(variables, CF))
    return variables, path


@pytest.fixture(scope="module")
def vgg_full_file(tmp_path_factory):
    variables = init_variables(VGG_FULL, seed=0)
    path = _write(tmp_path_factory.mktemp("vgg"), "vgg.h5",
                  _vgg_layers(variables))
    return variables, path


# ------------------------------------------------ tests/test_keras_h5.py


class TestLegacyFormat:
    def test_roundtrip_identical_predictions(self, mlp_file):
        variables, path = mlp_file
        direct = pack_mlp(variables, CF, device="cpu")
        via_h5 = K.convert_keras_h5(path, CF, device="cpu")
        _assert_buffers_equal(via_h5, direct)
        x = torch.from_numpy(_x(64, (8, 8, 1), 9))
        np.testing.assert_array_equal(mlp_forward(via_h5, x).numpy(),
                                      mlp_forward(direct, x).numpy())

    def test_read_classifies_layers(self, mlp_file):
        _, path = mlp_file
        layers = K.read_keras_h5(path)
        assert [lv.kind for lv in layers] == ["dense", "bn"] * 3
        want = JK.read_keras_h5(path)
        assert [(lv.kind, lv.name) for lv in layers] == [
            (lv.kind, lv.name) for lv in want]
        for lv, wv in zip(layers, want):
            for a, b in zip(lv.arrays, wv.arrays, strict=True):
                assert a.tobytes() == b.tobytes()

    @pytest.mark.parametrize("h", ["Glorot", 0.5])
    def test_h_resolution(self, tmp_path, h):
        cf = CF.replace(H=h)
        variables = init_variables(cf, seed=1)
        path = _write(tmp_path, "ref.h5", _mlp_layers(variables, cf))
        got = K.variables_from_keras_h5(path, cf)
        want = JK.variables_from_keras_h5(path, cf)
        for name in ("dense_0", "dense_1", "dense_out"):
            k = variables["params"][name]["kernel"]
            expected = (glorot_scale(*k.shape) if h == "Glorot" else h)
            assert got["quant"][name]["H"] == np.float32(expected)
            assert got["quant"][name]["H"].dtype == np.float32
            for leaf in ("H", "lr_mult"):
                assert (np.asarray(got["quant"][name][leaf]).tobytes()
                        == np.asarray(want["quant"][name][leaf]).tobytes())
        assert float(got["quant"]["dense_0"]["H"]) == pytest.approx(
            float(variables["quant"]["dense_0"]["H"]), rel=1e-6)

    def test_wrong_layer_count_raises(self, mlp_file):
        _, path = mlp_file
        with pytest.raises(ValueError, match="dense layers"):
            K.variables_from_keras_h5(path, CF.replace(num_hidden=3))
        with pytest.raises(ValueError, match="compute layers"):
            K.variables_from_keras_h5(path, VGG_FULL)

    def test_missing_bn_raises(self, tmp_path):
        layers = _mlp_layers(init_variables(CF, seed=2), CF)[:-1]
        path = _write(tmp_path, "nobn.h5", layers)
        with pytest.raises(ValueError, match="one BN per compute layer"):
            K.variables_from_keras_h5(path, CF)

    def test_unrecognised_layout_raises(self, tmp_path):
        path = str(tmp_path / "empty.h5")
        with h5py.File(path, "w") as f:
            f.create_group("something")
        with pytest.raises(ValueError, match="unrecognized"):
            K.read_keras_h5(path)

    def test_model_weights_group(self, tmp_path):
        """A legacy full-model save keeps the layers under ``model_weights``."""
        variables = init_variables(CF, seed=3)
        path = str(tmp_path / "full_model.h5")
        with h5py.File(path, "w") as f:
            f.attrs["model_config"] = "{}"
            root = f.create_group("model_weights")
            layers = _mlp_layers(variables, CF)
            root.attrs["layer_names"] = np.array(
                [n.encode() for n, _ in layers] + [b"flatten"], dtype="S64")
            root.create_group("flatten").attrs["weight_names"] = np.array(
                [], dtype="S96")
            for lname, weights in layers:
                g = root.create_group(lname)
                g.attrs["weight_names"] = np.array(
                    [wn.encode() for wn, _ in weights], dtype="S96")
                for wname, arr in weights:
                    g.create_dataset(wname, data=arr)
        got = K.variables_from_keras_h5(path, CF)
        _assert_trees_byte_equal(got, JK.variables_from_keras_h5(path, CF))
        _assert_trees_byte_equal(
            {c: got[c] for c in ("params", "batch_stats")},
            {c: variables[c] for c in ("params", "batch_stats")})


def test_float64_file_gives_float32_leaves(tmp_path):
    """The JAX copy's ``jnp`` leaves are float32 without x64; the port's
    numpy leaves are too."""
    variables = init_variables(CF, seed=4)
    layers = [(n, [(w, a.astype(np.float64)) for w, a in ws])
              for n, ws in _mlp_layers(variables, CF)]
    path = _write(tmp_path, "f64.h5", layers)
    _assert_trees_byte_equal(K.variables_from_keras_h5(path, CF),
                             JK.variables_from_keras_h5(path, CF))


class TestVggFullWidth:
    """The shipped CIFAR config's shapes (width 128) in both layouts; the
    leaves byte-equal to the JAX reader's on the same file."""

    def test_legacy_roundtrip_full_width(self, vgg_full_file):
        variables, path = vgg_full_file
        got = K.variables_from_keras_h5(path, VGG_FULL)
        _assert_trees_byte_equal(got, JK.variables_from_keras_h5(path, VGG_FULL))
        _assert_trees_byte_equal(
            {c: got[c] for c in ("params", "batch_stats")},
            {c: variables[c] for c in ("params", "batch_stats")})

    def test_keras3_roundtrip_full_width(self, tmp_path):
        keras = pytest.importorskip("keras")
        from keras import layers as kl

        m = keras.Sequential([keras.Input((32, 32, 3))])
        for i, w in enumerate([128, 128, 256, 256, 512, 512]):
            m.add(kl.Conv2D(w, 3, padding="same", use_bias=(i == 0)))
            if i % 2 == 1:
                m.add(kl.MaxPooling2D(2))
            m.add(kl.BatchNormalization())
        m.add(kl.Flatten())
        for units, bias in ((1024, False), (1024, False), (10, True)):
            m.add(kl.Dense(units, use_bias=bias))
            m.add(kl.BatchNormalization())
        variables = init_variables(VGG_FULL, seed=5)
        ordered = iter(_vgg_ordered_weights(variables))
        for lyr in m.layers:
            if lyr.get_weights():
                _, ws = next(ordered)
                lyr.set_weights(ws)
        path = str(tmp_path / "vgg.weights.h5")
        m.save_weights(path)

        got = K.variables_from_keras_h5(path, VGG_FULL)
        _assert_trees_byte_equal(got, JK.variables_from_keras_h5(path, VGG_FULL))
        _assert_trees_byte_equal(
            {c: got[c] for c in ("params", "batch_stats")},
            {c: variables[c] for c in ("params", "batch_stats")})

    def test_int8_forward_parity_from_h5(self, vgg_full_file):
        variables, path = vgg_full_file
        via_h5 = pack_int8(K.variables_from_keras_h5(path, VGG_FULL),
                           VGG_FULL, device="cpu")
        _assert_buffers_equal(via_h5, pack_int8(variables, VGG_FULL,
                                                device="cpu"))
        x = _x(4, (32, 32, 3), 3)
        want = jax_i8_forward(
            jax_pack_int8(JK.variables_from_keras_h5(path, VGG_FULL), VGG_FULL),
            jnp.asarray(x))
        _assert_logits_close(i8_forward(via_h5, torch.from_numpy(x)).numpy(),
                             want)

    def test_chaining_detects_misordered_file(self, tmp_path):
        path = str(tmp_path / "bad.weights.h5")
        with h5py.File(path, "w") as f:
            g = f.create_group("layers")
            for name, shape in (("dense", (64, 32)), ("dense_1", (16, 10))):
                v = g.create_group(name).create_group("vars")
                v.create_dataset("0", data=np.zeros(shape, np.float32))
            for name, n in (("batch_normalization", 32),
                            ("batch_normalization_1", 10)):
                v = g.create_group(name).create_group("vars")
                for j in range(4):
                    v.create_dataset(str(j), data=np.ones(n, np.float32))
        with pytest.raises(ValueError, match="chaining"):
            K.read_keras_h5(path)
        with pytest.raises(ValueError, match="chaining"):
            JK.read_keras_h5(path)

    def test_chaining_detects_mis_sized_bn(self, tmp_path):
        path = str(tmp_path / "badbn.weights.h5")
        with h5py.File(path, "w") as f:
            g = f.create_group("layers")
            for name, shape in (("dense", (64, 32)), ("dense_1", (32, 10))):
                v = g.create_group(name).create_group("vars")
                v.create_dataset("0", data=np.zeros(shape, np.float32))
            for name, n in (("batch_normalization", 16),
                            ("batch_normalization_1", 10)):
                v = g.create_group(name).create_group("vars")
                for j in range(4):
                    v.create_dataset(str(j), data=np.ones(n, np.float32))
        with pytest.raises(ValueError, match="interleaving"):
            K.read_keras_h5(path)


def test_keras3_mlp_weights_h5(tmp_path):
    """tests/test_keras_h5.py's Keras-3 MLP: the leaves against the keras
    model's and the JAX reader's, and the packed forward against JAX's."""
    keras = pytest.importorskip("keras")
    from keras import layers as kl

    rng = np.random.default_rng(0)
    m = keras.Sequential([keras.Input((64,))])
    for _ in range(CF.num_hidden):
        m.add(kl.Dense(CF.dim, use_bias=False))
        m.add(kl.BatchNormalization(momentum=0.9, epsilon=1e-4))
    m.add(kl.Dense(10, use_bias=False))
    m.add(kl.BatchNormalization(momentum=0.9, epsilon=1e-4))
    for lyr in m.layers:
        ws = lyr.get_weights()
        if len(ws) == 4:  # BN: gamma, beta, moving_mean, moving_var
            lyr.set_weights([
                (1 + 0.2 * rng.standard_normal(ws[0].shape)).astype(np.float32),
                (0.2 * rng.standard_normal(ws[1].shape)).astype(np.float32),
                (0.2 * rng.standard_normal(ws[2].shape)).astype(np.float32),
                rng.uniform(0.5, 1.5, ws[3].shape).astype(np.float32)])
        else:
            lyr.set_weights([(0.5 * rng.standard_normal(w.shape)).astype(
                np.float32) for w in ws])
    path = str(tmp_path / "k3.weights.h5")
    m.save_weights(path)

    got = K.variables_from_keras_h5(path, CF)
    _assert_trees_byte_equal(got, JK.variables_from_keras_h5(path, CF))
    np.testing.assert_array_equal(got["params"]["dense_0"]["kernel"],
                                  m.layers[0].get_weights()[0])
    bn0 = m.layers[1].get_weights()
    np.testing.assert_array_equal(got["params"]["bn_0"]["scale"], bn0[0])
    np.testing.assert_array_equal(got["batch_stats"]["bn_0"]["var"], bn0[3])
    x = _x(8, (8, 8, 1), 2)
    out = mlp_forward(K.convert_keras_h5(path, CF, device="cpu"),
                      torch.from_numpy(x)).numpy()
    assert out.shape == (8, 10) and np.isfinite(out).all()
    _assert_logits_close(out, jax_mlp_forward(JK.convert_keras_h5(path, CF),
                                              jnp.asarray(x)))


# ------------------------------------------- forwards from H5 against JAX


@pytest.mark.parametrize("cf", [CF, CF.replace(network_type="full-tnn",
                                               wbits=2, H="Glorot")],
                         ids=["mlp-bnn", "mlp-tnn"])
@pytest.mark.parametrize("engine", ["packed", "int8"])
def test_mlp_forwards_from_h5_match_jax(tmp_path, cf, engine):
    variables = init_variables(cf, seed=7)
    path = _write(tmp_path, "mlp.h5", _mlp_layers(variables, cf))
    jv = JK.variables_from_keras_h5(path, cf)
    tv = K.variables_from_keras_h5(path, cf)
    x = _x(16, (8, 8, 1), 8)
    if engine == "packed":
        got = mlp_forward(pack_mlp(tv, cf, device="cpu"), torch.from_numpy(x))
        want = jax_mlp_forward(jax_pack_mlp(jv, cf), jnp.asarray(x))
    else:
        got = i8_forward(pack_int8(tv, cf, device="cpu"), torch.from_numpy(x))
        want = jax_i8_forward(jax_pack_int8(jv, cf), jnp.asarray(x))
    _assert_logits_close(got.numpy(), want)


@pytest.mark.parametrize("engine", ["packed", "int8"])
def test_vgg_forwards_from_h5_match_jax(tmp_path, engine):
    cf = VGG_CF
    variables = init_variables(cf, seed=8)
    path = _write(tmp_path, "vgg.h5", _vgg_layers(variables))
    jv = JK.variables_from_keras_h5(path, cf)
    tv = K.variables_from_keras_h5(path, cf)
    x = _x(6, (32, 32, 3), 9)
    if engine == "packed":
        tm = K.convert_keras_h5(path, cf, device="cpu")
        _assert_buffers_equal(tm, pack_vgg(tv, cf, device="cpu"))
        got = vgg_forward(tm, torch.from_numpy(x))
        want = jax_vgg_forward(jax_pack_vgg(jv, cf), jnp.asarray(x))
    else:
        got = i8_forward(pack_int8(tv, cf, device="cpu"), torch.from_numpy(x))
        want = jax_i8_forward(jax_pack_int8(jv, cf), jnp.asarray(x))
    _assert_logits_close(got.numpy(), want)


def test_convert_builds_on_the_card_by_default(mlp_file):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default builds there")
    _, path = mlp_file
    with pytest.raises(RuntimeError, match="no CUDA card"):
        K.convert_keras_h5(path, CF)


def test_write_legacy_h5_writes_the_jax_writers_file(tmp_path):
    """A file from the port's writer reads as the JAX writer's does, in
    both readers."""
    layers = _mlp_layers(init_variables(CF, seed=10), CF)
    ours, theirs = str(tmp_path / "ours.h5"), str(tmp_path / "theirs.h5")
    K.write_legacy_h5(ours, layers)
    JK.write_legacy_h5(theirs, layers)
    with h5py.File(ours, "r") as a, h5py.File(theirs, "r") as b:
        assert list(a.attrs["layer_names"]) == list(b.attrs["layer_names"])
        for lname in a:
            assert (list(a[lname].attrs["weight_names"])
                    == list(b[lname].attrs["weight_names"]))
    for reader in (K.variables_from_keras_h5, JK.variables_from_keras_h5):
        _assert_trees_byte_equal(reader(ours, CF), reader(theirs, CF))
