"""The port's copy of the datasets module (qnx_torch.data.datasets) against
the JAX package's (qnx.data.datasets) on the same inputs: the synthetic
twin, the scaling, the targets, every local-file route (written here from a
seed), a corrupt file, and the keras route failing without a network (a
stand-in keras module whose downloads raise, so nothing is fetched)."""
import gzip
import inspect
import pickle
import struct
import sys
import types

import numpy as np
import pytest

from qnx.data import datasets as JD
from qnx_torch.data import datasets as D


def _assert_bundles_equal(got, want):
    for field in ("x_train", "y_train", "x_test", "y_test"):
        g, w = getattr(got, field), getattr(want, field)
        assert (g.dtype, g.shape) == (w.dtype, w.shape), field
        assert g.tobytes() == w.tobytes(), field
    assert got.meta == want.meta


@pytest.fixture(autouse=True)
def offline(monkeypatch, tmp_path):
    """No keras download and no real ``~/.keras/datasets``: a stand-in keras
    whose loaders raise as a download does without a network, and a HOME
    of the test's own.  Returns the list of download attempts."""
    attempts = []

    def no_network():
        attempts.append(1)
        raise OSError("no network")

    loaders = types.SimpleNamespace(load_data=no_network)
    fake = types.ModuleType("keras")
    fake.datasets = types.SimpleNamespace(mnist=loaders, cifar10=loaders)
    monkeypatch.setitem(sys.modules, "keras", fake)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("QNX_DATA_DIR", raising=False)
    return attempts


def _load_both(name):
    return D.load_dataset(name), JD.load_dataset(name)


def test_the_copy_has_the_originals_functions():
    def public(mod):
        return {n for n, f in vars(mod).items()
                if inspect.isfunction(f) and f.__module__ == mod.__name__}

    assert public(D) == public(JD)
    for name in public(D):
        assert (inspect.signature(getattr(D, name))
                == inspect.signature(getattr(JD, name))), name


@pytest.mark.parametrize("shape,seed", [((28, 28, 1), 0), ((32, 32, 3), 0),
                                        ((8, 8, 1), 5)])
def test_synthetic_matches(shape, seed):
    kw = dict(shape=shape, n_train=64, n_test=16, seed=seed)
    _assert_bundles_equal(D.synthetic(**kw), JD.synthetic(**kw))


@pytest.mark.parametrize("name", ["synthetic-mnist", "synthetic-cifar"])
def test_synthetic_presets_match(name):
    _assert_bundles_equal(*_load_both(name))


def test_scale_pm1_matches_on_every_value():
    u8 = np.arange(256, dtype=np.uint8).reshape(16, 16)
    got, want = D._scale_pm1(u8), JD._scale_pm1(u8)
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    assert got.min() == -1.0 and got.max() == 1.0


def test_to_pm1_onehot_matches():
    y = np.random.default_rng(0).integers(0, 10, 50).astype(np.int32)
    got = D.to_pm1_onehot(y)
    assert got.tobytes() == JD.to_pm1_onehot(y).tobytes()
    assert ((got == 1).sum(-1) == 1).all() and set(np.unique(got)) == {-1, 1}


def test_as_tuples():
    ds = D.synthetic((8, 8, 1), n_train=4, n_test=2)
    (xt, yt), (xv, yv) = ds.as_tuples()
    assert xt is ds.x_train and yv is ds.y_test


def test_digits_matches():
    pytest.importorskip("sklearn")
    got, want = _load_both("digits")
    _assert_bundles_equal(got, want)
    assert got.x_train.shape[1:] == (8, 8, 1)


def test_keras_route_fails_without_a_network(offline):
    for name in ("MNIST", "CIFAR-10"):
        assert D._try_keras(name) is None and JD._try_keras(name) is None
    assert len(offline) == 4
    got, want = _load_both("MNIST")
    _assert_bundles_equal(got, want)
    assert got.meta == {"source": "synthetic", "name": "synthetic(28, 28, 1)",
                        "fallback_for": "MNIST"}
    got, want = _load_both("CIFAR-10")
    _assert_bundles_equal(got, want)
    assert got.meta["fallback_for"] == "CIFAR-10"


def test_unknown_dataset_raises():
    with pytest.raises(ValueError, match="unknown dataset"):
        D.load_dataset("ImageNet")


def _write_idx(path, arr, gz=False):
    header = struct.pack(">BBBB", 0, 0, 8, arr.ndim) + b"".join(
        struct.pack(">I", d) for d in arr.shape)
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(header + arr.astype(np.uint8).tobytes())


def _mnist_idx(tmp_path, rng, gz_test=True):
    _write_idx(tmp_path / "train-images-idx3-ubyte",
               rng.integers(0, 256, (20, 28, 28)))
    _write_idx(tmp_path / "train-labels-idx1-ubyte", rng.integers(0, 10, (20,)))
    _write_idx(tmp_path / ("t10k-images-idx3-ubyte" + ".gz" * gz_test),
               rng.integers(0, 256, (8, 28, 28)), gz=gz_test)
    _write_idx(tmp_path / ("t10k-labels-idx1-ubyte" + ".gz" * gz_test),
               rng.integers(0, 10, (8,)), gz=gz_test)


def test_mnist_idx_files(tmp_path, monkeypatch, offline):
    _mnist_idx(tmp_path, np.random.default_rng(0))
    monkeypatch.setenv("QNX_DATA_DIR", str(tmp_path))
    got, want = _load_both("MNIST")
    _assert_bundles_equal(got, want)
    assert got.meta["source"] == "local-idx"
    assert got.x_train.shape == (20, 28, 28, 1) and got.x_test.shape == (8, 28, 28, 1)
    assert not offline


def test_mnist_npz(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    np.savez(tmp_path / "mnist.npz",
             x_train=rng.integers(0, 256, (10, 28, 28), dtype=np.uint8),
             y_train=rng.integers(0, 10, 10, dtype=np.uint8),
             x_test=rng.integers(0, 256, (4, 28, 28), dtype=np.uint8),
             y_test=rng.integers(0, 10, 4, dtype=np.uint8))
    monkeypatch.setenv("QNX_DATA_DIR", str(tmp_path))
    got, want = _load_both("MNIST")
    _assert_bundles_equal(got, want)
    assert got.meta["source"] == "local-npz" and got.y_test.dtype == np.int32


def _cifar_batches(tmp_path, rng, n=6):
    bdir = tmp_path / "cifar-10-batches-py"
    bdir.mkdir()
    for name, size in [(f"data_batch_{i}", n) for i in range(1, 6)] + [
            ("test_batch", 5)]:
        with open(bdir / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (size, 3072),
                                               dtype=np.uint8),
                         b"labels": rng.integers(0, 10, size).tolist()}, f)


def test_cifar10_pickle_batches(tmp_path, monkeypatch):
    _cifar_batches(tmp_path, np.random.default_rng(2))
    monkeypatch.setenv("QNX_DATA_DIR", str(tmp_path))
    got, want = _load_both("CIFAR-10")
    _assert_bundles_equal(got, want)
    assert got.meta["source"] == "local-batches"
    assert got.x_train.shape == (30, 32, 32, 3) and got.y_train.dtype == np.int32


def test_cifar10_pickle_channel_order(tmp_path, monkeypatch):
    bdir = tmp_path / "cifar-10-batches-py"
    bdir.mkdir()
    img = np.zeros((3, 32, 32), np.uint8)
    img[0] = 255  # pure red
    for i, (data, label) in enumerate([(img.reshape(1, 3072), 3)] + [
            (np.zeros((1, 3072), np.uint8), 0)] * 5):
        name = f"data_batch_{i + 1}" if i < 5 else "test_batch"
        with open(bdir / name, "wb") as f:
            pickle.dump({b"data": data, b"labels": [label]}, f)
    monkeypatch.setenv("QNX_DATA_DIR", str(tmp_path))
    got, want = _load_both("CIFAR-10")
    _assert_bundles_equal(got, want)
    np.testing.assert_array_equal(got.x_train[0, :, :, 0], 1.0)
    np.testing.assert_array_equal(got.x_train[0, :, :, 1], -1.0)
    assert got.y_train[0] == 3


def test_cifar10_npz(tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    np.savez(tmp_path / "cifar10.npz",
             x_train=rng.integers(0, 256, (6, 32, 32, 3), dtype=np.uint8),
             y_train=rng.integers(0, 10, (6, 1), dtype=np.uint8),
             x_test=rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8),
             y_test=rng.integers(0, 10, (3, 1), dtype=np.uint8))
    monkeypatch.setenv("QNX_DATA_DIR", str(tmp_path))
    got, want = _load_both("CIFAR-10")
    _assert_bundles_equal(got, want)
    assert got.meta["source"] == "local-npz" and got.y_train.shape == (6,)


def test_files_under_keras_home_are_found(tmp_path, monkeypatch):
    """Without $QNX_DATA_DIR both read ``~/.keras/datasets``."""
    home = tmp_path / "home"
    (home / ".keras" / "datasets").mkdir(parents=True)
    _mnist_idx(home / ".keras" / "datasets", np.random.default_rng(4),
               gz_test=False)
    got, want = _load_both("MNIST")
    _assert_bundles_equal(got, want)
    assert got.meta["source"] == "local-idx"


def test_svhn_mat(tmp_path, monkeypatch):
    scipy_io = pytest.importorskip("scipy.io")
    rng = np.random.default_rng(0)
    for split, n in (("train", 30), ("test", 12)):
        scipy_io.savemat(str(tmp_path / f"{split}_32x32.mat"), {
            "X": rng.integers(0, 256, (32, 32, 3, n)).astype(np.uint8),
            "y": np.concatenate([rng.integers(1, 10, n - 2), [10, 10]])
                 .reshape(-1, 1)})
    monkeypatch.setenv("QNX_DATA_DIR", str(tmp_path))
    got, want = _load_both("SVHN")
    _assert_bundles_equal(got, want)
    assert got.meta["source"] == "svhn-mat" and got.x_train.shape == (30, 32, 32, 3)
    assert set(np.unique(got.y_test)) <= set(range(10))


def test_svhn_falls_back_offline():
    got, want = _load_both("SVHN")
    _assert_bundles_equal(got, want)
    assert got.meta["fallback_for"] == "SVHN"


def test_bad_idx_magic_rejected(tmp_path):
    p = tmp_path / "bogus"
    p.write_bytes(b"\x00\x00\x09\x01" + b"\x00" * 8)
    for mod in (D, JD):
        with pytest.raises(ValueError, match="idx"):
            mod._read_idx(str(p))


def test_corrupt_local_file_warns_and_falls_through(tmp_path, monkeypatch,
                                                    capsys, offline):
    (tmp_path / "mnist.npz").write_bytes(b"PK\x03\x04 truncated")
    monkeypatch.setenv("QNX_DATA_DIR", str(tmp_path))
    got = D.load_dataset("MNIST")
    err = capsys.readouterr().err
    assert "unreadable" in err and got.meta["source"] == "synthetic"
    assert len(offline) == 1  # then the keras route, which fails
    _assert_bundles_equal(got, JD.load_dataset("MNIST"))


def test_corrupt_candidate_still_tries_next_in_same_dir(tmp_path, monkeypatch,
                                                        capsys):
    (tmp_path / "mnist.npz").write_bytes(b"PK\x03\x04 truncated")
    _mnist_idx(tmp_path, np.random.default_rng(5), gz_test=False)
    monkeypatch.setenv("QNX_DATA_DIR", str(tmp_path))
    got, want = _load_both("MNIST")
    assert got.meta["source"] == "local-idx"
    assert capsys.readouterr().err.count("unreadable") == 2  # once each
    _assert_bundles_equal(got, want)
