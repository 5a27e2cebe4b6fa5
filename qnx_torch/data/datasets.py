"""Data pipeline: ``load_dataset(name)`` → arrays scaled to [-1, 1], NHWC.

The port's copy of :mod:`qnx.data.datasets`, which is numpy-only; a test
holds the two equal.  Both read local files from ``$QNX_DATA_DIR`` (then
``~/.keras/datasets``), so the two packages find the same files.  ``digits``
needs scikit-learn, imported only when that dataset is asked for.

Reference counterpart: ``utils/load_data.py`` (SURVEY.md §1.2 Lx) — MNIST /
CIFAR-10 / SVHN via keras.datasets / scipy.io, images scaled to [-1, 1] and
±1 one-hot targets for the squared-hinge loss.

Offline contingency (SURVEY.md §7.6 — this environment has no network and no
dataset files on disk): keras downloads are attempted first; on failure we
fall back to (a) sklearn's bundled ``digits`` (1797×8×8 real images), or
(b) a deterministic synthetic class-conditional dataset with the exact
MNIST/CIFAR shapes (prototype patterns + noise), which suffices for parity
tests (bit-exactness transfers) and throughput benchmarks (shape-dependent
only).  ``load_dataset`` records which source was used in ``meta``.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DatasetBundle:
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    meta: dict

    def as_tuples(self):
        return (self.x_train, self.y_train), (self.x_test, self.y_test)


def _scale_pm1(x_uint8: np.ndarray) -> np.ndarray:
    return (x_uint8.astype(np.float32) / 255.0) * 2.0 - 1.0


def _try_keras(name: str):
    try:
        import keras  # local import: heavy

        if name == "MNIST":
            (xt, yt), (xv, yv) = keras.datasets.mnist.load_data()
            xt, xv = xt[..., None], xv[..., None]
        elif name == "CIFAR-10":
            (xt, yt), (xv, yv) = keras.datasets.cifar10.load_data()
            yt, yv = yt.ravel(), yv.ravel()
        else:
            return None
        return DatasetBundle(
            _scale_pm1(xt), yt.astype(np.int32),
            _scale_pm1(xv), yv.astype(np.int32),
            {"source": "keras", "name": name},
        )
    except Exception:
        return None


def _digits():
    from sklearn.datasets import load_digits

    d = load_digits()
    x = (d.images.astype(np.float32) / 8.0) - 1.0  # values 0..16 -> [-1, 1]
    x = x[..., None]
    y = d.target.astype(np.int32)
    n = int(0.8 * len(y))
    return DatasetBundle(
        x[:n], y[:n], x[n:], y[n:], {"source": "sklearn-digits", "name": "digits"}
    )


def synthetic(shape=(28, 28, 1), classes: int = 10, n_train: int = 6000,
              n_test: int = 1000, noise: float = 0.35, seed: int = 0
              ) -> DatasetBundle:
    """Deterministic class-conditional images: per-class smooth prototype in
    [-1,1] plus Gaussian noise, clipped.  Learnable by the real models and
    shape-identical to the true datasets."""
    rng = np.random.default_rng(seed)
    h, w, c = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    protos = []
    for cls in range(classes):
        # distinct smooth pattern per class (frequency/phase keyed by class)
        fx, fy = 1 + cls % 4, 1 + (cls // 4)
        phase = cls * 0.7
        p = np.sin(2 * np.pi * fx * xx / w + phase) * np.cos(
            2 * np.pi * fy * yy / h - phase
        )
        protos.append(np.repeat(p[..., None], c, axis=-1))
    protos = np.stack(protos)  # (classes, h, w, c)

    def make(n, salt):
        r = np.random.default_rng(seed + salt)
        y = r.integers(0, classes, n).astype(np.int32)
        x = protos[y] + noise * r.standard_normal((n, h, w, c)).astype(np.float32)
        return np.clip(x, -1, 1).astype(np.float32), y

    xt, yt = make(n_train, 1)
    xv, yv = make(n_test, 2)
    return DatasetBundle(xt, yt, xv, yv,
                         {"source": "synthetic", "name": f"synthetic{shape}"})


def load_dataset(name: str) -> DatasetBundle:
    """MNIST | CIFAR-10 | SVHN | digits | synthetic-mnist | synthetic-cifar.

    MNIST/CIFAR-10 resolution order (VERDICT r3 #5 — a file drop must work
    without any network): local files under ``$QNX_DATA_DIR`` or
    ``~/.keras/datasets`` (MNIST: ``mnist.npz`` or the four idx[.gz] files;
    CIFAR-10: ``cifar-10-batches-py/`` pickles or ``cifar10.npz``), then the
    keras downloader, then the synthetic twin (meta['source'] says which you
    got — bench reports must quote it)."""
    if name == "digits":
        return _digits()
    if name == "synthetic-mnist":
        return synthetic((28, 28, 1))
    if name == "synthetic-cifar":
        return synthetic((32, 32, 3))
    if name == "SVHN":
        real = _try_svhn()
        if real is not None:
            return real
        ds = synthetic((32, 32, 3))
        ds.meta.update({"fallback_for": "SVHN"})
        return ds
    if name in ("MNIST", "CIFAR-10"):
        real = _try_local(name) or _try_keras(name)
        if real is not None:
            return real
        shape = (28, 28, 1) if name == "MNIST" else (32, 32, 3)
        ds = synthetic(shape)
        ds.meta.update({"fallback_for": name})
        return ds
    raise ValueError(f"unknown dataset {name!r}")


# ---------------------------------------------------------------------------
# local-file ingestion (no network, no keras cache machinery)
# ---------------------------------------------------------------------------

def _data_dirs():
    import os

    for base in (os.environ.get("QNX_DATA_DIR"),
                 os.path.expanduser("~/.keras/datasets")):
        if base:
            yield base


def _read_idx(path: str) -> np.ndarray:
    """MNIST idx format (the files on yann.lecun.com, optionally .gz):
    magic 0x0000 08 <ndim>, then ndim big-endian u32 dims, then u8 data."""
    import gzip

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    zero, dtype, ndim = raw[0] << 8 | raw[1], raw[2], raw[3]
    if zero != 0 or dtype != 0x08:
        raise ValueError(f"{path}: not a u8 idx file (magic {raw[:4]!r})")
    dims = [int.from_bytes(raw[4 + 4 * i:8 + 4 * i], "big")
            for i in range(ndim)]
    data = np.frombuffer(raw, np.uint8, offset=4 + 4 * ndim)
    return data.reshape(dims)


def _find(base: str, *names: str) -> str | None:
    import os

    for n in names:
        p = os.path.join(base, n)
        if os.path.exists(p):
            return p
    return None


def _attempt(load, what: str):
    """Run one candidate loader; a corrupt or truncated file logs a LOUD
    warning and returns None so the NEXT candidate (same or later directory,
    then keras/synthetic) is still tried (ADVICE r4: the old whole-scan
    try/except aborted the chain on the first corrupt file) — but never
    silently, since the user clearly intended local data to be used."""
    import sys

    try:
        return load()
    except Exception as e:
        print(f"WARNING: local {what} found but unreadable "
              f"({type(e).__name__}: {e}); trying the next data source",
              file=sys.stderr)
        return None


def _try_local(name: str) -> DatasetBundle | None:
    """Each candidate file set is attempted independently (see _attempt)."""
    import os
    import pickle

    for base in _data_dirs():
        if not os.path.isdir(base):
            continue
        if name == "MNIST":
            npz = _find(base, "mnist.npz")
            if npz:
                def load_npz(npz=npz):
                    with np.load(npz) as z:
                        xt, yt, xv, yv = (z["x_train"], z["y_train"],
                                          z["x_test"], z["y_test"])
                    return DatasetBundle(
                        _scale_pm1(xt[..., None]), yt.astype(np.int32),
                        _scale_pm1(xv[..., None]), yv.astype(np.int32),
                        {"source": "local-npz", "name": "MNIST", "path": npz})

                r = _attempt(load_npz, npz)
                if r:
                    return r
            files = [_find(base, f"{s}-{k}-idx{d}-ubyte",
                           f"{s}-{k}-idx{d}-ubyte.gz")
                     for s, k, d in (("train", "images", 3),
                                     ("train", "labels", 1),
                                     ("t10k", "images", 3),
                                     ("t10k", "labels", 1))]
            if all(files):
                def load_idx(files=files):
                    xt, yt, xv, yv = (_read_idx(f) for f in files)
                    return DatasetBundle(
                        _scale_pm1(xt[..., None]), yt.astype(np.int32),
                        _scale_pm1(xv[..., None]), yv.astype(np.int32),
                        {"source": "local-idx", "name": "MNIST",
                         "path": base})

                r = _attempt(load_idx, f"MNIST idx files in {base}")
                if r:
                    return r
        if name == "CIFAR-10":
            bdir = os.path.join(base, "cifar-10-batches-py")
            if os.path.isdir(bdir):
                def load_batches(bdir=bdir):
                    def rd(fname):
                        with open(os.path.join(bdir, fname), "rb") as f:
                            d = pickle.load(f, encoding="bytes")
                        x = d[b"data"].reshape(-1, 3, 32, 32)
                        return (x.transpose(0, 2, 3, 1),
                                np.asarray(d[b"labels"], np.int32))

                    parts = [rd(f"data_batch_{i}") for i in range(1, 6)]
                    xt = np.concatenate([p[0] for p in parts])
                    yt = np.concatenate([p[1] for p in parts])
                    xv, yv = rd("test_batch")
                    return DatasetBundle(
                        _scale_pm1(xt), yt, _scale_pm1(xv), yv,
                        {"source": "local-batches", "name": "CIFAR-10",
                         "path": bdir})

                r = _attempt(load_batches, bdir)
                if r:
                    return r
            npz = _find(base, "cifar10.npz")
            if npz:
                def load_cnpz(npz=npz):
                    with np.load(npz) as z:
                        xt, yt, xv, yv = (z["x_train"], z["y_train"],
                                          z["x_test"], z["y_test"])
                    return DatasetBundle(
                        _scale_pm1(xt), yt.ravel().astype(np.int32),
                        _scale_pm1(xv), yv.ravel().astype(np.int32),
                        {"source": "local-npz", "name": "CIFAR-10",
                         "path": npz})

                r = _attempt(load_cnpz, npz)
                if r:
                    return r
    return None


def _try_svhn():
    """SVHN cropped-digits .mat files (reference: scipy.io on
    train_32x32.mat / test_32x32.mat). Looks in $QNX_DATA_DIR then
    ~/.keras/datasets; labels 10 -> 0 per SVHN convention."""
    import os

    for base in (os.environ.get("QNX_DATA_DIR"),
                 os.path.expanduser("~/.keras/datasets")):
        if not base:
            continue
        tr = os.path.join(base, "train_32x32.mat")
        te = os.path.join(base, "test_32x32.mat")
        if os.path.exists(tr) and os.path.exists(te):
            from scipy.io import loadmat

            def rd(path):
                m = loadmat(path)
                x = np.transpose(m["X"], (3, 0, 1, 2))  # HWCN -> NHWC
                y = m["y"].ravel().astype(np.int32) % 10
                return _scale_pm1(x), y

            xt, yt = rd(tr)
            xv, yv = rd(te)
            return DatasetBundle(xt, yt, xv, yv,
                                 {"source": "svhn-mat", "name": "SVHN"})
    return None


def to_pm1_onehot(y: np.ndarray, classes: int = 10) -> np.ndarray:
    """±1 one-hot targets for squared hinge (reference convention)."""
    out = -np.ones((y.shape[0], classes), np.float32)
    out[np.arange(y.shape[0]), y] = 1.0
    return out
