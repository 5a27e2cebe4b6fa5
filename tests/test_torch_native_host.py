"""The port's native host runtime (qnx_torch.native) against the JAX
package's (qnx.native) and against the device path's normalisation, on both
of its routes: the g++ build and the numpy fallback."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from qnx.native import hostlib as jax_hostlib
from qnx.ops.packing import pack_bits_np as jax_pack_bits_np
from qnx_torch.native import hostlib
from qnx_torch.serve.engine import normalize_u8

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
ROUTES = ("native", "numpy")


@pytest.fixture(params=ROUTES)
def route(request, monkeypatch):
    """Run the test through the C++ library or through the numpy fallback."""
    if request.param == "native":
        assert hostlib.available(), "g++ build of qnx_torch's qnx_host.cpp failed"
    else:
        monkeypatch.setattr(hostlib, "_lib", lambda: None)
    return request.param


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def test_native_builds_into_the_port():
    assert hostlib.available()
    built = list(Path(hostlib._BUILD_DIR).glob("qnx_host_*.so"))
    assert built and all(p.is_relative_to(ROOT / "qnx_torch" / "native")
                         for p in built)


def test_no_native_switch_turns_the_build_off():
    probe = ("from qnx_torch.native import hostlib as h; import numpy as np; "
             "assert not h.available(); "
             "print(*h.u8_to_f32(np.arange(256, dtype=np.uint8))"
             ".view(np.int32))")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, text=True,
                          capture_output=True, timeout=120,
                          env={**os.environ, "QNX_TORCH_NO_NATIVE": "1"})
    assert proc.returncode == 0, proc.stderr
    want = normalize_u8(torch.arange(256, dtype=torch.uint8)).numpy()
    assert [int(v) for v in proc.stdout.split()] == _bits(want).tolist()


def test_u8_to_f32_all_values_equal_normalize_u8(route):
    u8 = np.arange(256, dtype=np.uint8)
    want = normalize_u8(torch.from_numpy(u8)).numpy()
    np.testing.assert_array_equal(_bits(hostlib.u8_to_f32(u8)), _bits(want))


def test_numpy_route_never_rounds_the_float32_product():
    """The double-rounding numpy formula differs on some values; the port's
    numpy route rounds once."""
    u8 = np.arange(256, dtype=np.uint8)
    twice = u8.astype(np.float32) * np.float32(1.0 / 127.5) - np.float32(1.0)
    once = hostlib.u8_to_f32_np(u8)
    assert (_bits(twice) != _bits(once)).any()
    np.testing.assert_array_equal(
        _bits(once), _bits(normalize_u8(torch.from_numpy(u8)).numpy()))


def test_u8_to_f32_equals_the_jax_native_build():
    if not jax_hostlib.available():
        pytest.skip("the JAX package's native build is not available")
    u8 = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(_bits(hostlib.u8_to_f32(u8)),
                                  _bits(jax_hostlib.u8_to_f32(u8)))


def test_u8_to_f32_keeps_shape(route):
    img = np.random.RandomState(0).randint(0, 256, (3, 32, 32, 3), np.uint8)
    out = hostlib.u8_to_f32(img)
    assert out.shape == img.shape and out.dtype == np.float32
    np.testing.assert_array_equal(
        _bits(out), _bits(normalize_u8(torch.from_numpy(img)).numpy()))


@pytest.mark.parametrize("k", [32, 33, 64, 100, 257])
def test_pack_bits_matches_jax(route, k):
    rng = np.random.RandomState(k)
    x = rng.randn(7, k).astype(np.float32)
    x[0, :5] = 0.0  # strict > 0: zeros pack as -1
    got = hostlib.pack_bits_f32(x)
    np.testing.assert_array_equal(got, jax_hostlib.pack_bits_f32(x))
    np.testing.assert_array_equal(got, jax_pack_bits_np(x, axis=-1))


@pytest.mark.parametrize("k", [32, 33, 64, 100, 257])
def test_pack_ternary_matches_jax(route, k):
    x = np.random.RandomState(k).choice([-1.0, 0.0, 1.0], (5, k)).astype(
        np.float32)
    got = hostlib.pack_ternary_f32(x)
    want = jax_hostlib.pack_ternary_f32(x)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("k", [33, 100, 257])
def test_xnor_gemm_host_matches_jax(route, k):
    rng = np.random.RandomState(k)
    x = np.where(rng.randn(9, k) > 0, 1.0, -1.0).astype(np.float32)
    w = np.where(rng.randn(k, 13) > 0, 1.0, -1.0).astype(np.float32)
    xp = jax_pack_bits_np(x, axis=-1)
    wp = jax_pack_bits_np(w, axis=0)
    got = hostlib.xnor_gemm_host(xp, wp, k)
    np.testing.assert_array_equal(got, jax_hostlib.xnor_gemm_host(xp, wp, k))
    np.testing.assert_array_equal(got, (x @ w).astype(np.int32))


def test_xnor_gemm_host_rejects_mismatched_words():
    with pytest.raises(ValueError, match="words"):
        hostlib.xnor_gemm_host(np.zeros((2, 3), np.int32),
                               np.zeros((4, 5), np.int32), 96)
