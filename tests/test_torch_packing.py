"""qnx_torch.ops packing and the packed GEMM reference against the JAX
package: byte-identical words, bits and popcounts on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qnx.ops import packing as JP
from qnx.ops.reference import ternary_gemm_ref as jax_ternary_gemm_ref
from qnx.ops.reference import xnor_gemm_ref as jax_xnor_gemm_ref
from qnx_torch.ops import packing as TP
from qnx_torch.ops.reference import ternary_gemm_ref, xnor_gemm_ref

torch.set_num_threads(2)


def _floats(shape, seed):
    """Gaussian floats with exact zeros and -0.0 sprinkled in."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[rng.choice(flat.size, flat.size // 5, replace=False)] = 0.0
    flat[rng.choice(flat.size, flat.size // 5, replace=False)] = -0.0
    return x


def _words(shape, seed):
    """Random int32 words over the full range, bit 31 set in about half,
    plus the extreme patterns."""
    rng = np.random.default_rng(seed)
    w = rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    flat = w.reshape(-1)
    flat[:4] = [0, -1, np.iinfo(np.int32).min, np.iinfo(np.int32).max]
    return w


PACK_CASES = [
    # (shape, axis)
    ((5, 70), -1),      # K not a multiple of 32
    ((70, 5), 0),
    ((3, 4, 64), -1),   # exact multiple
    ((2, 31, 3), 1),
    ((4, 1), -1),       # one element per word
]


@pytest.mark.parametrize("shape,axis", PACK_CASES)
def test_pack_bits_matches_jax(shape, axis):
    x = _floats(shape, seed=sum(shape))
    want = np.asarray(JP.pack_bits(jnp.asarray(x), axis=axis))
    got = TP.pack_bits(torch.from_numpy(x), axis=axis).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TP.pack_bits_np(x, axis=axis),
                                  JP.pack_bits_np(x, axis=axis))


def test_pack_bits_sets_bit31():
    """Element 31 of each word is the sign bit of the int32 word."""
    x = np.full((3, 64), -1.0, np.float32)
    x[:, 31] = 1.0
    x[1, 63] = 1.0
    got = TP.pack_bits(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JP.pack_bits(jnp.asarray(x))))
    assert got[0, 0] == np.iinfo(np.int32).min and got[1, 1] < 0


@pytest.mark.parametrize("shape,k,axis", [((6, 3), 70, -1), ((3, 5), 96, 0),
                                          ((2, 2, 1), 17, -1)])
def test_unpack_bits_matches_jax(shape, k, axis):
    w = _words(shape, seed=k)
    want = np.asarray(JP.unpack_bits(jnp.asarray(w), k, axis=axis))
    got = TP.unpack_bits(torch.from_numpy(w), k, axis=axis).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    # round trip through the torch packer
    np.testing.assert_array_equal(
        TP.pack_bits(torch.from_numpy(got), axis=axis).numpy(),
        JP.pack_bits_np(want, axis=axis))


def test_popcount_matches_jax():
    w = _words((64, 33), seed=3)
    want = np.asarray(JP.popcount(jnp.asarray(w)))
    got = TP.popcount(torch.from_numpy(w)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert list(got.reshape(-1)[:4]) == [0, 32, 1, 31]


def test_packed_len():
    for k in (1, 31, 32, 33, 4608):
        assert TP.packed_len(k) == JP.packed_len(k)


@pytest.mark.parametrize("m,k,n", [(7, 100, 5), (16, 64, 48)])
def test_xnor_gemm_ref_matches_jax_and_dense(m, k, n):
    rng = np.random.default_rng(m * k + n)
    x = np.where(rng.random((m, k)) < 0.5, 1.0, -1.0).astype(np.float32)
    w = np.where(rng.random((k, n)) < 0.5, 1.0, -1.0).astype(np.float32)
    xp, wp = JP.pack_bits_np(x, -1), JP.pack_bits_np(w, 0)
    got = xnor_gemm_ref(torch.from_numpy(xp), torch.from_numpy(wp), k).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_xnor_gemm_ref(jnp.asarray(xp), jnp.asarray(wp), k)))
    np.testing.assert_array_equal(got, (x @ w).astype(np.int32))


def _ternary(shape, seed, scale=0.25):
    """{-scale, 0, +scale} values, about a third zero, with -0.0 among the
    zeros and one all-zero slice along axis 0."""
    rng = np.random.default_rng(seed)
    w = rng.choice(np.array([-scale, 0.0, scale], np.float32), shape)
    w[..., 0] = 0.0
    flat = w.reshape(-1)
    flat[rng.choice(flat.size, flat.size // 10, replace=False)] = -0.0
    return w


@pytest.mark.parametrize("shape,axis", [((70, 5), 0), ((64, 3), 0),
                                        ((5, 100), -1), ((3, 40, 2), 1)])
def test_pack_ternary_matches_jax(shape, axis):
    w = _ternary(shape, seed=sum(shape))
    want = JP.pack_ternary(jnp.asarray(w), axis=axis)
    got = TP.pack_ternary(torch.from_numpy(w), axis=axis)
    got_np = TP.pack_ternary_np(w, axis=axis)
    for g, n, j, jn in zip(got, got_np, want, JP.pack_ternary_np(w, axis=axis)):
        j = np.asarray(j)
        assert g.dtype == torch.int32 and n.dtype == np.int32 == j.dtype
        np.testing.assert_array_equal(g.numpy(), j)
        np.testing.assert_array_equal(n, jn)
        np.testing.assert_array_equal(n, j)
    mask, sign, nnz = got_np
    # sign bits only where the mask is set; pad words all zero in both planes
    assert ((sign & ~mask) == 0).all()
    k = shape[axis]
    if k % 32:
        tail = np.moveaxis(mask, axis, -1)[..., -1]
        assert ((tail.view(np.uint32) >> (k % 32)) == 0).all()
    np.testing.assert_array_equal(nnz, np.sum(w != 0, axis=axis))


@pytest.mark.parametrize("m,k,n", [(7, 100, 5), (16, 64, 48), (3, 33, 1)])
def test_ternary_gemm_ref_matches_jax_and_dense(m, k, n):
    rng = np.random.default_rng(m * k + n)
    x = np.where(rng.random((m, k)) < 0.5, 1.0, -1.0).astype(np.float32)
    w = _ternary((k, n), seed=m + k + n, scale=1.0)
    xp = JP.pack_bits_np(x, -1)
    mask, sign, nnz = JP.pack_ternary_np(w, axis=0)
    got = ternary_gemm_ref(*(torch.from_numpy(a) for a in (xp, mask, sign, nnz)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jax_ternary_gemm_ref(*map(jnp.asarray, (xp, mask, sign, nnz)))))
    np.testing.assert_array_equal(got.numpy(), (x @ w).astype(np.int32))
