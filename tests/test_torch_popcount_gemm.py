"""qnx_torch's packed popcount GEMMs with int32 output (kernel B,
``xnor_gemm_popcount``; kernel C, ``ternary_gemm``) and the fused ternary
dense (kernel A', ``ternary_gemm_fused``) against the JAX package's Pallas
kernels in interpret mode, on the same numpy operands.  On CPU tensors each
wrapper runs its plain version (unpack, float32 matmul); the CUDA kernels are
held against those plain versions on the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qnx.kernels import xnor_conv_fused as jax_fused
from qnx.kernels.ternary_gemm import ternary_gemm as jax_ternary_gemm
from qnx.kernels.xnor_gemm import xnor_gemm as jax_xnor_gemm
from qnx.kernels.xnor_gemm import xnor_gemm_popcount as jax_xnor_gemm_popcount
from qnx.ops.packing import pack_bits_mxu
from qnx_torch.kernels import xnor_conv_fused as F
from qnx_torch.kernels.ternary_gemm import ternary_gemm, ternary_gemm_ref
from qnx_torch.kernels.xnor_gemm import xnor_gemm, xnor_gemm_popcount
from qnx_torch.ops import reference as R
from qnx_torch.ops.packing import pack_bits_np, pack_ternary_np

torch.set_num_threads(2)

I32 = np.iinfo(np.int32)

# (m, k, n): the MLP heads' N = 10, N = 1 and N = 33 (one lane of a second
# column group), K not a multiple of 32, ragged M
SHAPES = [(8, 64, 32), (7, 100, 10), (5, 100, 1), (3, 100, 33),
          (16, 256, 10), (130, 96, 48)]
IDS = [f"m{m}k{k}n{n}" for m, k, n in SHAPES]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _binary_case(m, k, n):
    rng = np.random.default_rng(m * 1000 + k + n)
    x = np.where(rng.random((m, k)) < 0.5, 1.0, -1.0).astype(np.float32)
    w = np.where(rng.random((k, n)) < 0.5, 1.0, -1.0).astype(np.float32)
    return x, w, pack_bits_np(x, -1), pack_bits_np(w, 0)


def _ternary_case(m, k, n):
    """±1 activations and {-1, 0, +1} weights, about a third zero, with the
    first column all zero and (where N > 2) the last one all nonzero."""
    rng = np.random.default_rng(m * 1000 + k + n + 7)
    x = np.where(rng.random((m, k)) < 0.5, 1.0, -1.0).astype(np.float32)
    w = rng.choice(np.array([-1.0, 0.0, 1.0], np.float32), (k, n))
    w[:, 0] = 0.0
    if n > 2:
        w[:, -1] = np.where(rng.random(k) < 0.5, 1.0, -1.0)
    return x, w, pack_bits_np(x, -1), *pack_ternary_np(w, axis=0)


def _epilogue(rng, n, k):
    """Mixed-direction thresholds around the spread of s, with the int32
    extremes (the folded gamma == 0 constant bits) where N allows."""
    sgn = rng.choice(np.array([1, -1], np.int32), n)
    lim = 2 * int(np.sqrt(k)) + 1
    tau = rng.integers(-lim, lim, n).astype(np.int32)
    tau[0] = I32.min
    if n > 1:
        tau[1], sgn[1] = I32.max, -1
    return sgn, tau


@pytest.mark.parametrize("m,k,n", SHAPES, ids=IDS)
def test_xnor_gemm_popcount_matches_jax(m, k, n):
    x, w, xp, wp = _binary_case(m, k, n)
    want = np.asarray(jax_xnor_gemm_popcount(jnp.asarray(xp), jnp.asarray(wp), k))
    got = xnor_gemm_popcount(*_t(xp, wp), k)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, (x @ w).astype(np.int32))
    # the popcount oracle, an independent formulation of the plain version
    np.testing.assert_array_equal(
        R.xnor_gemm_ref(*_t(xp, wp), k).numpy(), want)


@pytest.mark.parametrize("strategy", ["popcount", "int8"])
def test_xnor_gemm_strategies_match_jax(strategy):
    _, _, xp, wp = _binary_case(9, 100, 12)
    want = np.asarray(jax_xnor_gemm(jnp.asarray(xp), jnp.asarray(wp), 100,
                                    strategy=strategy))
    got = xnor_gemm(*_t(xp, wp), 100, strategy=strategy)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="strategy"):
        xnor_gemm(*_t(xp, wp), 100, strategy="bf16")


@pytest.mark.parametrize("m,k,n", SHAPES, ids=IDS)
def test_ternary_gemm_matches_jax(m, k, n):
    x, w, xp, mask, sign, nnz = _ternary_case(m, k, n)
    want = np.asarray(jax_ternary_gemm(*map(jnp.asarray, (xp, mask, sign, nnz))))
    got = ternary_gemm(*_t(xp, mask, sign, nnz))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, (x @ w).astype(np.int32))
    assert (want[:, 0] == 0).all()  # the all-zero column
    np.testing.assert_array_equal(
        R.ternary_gemm_ref(*_t(xp, mask, sign, nnz)).numpy(), want)


@pytest.mark.parametrize("m,k,n", SHAPES + [(4, 64, 8)], ids=IDS + ["m4k64n8"])
def test_ternary_gemm_fused_words_match_jax(m, k, n):
    """Packed words equal pack_bits_mxu of the JAX kernel's int8 codes, pad
    bits of the last word 0, for any N."""
    _, _, xp, mask, sign, nnz = _ternary_case(m, k, n)
    sgn, tau = _epilogue(np.random.default_rng(n), n, k)
    code = jax_fused.ternary_gemm_fused(*map(jnp.asarray, (xp, mask, sign, nnz,
                                                            sgn, tau)))
    want = np.asarray(pack_bits_mxu(code, axis=-1))
    got = F.ternary_gemm_fused(*_t(xp, mask, sign, nnz, sgn, tau))
    assert got.dtype == torch.int32 and got.shape == (m, (n + 31) // 32)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, 0] & 1 == 1).all()  # tau = INT32_MIN: constant 1 bit
    if n % 32:
        assert (want[:, -1] >> (n % 32) == 0).all()  # zero pad bits


def test_plain_ternary_gemm_takes_nnz_as_given():
    """The kernel's s is nnz - 2 * mismatches whatever nnz holds; the plain
    version must not recount it from the mask."""
    _, _, xp, mask, sign, nnz = _ternary_case(6, 70, 5)
    bumped = nnz + np.arange(5, dtype=np.int32)
    got = ternary_gemm_ref(*_t(xp, mask, sign, bumped)).numpy()
    want = R.ternary_gemm_ref(*_t(xp, mask, sign, bumped)).numpy()
    np.testing.assert_array_equal(got, want)


def test_cpu_tensors_never_count_launches():
    xnor_gemm_popcount.launches = 0
    ternary_gemm.launches = 0
    F.ternary_gemm_fused.launches = 0
    _, _, xp, wp = _binary_case(4, 64, 10)
    xnor_gemm_popcount(*_t(xp, wp), 64)
    _, _, xp, mask, sign, nnz = _ternary_case(4, 64, 10)
    ternary_gemm(*_t(xp, mask, sign, nnz))
    sgn, tau = _epilogue(np.random.default_rng(0), 10, 64)
    F.ternary_gemm_fused(*_t(xp, mask, sign, nnz, sgn, tau))
    assert (xnor_gemm_popcount.launches, ternary_gemm.launches,
            F.ternary_gemm_fused.launches) == (0, 0, 0)


def test_wrappers_reject_what_the_kernels_do_not_take():
    _, _, xp, wp = _binary_case(4, 64, 10)
    with pytest.raises(ValueError, match="Kw"):
        xnor_gemm_popcount(*_t(xp, wp[:1]), 64)
    with pytest.raises(TypeError, match="int32"):
        xnor_gemm_popcount(*_t(xp, wp.astype(np.int64)), 64)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        xnor_gemm_popcount(*(t.to("meta") for t in _t(xp, wp)), 64)
    _, _, xp, mask, sign, nnz = _ternary_case(4, 64, 10)
    with pytest.raises(ValueError, match="mask"):
        ternary_gemm(*_t(xp, mask, sign[:, :5], nnz))
    with pytest.raises(ValueError, match="nnz"):
        ternary_gemm(*_t(xp, mask, sign, nnz[:5]))
    with pytest.raises(ValueError, match="contiguous"):
        strided = torch.from_numpy(np.ascontiguousarray(mask.T)).T
        ternary_gemm(*_t(xp), strided, *_t(sign, nnz))
    sgn, tau = _epilogue(np.random.default_rng(0), 10, 64)
    with pytest.raises(ValueError, match="sgn"):
        F.ternary_gemm_fused(*_t(xp, mask, sign, nnz, sgn[:5], tau))
