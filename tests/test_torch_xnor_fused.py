"""qnx_torch's fused XNOR dense and conv wrappers, binary and ternary, against
the JAX package:
on CPU tensors they run their plain versions, whose packed output words must
equal ``pack_bits_mxu`` of the JAX kernels' int8 codes (Pallas in interpret
mode), word for word.  The CUDA kernels themselves are checked against the
same plain versions on the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qnx.kernels import xnor_conv as jax_xc
from qnx.kernels import xnor_conv_fused as jax_fused
from qnx.ops.packing import pack_bits_mxu
from qnx_torch.kernels import xnor_conv_fused as F
from qnx_torch.kernels.xnor_conv import (pack_conv_ternary_np,
                                         pack_conv_weights_np,
                                         padding_correction, ternary_conv,
                                         xnor_conv)
from qnx_torch.ops.packing import pack_bits, pack_bits_np

torch.set_num_threads(2)

I32 = np.iinfo(np.int32)


def _pm1(rng, shape):
    return np.where(rng.random(shape) < 0.5, 1.0, -1.0).astype(np.float32)


def _epilogue(rng, n, k):
    """Mixed-direction thresholds around the spread of s, with one channel
    at each int32 extreme (the folded gamma == 0 constant bits)."""
    sgn = rng.choice(np.array([1, -1], np.int32), n)
    lim = 2 * int(np.sqrt(k)) + 1
    tau = rng.integers(-lim, lim, n).astype(np.int32)
    tau[0], tau[1] = I32.min, I32.max
    sgn[1] = -1
    return sgn, tau


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _conv_case(b, h, w, c, n, pool):
    rng = np.random.default_rng(b * 1000 + h * 100 + w * 10 + c + n + pool)
    x = _pm1(rng, (b, h, w, c))
    wgt = _pm1(rng, (3, 3, c, n))
    wp, k = pack_conv_weights_np(wgt)
    sgn, tau = _epilogue(rng, n, k)
    return pack_bits_np(x, -1), wp, k, padding_correction(wgt, h, w), sgn, tau


def _dense_case(m, k, n):
    rng = np.random.default_rng(m * 1000 + k + n)
    x, w = _pm1(rng, (m, k)), _pm1(rng, (k, n))
    sgn, tau = _epilogue(rng, n, k)
    return pack_bits_np(x, -1), pack_bits_np(w, 0), k, sgn, tau


CASES = [
    # conv (b, h, w, c, n, pool)
    ("conv", (2, 8, 8, 32, 64, False)),
    ("conv", (2, 8, 8, 32, 64, True)),
    ("conv", (1, 6, 6, 64, 32, True)),
    ("conv", (3, 5, 7, 32, 32, False)),   # odd spatial
    ("conv", (2, 4, 4, 96, 64, False)),   # Cw = 3 words
    ("conv", (2, 4, 4, 40, 32, True)),    # C not a multiple of 32
    ("conv", (2, 8, 8, 8, 8, True)),      # N = 8: one part-filled word
    ("conv", (1, 5, 7, 16, 48, False)),   # N = 48: a full and a half word
    ("conv", (2, 4, 4, 8, 16, True)),     # VGG_CF's width-8 conv_2 shape
    # dense (m, k, n)
    ("dense", (8, 32, 32)),
    ("dense", (16, 100, 64)),             # K not a multiple of 32
    ("dense", (130, 96, 128)),            # ragged M
    ("dense", (5, 64, 8)),                # N = 8
    ("dense", (9, 100, 48)),              # N = 48, K not a multiple of 32
]


@pytest.mark.parametrize("kind,shape", CASES, ids=[f"{k}{s}" for k, s in CASES])
def test_fused_words_match_jax(kind, shape):
    if kind == "conv":
        xp, wp, k, corr, sgn, tau = _conv_case(*shape)
        pool = shape[-1]
        code = jax_fused.xnor_conv_fused(
            jnp.asarray(xp), jnp.asarray(wp), k, jnp.asarray(corr),
            jnp.asarray(sgn), jnp.asarray(tau), pool=pool)
        got = F.xnor_conv_fused(*_t(xp, wp), k, *_t(corr, sgn, tau), pool=pool)
    else:
        xp, wp, k, sgn, tau = _dense_case(*shape)
        code = jax_fused.xnor_gemm_fused(jnp.asarray(xp), jnp.asarray(wp), k,
                                         jnp.asarray(sgn), jnp.asarray(tau))
        got = F.xnor_gemm_fused(*_t(xp, wp), k, *_t(sgn, tau))
    want = np.asarray(pack_bits_mxu(code, axis=-1))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    n = code.shape[-1]
    if n % 32:  # the pad bits of the last word are 0
        assert ((want[..., -1].view(np.uint32) >> (n % 32)) == 0).all()
    # the int32-extreme channels are constant bits: tau=MIN on, tau=MAX off
    bits = (want[..., 0:1] >> np.arange(2)) & 1
    assert (bits[..., 0] == 1).all() and (bits[..., 1] == 0).all()


def _ternary_conv_case(b, h, w, c, n, pool):
    """±1 inputs, {-1, 0, +1} weights about half zero with one all-zero
    output channel, and the ternary pattern's pad correction."""
    rng = np.random.default_rng(b * 1000 + h * 100 + w * 10 + c + n + pool + 7)
    x = _pm1(rng, (b, h, w, c))
    wgt = rng.choice(np.array([-1.0, 0.0, 1.0], np.float32), (3, 3, c, n),
                     p=[0.25, 0.5, 0.25])
    wgt[..., 2] = 0.0
    mask, sign, nnz = pack_conv_ternary_np(wgt)
    sgn, tau = _epilogue(rng, n, 9 * c)
    return (pack_bits_np(x, -1), mask, sign, nnz,
            padding_correction(wgt, h, w), sgn, tau)


TERNARY_CONV_CASES = [  # (b, h, w, c, n, pool)
    (2, 8, 8, 32, 64, False),
    (2, 8, 8, 32, 64, True),
    (3, 5, 7, 32, 32, False),   # odd spatial
    (2, 4, 4, 40, 32, True),    # C not a multiple of 32
    (1, 5, 7, 16, 48, False),   # N = 48
    (2, 4, 4, 8, 16, True),     # VGG_CF's width-8 conv_2 shape
    (2, 4, 4, 64, 10, True),    # N = 10
]


@pytest.mark.parametrize("shape", TERNARY_CONV_CASES,
                         ids=[str(s) for s in TERNARY_CONV_CASES])
def test_ternary_conv_words_match_jax(shape):
    xp, mask, sign, nnz, corr, sgn, tau = _ternary_conv_case(*shape)
    pool = shape[-1]
    code = jax_fused.ternary_conv_fused(
        *(jnp.asarray(a) for a in (xp, mask, sign, nnz, corr, sgn, tau)),
        pool=pool)
    want = np.asarray(pack_bits_mxu(code, axis=-1))
    got = F.ternary_conv_fused(*_t(xp, mask, sign, nnz, corr, sgn, tau),
                               pool=pool)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    bits = (want[..., 0:1] >> np.arange(2)) & 1  # tau = MIN on, MAX off
    assert (bits[..., 0] == 1).all() and (bits[..., 1] == 0).all()


@pytest.mark.parametrize("pool", [False, True])
def test_ternary_conv_ref_matches_unfused_ternary_conv(pool):
    """The plain fused ternary conv equals thresholding the unfused popcount
    ternary conv, which equals the JAX ``ternary_conv``."""
    xp, mask, sign, nnz, corr, sgn, tau = _ternary_conv_case(2, 6, 4, 64, 32,
                                                             pool)
    s = ternary_conv(*_t(xp, mask, sign, nnz, corr))
    np.testing.assert_array_equal(
        s.numpy(), np.asarray(jax_xc.ternary_conv(
            *(jnp.asarray(a) for a in (xp, mask, sign, nnz, corr)))))
    if pool:
        b, h, w, n = s.shape
        s = s.reshape(b, h // 2, 2, w // 2, 2, n).amax(dim=(2, 4))
    sgn_t, tau_t = _t(sgn, tau)
    want = pack_bits((sgn_t * s >= tau_t).to(torch.int8))
    got = F.ternary_conv_fused_ref(*_t(xp, mask, sign, nnz, corr, sgn, tau),
                                   pool=pool)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("pool", [False, True])
def test_fused_conv_ref_matches_unfused_popcount_conv(pool):
    """The plain fused conv (±1 float matmul) equals thresholding the plain
    unfused popcount conv, an independent formulation."""
    xp, wp, k, corr, sgn, tau = _conv_case(2, 6, 4, 64, 32, pool)
    s = xnor_conv(*_t(xp, wp), k, *_t(corr))
    np.testing.assert_array_equal(
        s.numpy(), np.asarray(jax_xc.xnor_conv(jnp.asarray(xp), jnp.asarray(wp),
                                               k, jnp.asarray(corr))))
    if pool:
        b, h, w, n = s.shape
        s = s.reshape(b, h // 2, 2, w // 2, 2, n).amax(dim=(2, 4))
    sgn_t, tau_t = _t(sgn, tau)
    want = pack_bits((sgn_t * s >= tau_t).to(torch.int8))
    got = F.xnor_conv_fused_ref(*_t(xp, wp), k, *_t(corr, sgn, tau), pool=pool)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_cpu_tensors_never_count_launches():
    F.xnor_gemm_fused.launches = 0
    F.xnor_conv_fused.launches = 0
    F.ternary_conv_fused.launches = 0
    xp, wp, k, sgn, tau = _dense_case(4, 64, 32)
    F.xnor_gemm_fused(*_t(xp, wp), k, *_t(sgn, tau))
    xp, wp, k, corr, sgn, tau = _conv_case(1, 4, 4, 32, 32, True)
    F.xnor_conv_fused(*_t(xp, wp), k, *_t(corr, sgn, tau), pool=True)
    F.ternary_conv_fused(*_t(*_ternary_conv_case(1, 4, 4, 32, 32, True)),
                         pool=True)
    assert F.xnor_gemm_fused.launches == 0
    assert F.xnor_conv_fused.launches == 0
    assert F.ternary_conv_fused.launches == 0


def test_wrappers_reject_what_the_kernels_do_not_take():
    xp, wp, k, sgn, tau = _dense_case(4, 64, 32)
    with pytest.raises(ValueError, match="sgn"):
        F.xnor_gemm_fused(*_t(xp, wp[:, :16]), k, *_t(sgn, tau))
    with pytest.raises(ValueError, match="Kw"):
        F.xnor_gemm_fused(*_t(xp, wp[:1]), k, *_t(sgn, tau))
    with pytest.raises(TypeError, match="int32"):
        F.xnor_gemm_fused(*_t(xp, wp.astype(np.int64)), k, *_t(sgn, tau))
    with pytest.raises(ValueError, match="contiguous"):
        x2 = torch.from_numpy(np.repeat(xp, 2, axis=1))[:, ::2]
        F.xnor_gemm_fused(x2, *_t(wp), k, *_t(sgn, tau))
    xp, wp, k, corr, sgn, tau = _conv_case(1, 5, 4, 32, 32, False)
    with pytest.raises(ValueError, match="even"):
        F.xnor_conv_fused(*_t(xp, wp), k, *_t(corr, sgn, tau), pool=True)
    with pytest.raises(ValueError, match="corr"):
        F.xnor_conv_fused(*_t(xp, wp), k, *_t(corr[:4], sgn, tau))
    xp, mask, sign, nnz, corr, sgn, tau = _ternary_conv_case(1, 4, 4, 32, 32,
                                                             False)
    with pytest.raises(ValueError, match="nnz"):
        F.ternary_conv_fused(*_t(xp, mask, sign, nnz[:3], corr, sgn, tau))
    with pytest.raises(ValueError, match="sign"):
        F.ternary_conv_fused(*_t(xp, mask, sign[:, :16], nnz, corr, sgn, tau))
