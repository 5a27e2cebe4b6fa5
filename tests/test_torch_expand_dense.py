"""The tensor-core formulation of the packed dense kernels
(``qnx_torch/kernels/csrc/expand_mma_dense.cu``: kernel A's binary and
ternary dense entries, A and A', and kernel D's dense layer) against the JAX
package, and a numpy mirror of the kernel's split K.

The CUDA kernel expands the packed operands to int8 and takes one int8
product: A's bits and sign plane become s8 +-1 and it adds ``k - 32 Kw``;
A''s bits s8 +-1 and (mask, sign) planes s8 ``mask (2 sign - 1)``, and it
adds ``nnz - popc(mask's column)``; D's P {0,1} planes become u8 levels and
its (mask, msign) planes s8 ``2 msign - mask``.  Here that formulation runs
in plain torch (exact int64 products over the expanded operands) and must
equal ``qnx.kernels.xnor_conv_fused.xnor_gemm_fused`` /
``ternary_gemm_fused`` (Pallas in interpret mode, repacked with
``pack_bits_mxu``) and the JAX ``PlaneDenseTernary`` (``plane_gemm`` per
plane, the level thresholds, the planes) on the same numpy inputs.  The
kernel splits each tile's K steps over the blocks of a cluster and sums
their partials, each block folding in its slice's count of the mask's
column; the mirror holds every split the wrapper can pick to the unsplit
sums.  The kernel itself is held against the wrappers' unchanged plain
versions on the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qnx.kernels import plane_gemm as jax_pg
from qnx.kernels import xnor_conv_fused as jax_fused
from qnx.nn.inference import PlaneDenseTernary
from qnx.ops.packing import pack_bits_mxu
from qnx_torch.kernels import plane_gemm as PG
from qnx_torch.kernels import xnor_conv_fused as F
from qnx_torch.kernels.i8_conv_fused import multi_threshold
from qnx_torch.ops.packing import pack_bits, pack_bits_np, pack_ternary_np
from test_torch_expand_mma import (_bits, _dot, _planes, _ternary,
                                   binary_weights_s8, levels_u8, plane_weights_s8,
                                   pm1_s8, ternary_weights_s8)

torch.set_num_threads(2)

I32 = np.iinfo(np.int32)


# ---------------------------------------------------------------- plain torch

def _threshold_pack(s, sgn, tau):
    return pack_bits((sgn * s >= tau).to(torch.int8), axis=-1)


def binary_dense_mma(xp, wp, k, sgn, tau):
    """A's dense layer as one product: s8 +-1 bits times the s8 +-1 sign
    plane over every bit position, + (k - 32 Kw); the threshold, the words."""
    s = _dot(pm1_s8(xp), binary_weights_s8(wp)) + (k - 32 * xp.shape[1])
    return _threshold_pack(s, sgn, tau)


def ternary_dense_mma(xp, mask, sign, nnz, sgn, tau):
    """A''s dense layer as one product: s8 +-1 bits times the s8 ternary
    weights, + (nnz - popc of mask's column); the threshold, the words."""
    count = _bits(mask.T).sum(dim=-1)
    s = _dot(pm1_s8(xp), ternary_weights_s8(mask, sign)) + (nnz - count)
    return _threshold_pack(s, sgn, tau)


def plane_dense_mma(planes, mask, msign, sgn, tau):
    """D's dense layer as one product: the P planes as u8 levels times the
    s8 ``2 msign - mask``; the level thresholds, the P planes."""
    s = _dot(levels_u8(planes), plane_weights_s8(mask, msign)).to(torch.int32)
    return PG.levels_to_planes(multi_threshold(s, sgn, tau), planes.shape[0])


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _epilogue(rng, n, k):
    """Mixed-direction thresholds around the spread of s, with the
    int32-extreme constant channels."""
    sgn = rng.choice(np.array([1, -1], np.int32), n)
    lim = 2 * int(np.sqrt(k)) + 1
    tau = rng.integers(-lim, lim, n).astype(np.int32)
    tau[0], tau[1] = I32.min, I32.max
    return sgn, tau


def _pad_noise(rng, words, k, axis):
    """The words with random bits in the pad bits past k of the last word
    along the packed axis (pack_bits leaves them 0)."""
    if k % 32 == 0:
        return words
    out = np.moveaxis(words.view(np.uint32).copy(), axis, -1)
    pad = np.uint32(0xFFFFFFFF) << np.uint32(k % 32)
    noise = rng.integers(0, 2**32, out[..., -1].shape, dtype=np.uint64)
    out[..., -1] |= noise.astype(np.uint32) & pad
    return np.moveaxis(out, -1, axis).view(np.int32)


# ---------------------------------------------------------------- A and A'

DENSE_CASES = [  # (m, k, n)
    (5, 64, 10),     # two words: KW = 1 on the card
    (7, 100, 33),    # K past a word, N past a word
    (3, 256, 130),   # eight words: KW = 4, N past the tile's words
    (9, 392, 48),    # 13 words (Kw % 4 != 0), K past a word
]


@pytest.mark.parametrize("pad_bits", [False, True], ids=["zero-pad", "random-pad"])
@pytest.mark.parametrize("shape", DENSE_CASES, ids=[str(s) for s in DENSE_CASES])
def test_binary_dense_product_matches_jax(shape, pad_bits):
    """s8 x s8 over every bit position + (k - 32 Kw), the threshold and
    the words equal the JAX popcount kernel's codes repacked (interpret
    mode), for nonzero pad bits in both operands too; so does the
    wrapper's plain version."""
    m, k, n = shape
    rng = np.random.default_rng(m * 1000 + k + n + pad_bits)
    x = np.where(rng.random((m, k)) < 0.5, 1.0, -1.0).astype(np.float32)
    w = np.where(rng.random((k, n)) < 0.5, 1.0, -1.0).astype(np.float32)
    xp, wp = pack_bits_np(x, -1), pack_bits_np(w, 0)
    if pad_bits:
        xp, wp = _pad_noise(rng, xp, k, 1), _pad_noise(rng, wp, k, 0)
        assert k % 32 == 0 or ((xp != pack_bits_np(x, -1)).any()
                               and (wp != pack_bits_np(w, 0)).any())
    sgn, tau = _epilogue(rng, n, k)
    code = jax_fused.xnor_gemm_fused(jnp.asarray(xp), jnp.asarray(wp), k,
                                     jnp.asarray(sgn), jnp.asarray(tau))
    want = np.asarray(pack_bits_mxu(code, axis=-1))
    txp, twp, tsgn, ttau = _t(xp, wp, sgn, tau)
    np.testing.assert_array_equal(
        binary_dense_mma(txp, twp, k, tsgn, ttau).numpy(), want)
    np.testing.assert_array_equal(
        F.xnor_gemm_fused(txp, twp, k, tsgn, ttau).numpy(), want)


@pytest.mark.parametrize("nnz_shift", [0, 7])
@pytest.mark.parametrize("shape", DENSE_CASES, ids=[str(s) for s in DENSE_CASES])
def test_ternary_dense_product_matches_jax(shape, nnz_shift):
    """s8 x s8 with the ternary weights + (nnz - count), the threshold and
    the words equal the JAX ternary kernel's codes repacked (interpret
    mode), for an nnz that is not the mask's count too."""
    m, k, n = shape
    rng = np.random.default_rng(m * 1000 + k + n + nnz_shift)
    x = np.where(rng.random((m, k)) < 0.5, 1.0, -1.0).astype(np.float32)
    mask, sign, nnz = pack_ternary_np(_ternary(rng, (k, n)), axis=0)
    nnz = (nnz + nnz_shift).astype(np.int32)
    sgn, tau = _epilogue(rng, n, k)
    args = (pack_bits_np(x, -1), mask, sign, nnz, sgn, tau)
    code = jax_fused.ternary_gemm_fused(*(jnp.asarray(a) for a in args))
    want = np.asarray(pack_bits_mxu(code, axis=-1))
    targs = _t(*args)
    np.testing.assert_array_equal(ternary_dense_mma(*targs).numpy(), want)
    np.testing.assert_array_equal(F.ternary_gemm_fused(*targs).numpy(), want)


# ---------------------------------------------------------------- D

@pytest.mark.parametrize("p,m,k,n,n_thresh", [
    (1, 6, 64, 10, 1), (2, 5, 100, 33, 3), (3, 4, 256, 40, 7),
    (8, 3, 96, 48, 255)])
def test_plane_dense_product_matches_jax(p, m, k, n, n_thresh):
    """One u8 x s8 product over the levels, the level thresholds and the
    planes equal the JAX PlaneDenseTernary (plane_gemm per plane in
    interpret mode, summed, thresholded, repacked), with msign outside the
    mask (weight 2) and int32-extreme thresholds; P = 8 takes levels to 255
    (the u8 top bit).  So does the wrapper's plain version."""
    rng = np.random.default_rng(p * 100 + k + n)
    planes = _planes(rng, p, (m, k))
    mask, _, _ = pack_ternary_np(_ternary(rng, (k, n)), axis=0)
    msign = rng.integers(I32.min, I32.max, mask.shape, dtype=np.int64,
                         endpoint=True).astype(np.int32)
    sgn = rng.choice(np.array([1, -1], np.int32), n)
    lim = int(np.sqrt(k)) * 2 ** (p - 1) + 1
    tau = np.sort(rng.integers(-lim, lim, (n_thresh, n)), axis=0).astype(np.int32)
    tau[:, 0], tau[:, 2] = I32.min, I32.max
    layer = PlaneDenseTernary(*(jnp.asarray(a) for a in (mask, msign, sgn, tau)),
                              nb=p + 1)
    want = np.asarray(layer(jnp.asarray(planes)))
    assert want.shape == (p, m, -(-n // 32))
    targs = _t(planes, mask, msign, sgn, tau)
    np.testing.assert_array_equal(plane_dense_mma(*targs).numpy(), want)
    np.testing.assert_array_equal(PG.plane_dense_fused(*targs).numpy(), want)


def test_plane_dense_jax_layer_is_the_plane_loop():
    """The JAX layer the D test holds to is plane_gemm summed over the
    planes (the Pallas kernel, interpret mode) then the levels."""
    rng = np.random.default_rng(5)
    p, m, k, n = 2, 4, 64, 20
    planes = _planes(rng, p, (m, k))
    mask, sign, _ = pack_ternary_np(_ternary(rng, (k, n)), axis=0)
    s = sum(np.asarray(jax_pg.plane_gemm(jnp.asarray(planes[j]), jnp.asarray(mask),
                                         jnp.asarray(mask & sign))).astype(np.int64) << j
            for j in range(p))
    got = _dot(levels_u8(torch.from_numpy(planes)),
               plane_weights_s8(*_t(mask, mask & sign)))
    np.testing.assert_array_equal(got.numpy(), s)


# ---------------------------------------------------------------- split K

def _partition(steps: int, splits: int) -> list[tuple[int, int]]:
    """The kernel's K slices: block r of the cluster takes steps
    [r steps / splits, (r + 1) steps / splits)."""
    return [(r * steps // splits, (r + 1) * steps // splits) for r in range(splits)]


@pytest.mark.parametrize("kw_step", [1, 4], ids=["KW1", "KW4"])
def test_split_k_mirror_sums_to_the_unsplit_product(kw_step):
    """For every split the wrapper can pick (1, 2, 4, 8) and every step
    count from the split up (ragged shares included): each block gets at
    least one step, the slices cover the K steps once, the blocks' partial
    products less each slice's count of the mask's column sum to the unsplit
    s8 product less the whole count, and the epilogue's row slices (128 /
    splits rows a block) cover the tile's rows once."""
    rng = np.random.default_rng(kw_step)
    m, n = 3, 5
    for splits in (1, 2, 4, 8):
        for steps in range(splits, splits + 11):
            kw = steps * kw_step
            x = rng.choice(np.array([-1, 1], np.int64), (m, 32 * kw))
            mask = rng.integers(0, 2, (32 * kw, n))
            w = mask * rng.choice(np.array([-1, 1], np.int64), (32 * kw, n))
            slices = _partition(steps, splits)
            assert all(lo < hi for lo, hi in slices)
            assert [lo for lo, _ in slices[1:]] == [hi for _, hi in slices[:-1]]
            assert slices[0][0] == 0 and slices[-1][1] == steps
            total = np.zeros((m, n), np.int64)
            for lo, hi in slices:
                ks = slice(lo * kw_step * 32, hi * kw_step * 32)
                total += x[:, ks] @ w[ks] - mask[ks].sum(axis=0)
            np.testing.assert_array_equal(total, x @ w - mask.sum(axis=0))
            rows = np.concatenate([np.arange(r * 128 // splits, (r + 1) * 128 // splits)
                                   for r in range(splits)])
            np.testing.assert_array_equal(rows, np.arange(128))


def test_dense_splits_picks():
    """The served shapes at batch 256 on 132 SMs: VGG dense_0's 16 tiles
    split 8 ways, dense_1's 4 ways (its 8 K steps, two a block), each MNIST
    hidden layer's 64 tiles 2 ways; every split is a power of two up to 8
    that leaves each block two K steps and keeps the blocks within one
    wave; and the chip check's shapes reach each of 1, 2, 4 and 8."""
    assert F.dense_splits(256, 1024, 256, 132) == 8   # dense_0 8192 -> 1024
    assert F.dense_splits(256, 1024, 32, 132) == 4    # dense_1 1024 -> 1024
    assert F.dense_splits(256, 4096, 128, 132) == 2   # MNIST 4096 -> 4096
    assert F.dense_splits(1024, 4096, 128, 132) == 1  # 256 tiles
    seen = set()
    for m in (1, 17, 100, 256, 300, 1024):
        for n in (1, 10, 33, 130, 1024, 4096):
            for kw in (1, 2, 3, 13, 32, 128, 256):
                s = F.dense_splits(m, n, kw, 132)
                steps = kw // 4 if kw % 4 == 0 else kw
                tiles = -(-m // 128) * -(-n // 128)
                assert s in (1, 2, 4, 8)
                assert s == 1 or 2 * s <= steps
                assert s == 1 or s * tiles <= 132
                seen.add(s)
    assert seen == {1, 2, 4, 8}
