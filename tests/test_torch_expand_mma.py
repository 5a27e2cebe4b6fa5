"""The tensor-core formulation of kernel D's conv and the A and A' convs
(``qnx_torch/kernels/csrc/expand_mma_conv.cu``) against the JAX package.

The CUDA kernels expand packed operands to int8 and take one int8 product:
D's P {0,1} planes become u8 levels and its (mask, msign) planes s8
``2 msign - mask``; the A and A' convs' bits become s8 +-1, A's one
weight plane s8 +-1 and A''s (mask, sign) planes s8 ``mask (2 sign -
1)``; A adds ``k - 288 Cw`` and corr, A' ``nnz - popc(mask's column)`` and
corr.
Here that formulation runs in plain torch (exact int64 products over the
expanded patches, padded with the zero word's expansion) and must equal
``qnx.kernels.plane_gemm.plane_conv`` / ``plane_gemm`` and
``qnx.kernels.xnor_conv_fused.xnor_conv_fused`` / ``ternary_conv_fused``
(Pallas in interpret mode) on the same numpy inputs.  A numpy uint32 mirror of the kernel's
expanders is checked exhaustively against the plain expansion, in the
kernel's channel order within a word (tile word i byte q is channel
8q + i).  The kernels themselves are held against the wrappers' unchanged
plain versions on the card by ``chip_smoke.py``."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qnx.kernels import plane_gemm as jax_pg
from qnx.kernels import xnor_conv_fused as jax_fused
from qnx.ops.packing import pack_bits_mxu
from qnx_torch.kernels import plane_gemm as PG
from qnx_torch.kernels import xnor_conv_fused as F
from qnx_torch.kernels.xnor_conv import (extract_packed_patches,
                                         pack_conv_ternary_np,
                                         pack_conv_weights_np,
                                         padding_correction)
from qnx_torch.ops.packing import WORD, pack_bits, pack_bits_np, pack_ternary_np

torch.set_num_threads(2)

I32 = np.iinfo(np.int32)
U32 = np.uint32
LSB = U32(0x01010101)


# ---------------------------------------------------------------- plain torch

def _bits(words: torch.Tensor) -> torch.Tensor:
    """(..., Kw) int32 words -> (..., 32 Kw) int64 {0,1}, bit j of word w
    at 32 w + j."""
    shifts = torch.arange(WORD, dtype=torch.int64)
    b = (words.to(torch.int64).unsqueeze(-1) >> shifts) & 1
    return b.reshape(*words.shape[:-1], -1)


def levels_u8(planes: torch.Tensor) -> torch.Tensor:
    """(P, ..., Kw) {0,1} planes -> (..., 32 Kw) uint8 levels sum_j 2^j b_j."""
    lvl = sum(_bits(planes[j]) << j for j in range(planes.shape[0]))
    return lvl.to(torch.uint8)


def plane_weights_s8(mask: torch.Tensor, msign: torch.Tensor) -> torch.Tensor:
    """(Kw, N) planes -> (32 Kw, N) int8 2 msign - mask (the popcount
    form's weight for any words: -1, 0, +1, and 2 outside the mask)."""
    w = 2 * _bits(msign.T) - _bits(mask.T)
    return w.T.to(torch.int8)


def pm1_s8(bits: torch.Tensor) -> torch.Tensor:
    """(..., Kw) words -> (..., 32 Kw) int8 +1 for a set bit, -1 for a
    clear one (the zero word is all -1)."""
    return (2 * _bits(bits) - 1).to(torch.int8)


def binary_weights_s8(sign: torch.Tensor) -> torch.Tensor:
    """(Kw, N) sign words -> (32 Kw, N) int8 +1 for a set bit, -1 for a
    clear one."""
    return pm1_s8(sign.T).T


def ternary_weights_s8(mask: torch.Tensor, sign: torch.Tensor) -> torch.Tensor:
    """(Kw, N) planes -> (32 Kw, N) int8 mask ? (sign ? +1 : -1) : 0."""
    return (_bits(mask.T) * (2 * _bits(sign.T) - 1)).T.to(torch.int8)


def _dot(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Exact integer product of the expanded operands."""
    return x8.to(torch.int64) @ w8.to(torch.int64)


def plane_conv_mma(planes: torch.Tensor, mask: torch.Tensor,
                   msign: torch.Tensor) -> torch.Tensor:
    """D's conv as one product: the zero-word-padded patches of every plane
    expanded to u8 levels, times the s8 weights -> (B, H, W, N) int32."""
    p, b, h, w, cw = planes.shape
    patches = torch.stack([extract_packed_patches(planes[j], 3, 3)
                           .reshape(b * h * w, 9 * cw) for j in range(p)])
    s = _dot(levels_u8(patches), plane_weights_s8(mask, msign))
    return s.to(torch.int32).reshape(b, h, w, -1)


def _pool_threshold_pack(s, corr, sgn, tau, pool):
    """+ corr, the pool of s, the threshold, the packed words."""
    b, h, w = s.shape[:3]
    s = s + corr
    if pool:
        s = s.reshape(b, h // 2, 2, w // 2, 2, -1).amax(dim=(2, 4))
    return pack_bits((sgn * s >= tau).to(torch.int8), axis=-1)


def binary_conv_mma(xp, wp, k, corr, sgn, tau, pool):
    """A's binary conv as one product: the zero-word-padded patches expanded
    to s8 +-1, times the s8 +-1 sign plane, + (k - 288 Cw) + corr; the pool
    of s, the threshold, the packed words."""
    b, h, w, cw = xp.shape
    patches = extract_packed_patches(xp, 3, 3).reshape(b * h * w, 9 * cw)
    s = _dot(pm1_s8(patches), binary_weights_s8(wp)) + (k - 288 * cw)
    return _pool_threshold_pack(s.reshape(b, h, w, -1), corr, sgn, tau, pool)


def ternary_conv_mma(xp, mask, sign, nnz, corr, sgn, tau, pool):
    """The A' conv as one product: the zero-word-padded patches expanded to
    s8 +-1, times the s8 ternary weights, + (nnz - popc of mask's column)
    + corr; the pool of s, the threshold, the packed words."""
    b, h, w, cw = xp.shape
    patches = extract_packed_patches(xp, 3, 3).reshape(b * h * w, 9 * cw)
    count = _bits(mask.T).sum(dim=-1)
    s = _dot(pm1_s8(patches), ternary_weights_s8(mask, sign)) + (nnz - count)
    return _pool_threshold_pack(s.reshape(b, h, w, -1), corr, sgn, tau, pool)


# ------------------------------------------------ numpy mirror of the device

def rotr(x, s):
    """__funnelshift_r(x, x, s): rotate right by s mod 32."""
    x = np.asarray(x, U32)
    s = U32(s % 32)
    return (x >> s) | (x << U32((32 - s) % 32)) if s else x


def expand_a_planes(words, h):
    """PlaneOperands::expand_a: tile words 4h..4h+3 of one word per plane."""
    v = [U32(0)] * 4
    for j, wj in enumerate(words):
        x = rotr(wj, 4 * h - j)
        keep = U32(LSB << U32(j))
        v = [v[e] | (rotr(x, e) & keep) for e in range(4)]
    return v


def expand_b_planes(mask, msign, h):
    """PlaneOperands::expand_b."""
    xm, xs = rotr(mask, 4 * h), rotr(msign, 4 * h - 1)
    out = []
    for e in range(4):
        two_s = (rotr(xs, e) & U32(0x02020202)) | U32(0x80808080)
        out.append((two_s - (rotr(xm, e) & LSB)) ^ U32(0x80808080))
    return out


def expand_a_pm1(word, h):
    """TernaryOperands::expand_a."""
    x = rotr(word, 4 * h)
    return [(rotr(x, e) & LSB) * U32(0xFFFFFF02) + U32(0xFFFFFFFF)
            for e in range(4)]


def expand_b_binary(sign, h):
    """BinaryOperands::expand_b: the sign word's bits as +-1 (expand_pm1)."""
    return expand_a_pm1(sign, h)


def expand_b_ternary(mask, sign, h):
    """TernaryOperands::expand_b."""
    neg = rotr(U32(mask) & ~U32(sign), 4 * h)
    pos = rotr(U32(mask) & U32(sign), 4 * h)
    return [(rotr(neg, e) & LSB) * U32(0xFF) + (rotr(pos, e) & LSB)
            for e in range(4)]


def tile_bytes(expand, *words):
    """The 32 tile bytes of one word (both halves), byte 4i + q of tile
    word i, as uint8."""
    with np.errstate(over="ignore"):
        tile = [v for h in (0, 1) for v in expand(*words, h)]
    return np.array(tile, U32).view(np.uint8)  # little-endian: byte q of word i


def _expand_planes(*words_and_half):
    """expand_a_planes with the planes' words as separate arguments."""
    return expand_a_planes(words_and_half[:-1], words_and_half[-1])


# the channel at each tile byte: byte 4i + q holds channel 8q + i
TILE_CHANNEL = np.array([8 * q + i for i in range(8) for q in range(4)])


def _word_with(i, pattern):
    """A word whose bits i, 8+i, 16+i, 24+i hold the 4 bits of pattern."""
    return U32(sum(((pattern >> q) & 1) << (8 * q + i) for q in range(4)))


def _natural(fn, *words):
    """The plain torch expansion of one word (or one column word) per
    operand plane, as 32 bytes in channel order."""
    return fn(*words).numpy().astype(np.uint8).reshape(-1)


# ---------------------------------------------------------------- tests

@pytest.mark.parametrize("p", range(1, 9))
def test_plane_expander_mirror_exhaustive(p):
    """Every tile word i (the shift), each plane j of P and every 16
    patterns of its 4 channels there: the mirror equals the plain levels at
    the tile's channels, and the top bit is plane 7's (levels to 255)."""
    rng = np.random.default_rng(p)
    for i, j, pat in itertools.product(range(8), range(p), range(16)):
        pats = rng.integers(0, 16, p)
        pats[j] = pat  # plane j's 4 channels exhaustively, the others random
        words = [_word_with(i, int(v)) for v in pats]
        planes = torch.tensor(np.array(words, U32).view(np.int32)).reshape(p, 1)
        got = tile_bytes(_expand_planes, *words)
        want = _natural(levels_u8, planes)
        np.testing.assert_array_equal(got, want[TILE_CHANNEL])
    full = torch.full((8, 1), -1, dtype=torch.int32)  # every bit of 8 planes
    np.testing.assert_array_equal(levels_u8(full).numpy(), 255)


def test_weight_and_pm1_expander_mirrors_exhaustive():
    """Every tile word i and every (mask, msign) / (mask, sign) / bit
    combination of its 4 channels: the mirrors equal the plain s8 values,
    msign outside the mask (2) included."""
    for i in range(8):
        for mp, sp in itertools.product(range(16), repeat=2):
            m, s = _word_with(i, mp), _word_with(i, sp)
            mt = torch.tensor(np.array([m], U32).view(np.int32)).reshape(1, 1)
            st = torch.tensor(np.array([s], U32).view(np.int32)).reshape(1, 1)
            want = _natural(plane_weights_s8, mt, st)
            np.testing.assert_array_equal(tile_bytes(expand_b_planes, m, s),
                                          want[TILE_CHANNEL])
            want = _natural(ternary_weights_s8, mt, st)
            np.testing.assert_array_equal(tile_bytes(expand_b_ternary, m, s),
                                          want[TILE_CHANNEL])
        for pat in range(16):
            x = _word_with(i, pat)
            xt = torch.tensor(np.array([x], U32).view(np.int32)).reshape(1)
            np.testing.assert_array_equal(tile_bytes(expand_a_pm1, x),
                                          _natural(pm1_s8, xt)[TILE_CHANNEL])
            # A's weight plane, one column word
            np.testing.assert_array_equal(
                tile_bytes(expand_b_binary, x),
                _natural(binary_weights_s8, xt.reshape(1, 1))[TILE_CHANNEL])
    # the zero word: D's pad is level 0, the A' conv's pad is -1
    assert (tile_bytes(_expand_planes, U32(0), U32(0)) == 0).all()
    assert (tile_bytes(expand_a_pm1, U32(0)).view(np.int8) == -1).all()


def test_tile_order_keeps_the_dot_product():
    """The MMA sums over k in any order: the mirror's tiles of random words
    (channel 8q + i at byte 4i + q, for A and B alike) give the plain
    product of the words."""
    rng = np.random.default_rng(3)
    for _ in range(50):
        planes = rng.integers(0, 2**32, 3, dtype=np.uint64).astype(U32)
        mask, msign = rng.integers(0, 2**32, 2, dtype=np.uint64).astype(U32)
        a = tile_bytes(_expand_planes, *planes)
        b = tile_bytes(expand_b_planes, mask, msign).view(np.int8)
        pt = torch.tensor(planes.view(np.int32)).reshape(3, 1, 1)
        wt = [torch.tensor(np.array([v], U32).view(np.int32)).reshape(1, 1)
              for v in (mask, msign)]
        want = _dot(levels_u8(pt), plane_weights_s8(*wt))
        assert int(a.astype(np.int64) @ b.astype(np.int64)) == int(want)


def _ternary(rng, shape):
    w = rng.choice(np.array([-1.0, 0.0, 1.0], np.float32), shape,
                   p=[0.25, 0.5, 0.25])
    w[..., 1] = 0.0
    return w


def _planes(rng, p, shape):
    lvl = rng.integers(0, 2**p, shape)
    return np.stack([pack_bits_np((lvl >> j) & 1, axis=-1) for j in range(p)])


@pytest.mark.parametrize("p,shape", [
    (1, (2, 6, 6, 32, 16)), (3, (2, 5, 7, 40, 33)), (7, (1, 4, 4, 64, 10)),
    (8, (1, 5, 3, 96, 48))])
def test_plane_conv_product_matches_jax_plane_conv(p, shape):
    """One u8 x s8 product over the expanded zero-word-padded patches equals
    the JAX plane loop (Pallas in interpret mode), P = 8 included (levels to
    255, the u8 top bit)."""
    b, h, w, c, n = shape
    rng = np.random.default_rng(p * 100 + c)
    planes = _planes(rng, p, (b, h, w, c))
    mask, sign, _ = pack_conv_ternary_np(_ternary(rng, (3, 3, c, n)))
    msign = mask & sign
    want = np.asarray(jax_pg.plane_conv(*(jnp.asarray(a) for a in
                                          (planes, mask, msign))))
    got = plane_conv_mma(*(torch.from_numpy(a) for a in (planes, mask, msign)))
    np.testing.assert_array_equal(got.numpy(), want)
    # and the wrapper's plain version sees the same s through its levels
    sgn = np.ones(n, np.int32)
    tau = np.sort(rng.integers(-50, 50, (2**p - 1, n)), axis=0).astype(np.int32)
    fused = PG.plane_conv_fused(*(torch.from_numpy(a) for a in
                                  (planes, mask, msign, sgn, tau)))
    lvl = (got.numpy()[..., None, :] >= tau).sum(axis=-2)
    np.testing.assert_array_equal(fused.numpy(), PG.levels_to_planes(
        torch.from_numpy(lvl), p).numpy())


@pytest.mark.parametrize("p,m,k,n", [(1, 7, 64, 10), (3, 5, 100, 33),
                                     (8, 4, 96, 40)])
def test_plane_gemm_product_matches_jax_plane_gemm(p, m, k, n):
    """The same product on dense planes equals the JAX plane GEMM summed
    over the planes, 2 msign - mask for msign outside the mask too."""
    rng = np.random.default_rng(m + k + n)
    planes = _planes(rng, p, (m, k))
    mask, _, _ = pack_ternary_np(_ternary(rng, (k, n)), axis=0)
    # random words: msign outside the mask too (weight 2)
    msign = rng.integers(I32.min, I32.max, mask.shape, dtype=np.int64,
                         endpoint=True).astype(np.int32)
    want = sum(np.asarray(jax_pg.plane_gemm(jnp.asarray(planes[j]),
                                            jnp.asarray(mask), jnp.asarray(msign)))
               .astype(np.int64) << j for j in range(p))
    got = _dot(levels_u8(torch.from_numpy(planes)),
               plane_weights_s8(torch.from_numpy(mask), torch.from_numpy(msign)))
    np.testing.assert_array_equal(got.numpy(), want)


TERNARY_CASES = [  # (b, h, w, c, n, pool)
    (2, 6, 6, 40, 33, True),     # ragged C and N, pool
    (1, 5, 7, 160, 10, False),   # C = 160 (5 words), N = 10, odd spatial
    (2, 4, 4, 128, 32, True),    # 4 words a step on the card
    (1, 3, 5, 96, 48, False),    # C = 96, three words
]


@pytest.mark.parametrize("shape", TERNARY_CASES, ids=[str(s) for s in TERNARY_CASES])
@pytest.mark.parametrize("nnz_shift", [0, 5])
def test_ternary_conv_product_matches_jax(shape, nnz_shift):
    """s8 x s8 over the expanded patches (pads -1) + (nnz - count) + corr,
    the pool of s and the threshold equal the JAX popcount kernel's packed
    codes (interpret mode), also for an nnz that is not the mask's count."""
    b, h, w, c, n, pool = shape
    rng = np.random.default_rng(b * 100 + c + n)
    x = np.where(rng.random((b, h, w, c)) < 0.5, 1.0, -1.0).astype(np.float32)
    wgt = _ternary(rng, (3, 3, c, n))
    mask, sign, nnz = pack_conv_ternary_np(wgt)
    nnz = (nnz + nnz_shift).astype(np.int32)
    sgn = rng.choice(np.array([1, -1], np.int32), n)
    lim = 2 * int(np.sqrt(9 * c)) + 1
    tau = rng.integers(-lim, lim, n).astype(np.int32)
    tau[0], tau[1] = I32.min, I32.max
    args = (pack_bits_np(x, -1), mask, sign, nnz,
            padding_correction(wgt, h, w), sgn, tau)
    code = jax_fused.ternary_conv_fused(*(jnp.asarray(a) for a in args), pool=pool)
    want = np.asarray(pack_bits_mxu(code, axis=-1))
    targs = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    got = ternary_conv_mma(*targs, pool=pool)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(F.ternary_conv_fused(*targs, pool=pool).numpy(),
                                  want)


BINARY_CASES = [  # (b, h, w, c, n, pool)
    (2, 4, 4, 8, 10, True),      # C = 8: 24 pad bits a word
    (1, 5, 7, 16, 33, False),    # odd spatial, N past a word
    (2, 6, 6, 40, 33, True),     # two words, the second ragged
    (1, 3, 5, 40, 10, False),
    (2, 4, 6, 96, 10, True),     # three full words
    (1, 5, 3, 96, 33, False),
]


def _with_pad_bits(rng, words, c):
    """The words with random bits in the pad bits past C of each tap's last
    word (channel c % 32 onwards), as pack_bits leaves them 0."""
    if c % 32 == 0:
        return words
    cw = -(-c // 32)
    pad = np.uint32(0xFFFFFFFF) << np.uint32(c % 32)
    out = words.view(np.uint32).copy()
    noise = rng.integers(0, 2**32, out.shape, dtype=np.uint64).astype(np.uint32) & pad
    if words.ndim == 2:  # (9 Cw, N) weights: row tap * Cw + Cw - 1
        rows = np.arange(cw - 1, out.shape[0], cw)
        out[rows] |= noise[rows]
    else:  # (..., Cw) activations
        out[..., cw - 1] |= noise[..., cw - 1]
    return out.view(np.int32)


@pytest.mark.parametrize("pad_bits", [False, True], ids=["zero-pad", "random-pad"])
@pytest.mark.parametrize("shape", BINARY_CASES, ids=[str(s) for s in BINARY_CASES])
def test_binary_conv_product_matches_jax(shape, pad_bits):
    """s8 x s8 over the expanded patches (pads -1) + (k - 288 Cw) + corr,
    the pool of s and the threshold equal the JAX popcount kernel's packed
    codes (interpret mode), and so does the wrapper's plain version; for
    nonzero pad bits in the weight and activation words too, where the
    popcount form counts them (k - 288 Cw holds for any pad bits)."""
    b, h, w, c, n, pool = shape
    rng = np.random.default_rng(b * 100 + c + n + pool)
    x = np.where(rng.random((b, h, w, c)) < 0.5, 1.0, -1.0).astype(np.float32)
    wgt = np.where(rng.random((3, 3, c, n)) < 0.5, 1.0, -1.0).astype(np.float32)
    wp, k = pack_conv_weights_np(wgt)
    xp = pack_bits_np(x, -1)
    if pad_bits:
        xp, wp = _with_pad_bits(rng, xp, c), _with_pad_bits(rng, wp, c)
        assert c % 32 == 0 or ((xp != pack_bits_np(x, -1)).any()
                               and (wp != pack_conv_weights_np(wgt)[0]).any())
    sgn = rng.choice(np.array([1, -1], np.int32), n)
    lim = 2 * int(np.sqrt(k)) + 1
    tau = rng.integers(-lim, lim, n).astype(np.int32)
    tau[0], tau[1] = I32.min, I32.max
    corr = padding_correction(wgt, h, w)
    code = jax_fused.xnor_conv_fused(jnp.asarray(xp), jnp.asarray(wp), k,
                                     *(jnp.asarray(a) for a in (corr, sgn, tau)),
                                     pool=pool)
    want = np.asarray(pack_bits_mxu(code, axis=-1))
    targs = [torch.from_numpy(np.ascontiguousarray(a)) for a in (xp, wp)]
    rest = [torch.from_numpy(np.ascontiguousarray(a)) for a in (corr, sgn, tau)]
    got = binary_conv_mma(*targs, k, *rest, pool=pool)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        F.xnor_conv_fused(*targs, k, *rest, pool=pool).numpy(), want)
