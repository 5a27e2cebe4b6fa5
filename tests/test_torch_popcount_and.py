"""Kernels B and C at wide N on the single-bit tensor cores
(``qnx_torch/kernels/csrc/popcount_gemm.cu``): a numpy model of the
kernel's walk held equal, exactly in int32, to the JAX package's
``xnor_gemm_popcount`` and ``ternary_gemm`` (Pallas in interpret mode) and
to the port's wrappers on CPU tensors (their plain versions).

The model follows the kernel step by step: blocks of 128 rows x 128
columns; K steps of 32 words with zero fill past Kw, M and N; x's rows
copied into a 128-byte-swizzled tile in 16-byte units (``swizzle128``) or
4-byte words, the weights staged by a word transpose (word i of column n to
word i of tile row n, ``word_at``), C's second tile ``mask & sign``; the
AND-popcount wgmma of 256 bits a sub-step, issued only for sub-steps that
hold words, reading each row through the hardware's swizzle (16-byte chunk
c of row r at c ^ (r % 8)); the operand popcounts from the staged tiles
(``row_popc``); the epilogue ``k - 2 (rx + cw) + 4 P`` or ``nnz - 2 P_m -
2 c_ms + 4 P_ms`` in wrapping 32-bit arithmetic.  The CUDA kernel itself is
held against the plain versions on the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qnx.kernels.ternary_gemm import ternary_gemm as jax_ternary_gemm
from qnx.kernels.xnor_gemm import xnor_gemm_popcount as jax_xnor_gemm_popcount
from qnx_torch.kernels.ternary_gemm import ternary_gemm
from qnx_torch.kernels.xnor_gemm import xnor_gemm_popcount
from qnx_torch.ops.packing import pack_bits_np, pack_ternary_np

torch.set_num_threads(2)

BM = BN = 128      # a block's rows and columns
KW_STEP = 32       # words of K a step: one 128-byte tile row
ROW_BYTES = 4 * KW_STEP
K256 = KW_STEP // 8  # single-bit wgmma a step, 256 bits each
THREADS = 256


def swizzle128(u):
    """Byte offset of 16-byte copy unit u of a swizzled tile (wgmma_conv.cuh)."""
    return (u >> 6) * 1024 + (u & 7) * 128 + ((((u >> 3) & 7) ^ (u & 7)) << 4)


def word_at(r, i):
    """Byte offset of word i of row r of a swizzled tile (popcount_gemm.cu)."""
    return r * ROW_BYTES + (((i >> 2) ^ (r & 7)) << 4) + ((i & 3) << 2)


def stage_x(xp, m0, k0, vec):
    """The x tile of one step as the kernel's copies leave it: (128 rows x 32
    words) uint32, laid out swizzled, zeros past M and Kw.  ``vec`` 16: one
    copy a 16-byte chunk (Kw % 4 == 0), 4: a copy a word."""
    m, kw = xp.shape
    tile = np.zeros(BM * KW_STEP, np.uint32)
    u = np.arange(BM * KW_STEP // 4)
    row = (u >> 6) * 8 + (u & 7)
    ch = (u >> 3) & 7
    for j in range(4):
        word = k0 + 4 * ch + j
        valid = (m0 + row < m) & ((k0 + 4 * ch < kw) if vec == 16 else (word < kw))
        src = xp[np.minimum(m0 + row, m - 1), np.minimum(word, kw - 1)]
        tile[swizzle128(u) // 4 + j] = np.where(valid, src.view(np.uint32), 0)
    return tile


def stage_w(wp, n0, k0, bn=BN):
    """A weight tile of one step: the (Kw, N) words transposed, word i of
    column n0 + c at word_at(c, i); zeros past N and Kw.  Thread t copies
    column t % bn, words t // bn + (256 / bn) j (bn 128: B's and C's
    tiles; 64: G's at four fragment sets)."""
    kw, n = wp.shape
    tile = np.zeros(bn * KW_STEP, np.uint32)
    t = np.arange(THREADS)[:, None]
    c = t % bn
    i = t // bn + THREADS // bn * np.arange(bn * KW_STEP // THREADS)[None, :]
    valid = (n0 + c < n) & (k0 + i < kw)
    src = wp[np.minimum(k0 + i, kw - 1), np.minimum(n0 + c, n - 1)]
    tile[word_at(c, i) // 4] = np.where(valid, src.view(np.uint32), 0)
    return tile


def logical_rows(tile, rows=BM):
    """(rows, 32) words of a swizzled tile as wgmma reads them: 16-byte
    chunk c of row r at chunk c ^ (r % 8)."""
    r = np.arange(rows)[:, None]
    i = np.arange(KW_STEP)[None, :]
    return tile[(r * ROW_BYTES + (((i >> 2) ^ (r & 7)) << 4) + ((i & 3) << 2)) // 4]


def row_popc(tile, r, c0, count):
    """Each thread's popcount of 16-byte chunks c0 .. c0 + count - 1 of its
    row r, read at their swizzled places (r, c0: arrays over the threads)."""
    total = 0
    for j in range(count):
        c = c0 + j
        at = (r * ROW_BYTES + ((c ^ (r & 7)) << 4)) // 4
        total = total + np.bitwise_count(tile[at[:, None] + np.arange(4)]).sum(-1)
    return total.astype(np.int64)


def _bits(words):
    """(rows, 8) words as (rows, 256) {0, 1} float32."""
    return np.unpackbits(np.ascontiguousarray(words).view(np.uint8),
                         axis=-1).astype(np.float32)


def and_product(a, b, kc):
    """One m64nNk256 .and.popc sub-step kc of every row of a against every
    row of b (logical words): popc(a & b) summed over its 256 bits, as the
    product of the bits (exact in float32: at most 256)."""
    s = slice(8 * kc, 8 * kc + 8)
    return (_bits(a[:, s]) @ _bits(b[:, s]).T).astype(np.int64)


def model(xp, wp, k=None, sign=None, nnz=None):
    """The kernel's walk: B's s from (xp, wp, k), or C's from (xp, mask=wp,
    sign, nnz); int32 (M, N)."""
    ternary = sign is not None
    m, kw = xp.shape
    n = wp.shape[1]
    vec = 16 if kw % 4 == 0 else 4
    out = np.zeros((m, n), np.int32)
    steps = -(-kw // KW_STEP)
    tid = np.arange(THREADS)
    for m0 in range(0, m, BM):
        for n0 in range(0, n, BN):
            acc = np.zeros((2 if ternary else 1, BM, BN), np.int64)
            part = np.zeros(THREADS, np.int64)
            for step in range(steps):
                k0 = step * KW_STEP
                tx = stage_x(xp, m0, k0, vec)
                tw = [stage_w(wp, n0, k0)]
                if ternary:
                    tw.append(tw[0] & stage_w(sign, n0, k0))
                a = logical_rows(tx)
                for kc in range(min(K256, (kw - k0 + 7) // 8)):
                    for p, t in enumerate(tw):
                        acc[p] += and_product(a, logical_rows(t), kc)
                if ternary:
                    part += row_popc(tw[1], tid % BN, tid // BN * 4, 4)
                else:
                    part += np.where(tid < BM, row_popc(tx, tid % BM, 0, 8),
                                     row_popc(tw[0], tid % BM, 0, 8))
            cols = n0 + np.arange(BN)
            if ternary:
                base = np.where(cols < n, nnz[np.minimum(cols, n - 1)], 0)
                col_base = base - 2 * (part[:BN] + part[BN:])
                s = col_base[None, :] + 4 * acc[1] - 2 * acc[0]
            else:
                row_base = k - 2 * part[:BM]
                s = row_base[:, None] - 2 * part[BM:][None, :] + 4 * acc[0]
            s = (s & 0xFFFFFFFF).astype(np.uint32).view(np.int32)  # wraps as the kernel's
            out[m0:m0 + BM, n0:n0 + BN] = s[:min(BM, m - m0), :min(BN, n - n0)]
    return out


def _binary(m, k, n, seed, x_fill=None, w_fill=None):
    rng = np.random.default_rng(seed)
    x = np.where(rng.random((m, k)) < 0.5, 1.0, -1.0).astype(np.float32)
    w = np.where(rng.random((k, n)) < 0.5, 1.0, -1.0).astype(np.float32)
    if x_fill is not None:
        x[:] = x_fill
    if w_fill is not None:
        w[:] = w_fill
    return x, w, pack_bits_np(x, -1), pack_bits_np(w, 0)


def _ternary(m, k, n, seed):
    """±1 x, {-1, 0, +1} weights about a third zero (column 0 all zero), and
    nnz off the mask's count; sign bits also outside the mask."""
    rng = np.random.default_rng(seed)
    x = np.where(rng.random((m, k)) < 0.5, 1.0, -1.0).astype(np.float32)
    w = rng.choice(np.array([-1.0, 0.0, 1.0], np.float32), (k, n))
    w[:, 0] = 0.0
    mask, sign, nnz = pack_ternary_np(w, axis=0)
    noise = rng.integers(-2**31, 2**31, sign.shape, dtype=np.int64).astype(np.uint32)
    sign = (sign.view(np.uint32) | (noise & ~mask.view(np.uint32))).view(np.int32)
    nnz = nnz + rng.integers(-7, 8, n).astype(np.int32)
    return x, w, pack_bits_np(x, -1), mask, sign, nnz


# (m, k, n): the popcount GEMM tests' shapes, then Kw = 2, 3, 8, 9 and 128
# (k = 32 Kw and 32 Kw - 5), N = 1, 10, 33, 130 and M past a block
SHAPES = [(8, 64, 32), (7, 100, 10), (5, 100, 1), (3, 100, 33), (16, 256, 10),
          (130, 96, 48), (3, 64, 1), (37, 91, 10), (9, 251, 33), (6, 256, 130),
          (140, 283, 10), (4, 288, 33), (5, 4091, 33), (3, 4096, 10)]
IDS = [f"m{m}k{k}n{n}" for m, k, n in SHAPES]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("m,k,n", SHAPES, ids=IDS)
def test_binary_walk_matches_jax(m, k, n):
    x, w, xp, wp = _binary(m, k, n, m * 1000 + k + n)
    want = np.asarray(jax_xnor_gemm_popcount(jnp.asarray(xp), jnp.asarray(wp), k))
    np.testing.assert_array_equal(model(xp, wp, k), want)
    np.testing.assert_array_equal(xnor_gemm_popcount(*_t(xp, wp), k).numpy(), want)
    np.testing.assert_array_equal(want, (x @ w).astype(np.int32))


@pytest.mark.parametrize("m,k,n", SHAPES, ids=IDS)
def test_ternary_walk_matches_jax(m, k, n):
    x, w, xp, mask, sign, nnz = _ternary(m, k, n, m * 1000 + k + n + 7)
    want = np.asarray(jax_ternary_gemm(*map(jnp.asarray, (xp, mask, sign, nnz))))
    np.testing.assert_array_equal(model(xp, mask, sign=sign, nnz=nnz), want)
    np.testing.assert_array_equal(ternary_gemm(*_t(xp, mask, sign, nnz)).numpy(), want)
    count = (w != 0).sum(0).astype(np.int32)
    np.testing.assert_array_equal(want, (x @ w).astype(np.int32) + nnz - count)


@pytest.mark.parametrize("x_fill,w_fill,sign", [(1, 1, 1), (-1, -1, 1), (1, -1, -1),
                                                (-1, 1, -1)])
@pytest.mark.parametrize("k", [64, 251, 4091])
def test_all_ones_and_all_zero_words(x_fill, w_fill, sign, k):
    """All-ones and all-zero words (pad bits 0): s = +-k everywhere."""
    _, _, xp, wp = _binary(5, k, 33, k, x_fill, w_fill)
    want = np.asarray(jax_xnor_gemm_popcount(jnp.asarray(xp), jnp.asarray(wp), k))
    assert (want == sign * k).all()
    np.testing.assert_array_equal(model(xp, wp, k), want)


def test_both_activation_copy_widths_stage_the_same_tile():
    """16-byte chunks (Kw % 4 == 0) and 4-byte words leave one tile, zeros
    past M and Kw included."""
    _, _, xp, _ = _binary(130, 4 * 32 * 5, 3, 0)  # Kw = 20: a partial step
    for m0, k0 in ((0, 0), (128, 0), (0, 32)):
        np.testing.assert_array_equal(stage_x(xp, m0, k0, 16), stage_x(xp, m0, k0, 4))


def test_staged_tiles_read_back_as_the_operands():
    """Through the swizzle the tiles hold x's rows and w's columns, K-major,
    zero past the edges: what the kernel's copies and wgmma's reads agree on."""
    _, _, xp, wp = _binary(70, 32 * 40, 50, 1)  # Kw 40: a second, partial step
    for k0 in (0, 32):
        a = logical_rows(stage_x(xp, 0, k0, 16))
        b = logical_rows(stage_w(wp, 0, k0))
        live = min(32, 40 - k0)
        np.testing.assert_array_equal(a[:70, :live], xp[:, k0:k0 + live].view(np.uint32))
        np.testing.assert_array_equal(b[:50, :live], wp[k0:k0 + live].T.view(np.uint32))
        assert not a[70:].any() and not a[:, live:].any()
        assert not b[50:].any() and not b[:, live:].any()


@pytest.mark.parametrize("fn", ["binary", "ternary"])
def test_wrappers_refuse_and_products_past_int32(fn):
    """4 P reaches 128 Kw: Kw = 2^24 words is refused before any launch, on
    any device; one word fewer passes to the device check (meta tensors:
    no memory)."""
    def call(kw):
        x = torch.empty((1, kw), dtype=torch.int32, device="meta")
        w = torch.empty((kw, 1), dtype=torch.int32, device="meta")
        if fn == "binary":
            return xnor_gemm_popcount(x, w, 32 * kw)
        return ternary_gemm(x, w, w, torch.empty(1, dtype=torch.int32, device="meta"))

    with pytest.raises(ValueError, match="does not fit the kernel's int32 sums"):
        call(2**24)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        call(2**24 - 1)
