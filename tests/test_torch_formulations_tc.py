"""F4 and G on the single-bit tensor cores (``gemm_lanered`` and
``xnor_multiacc``; ``qnx_torch/kernels/csrc/popcount_gemm.cuh`` through
``gemm_formulations.cu``): a numpy model of each kernel's tile walk held
equal, exactly in int32, to the JAX kernel bodies
``experiments/gemm_shootout.py:_lanered_kernel`` and
``experiments/xnor_sol_variants.py:_kernel_multiacc`` run on numpy refs, and
to the port's wrappers on CPU tensors (their plain version).

F4's model: the operands padded to Kw rounded up to 4 words as the wrapper
pads them (``tma_operands``); each K step two TMA boxes of 32 words, one of
x's 128 rows and one of wt's ``bn`` rows, written in the 128-byte swizzle
(16-byte chunk c of box row r at chunk c ^ (r % 8)), zeros past the
tensors' edges; the k256 AND-popcount sub-steps that hold words; rx and cw
from the staged tiles.  G's model: x copied as kernel B copies it and the
(Kw, N) weights staged by B's word transpose (``test_torch_popcount_and``'s
model of B, whose staging and swizzle these helpers vectorize), ``bn``
columns a block; K step i accumulated into fragment set i % nacc, the sets
summed at the end.  Both end in ``k - 2 (rx + cw) + 4 P`` in wrapping 32-bit
arithmetic.  The models work on every block and K step at once: the tiles
of all blocks are staged, read back through the swizzle and multiplied as
whole operands, a K step's AND products one matmul of the unpacked bits.
The helpers take the step width (32 words; F2's 16 and 8 in
``test_torch_formulations_steps``).  A model of the ring's schedule checks
that no stage is refilled while a wgmma group still reads it.  The CUDA
kernels themselves are held against the plain version on the card by
``chip_smoke.py``."""
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from qnx_torch.experiments.gemm_shootout import random_words
from qnx_torch.kernels import gemm_formulations as G
from qnx_torch.ops.packing import pack_bits_np
from test_torch_popcount_and import BM, KW_STEP, THREADS, logical_rows, stage_w, stage_x

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def _load(name: str):
    """An experiment module of the JAX package, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        f"jax_experiment_tc_{name}", ROOT / "experiments" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SHOOTOUT = _load("gemm_shootout")
SOL = _load("xnor_sol_variants")

# (M, (K, N)): chip_smoke.py's RAGGED_SHAPES (ragged M and K, N = 1, 10, 33,
# 128, the MNIST head, the scan shape), then Kw = 2, 3, 9, 17 and 128 with
# N = 1, 10, 33 and 130
SHAPES = [(3, (100, 1)), (37, (153, 10)), (130, (1000, 33)), (257, (4000, 128)),
          (256, (4096, 10)), (1024, (4096, 4096)),
          (5, (64, 1)), (37, (91, 10)), (130, (283, 33)), (9, (540, 130)),
          (3, (4096, 130))]
IDS = [f"m{m}k{k}n{n}" for m, (k, n) in SHAPES]

# rows of a swizzle phase (the chunk index a row XORs in) as log2, by words
# of a tile row: the 128-, 64- and 32-byte swizzles
PHASE_SHIFT = {32: 0, 16: 1, 8: 2}


def cdiv(a, b):
    return -(-a // b)


def word_addr(r, i, step_w=KW_STEP):
    """Byte offset of word i of row r of a swizzled tile of ``step_w``-word
    rows (popcount_gemm.cuh ``word_at``): 16-byte chunk i // 4 at chunk
    (i // 4) ^ ((r >> shift) % chunks), CuTe's Swizzle<3|2|1, 4, 3>."""
    chunks = step_w // 4
    phase = (r >> PHASE_SHIFT[step_w]) & (chunks - 1)
    return r * 4 * step_w + (((i >> 2) ^ phase) << 4) + ((i & 3) << 2)


def stage_x_all(xp, vec, step_w=KW_STEP):
    """Every row block's x tile at every K step as kernel B's copies leave it
    (``copy_unit_at``: unit u is chunk (u / 8) % chunks of row (u / (8
    chunks)) 8 + u % 8), zeros past M and Kw: (row blocks, steps, 128
    step_w) uint32.  ``vec`` 16: one copy a 16-byte chunk (Kw % 4 == 0),
    4: a copy a word."""
    m, kw = xp.shape
    chunks = step_w // 4
    u = np.arange(BM * chunks)
    row = u // (8 * chunks) * 8 + (u & 7)
    ch = (u >> 3) % chunks
    dst = word_addr(row, 4 * ch, step_w) // 4
    mrow = (np.arange(cdiv(m, BM))[:, None] * BM + row)[:, None, :]
    k0 = (np.arange(cdiv(kw, step_w))[:, None] * step_w + 4 * ch)[None]
    tiles = np.zeros((mrow.shape[0], k0.shape[1], BM * step_w), np.uint32)
    for j in range(4):  # the words of a copy unit
        word = k0 + j
        valid = (mrow < m) & ((k0 < kw) if vec == 16 else (word < kw))
        src = xp.view(np.uint32)[np.minimum(mrow, m - 1), np.minimum(word, kw - 1)]
        tiles[:, :, dst + j] = np.where(valid, src, 0)
    return tiles


def stage_w_all(wp, bn, step_w=KW_STEP):
    """Every column block's weight tile at every K step as B's word
    transpose leaves it: thread t copies column t % bn, words t // bn +
    (256 / bn) j, word i of column c to ``word_addr(c, i)``; zeros past N
    and Kw: (column blocks, steps, bn step_w) uint32."""
    kw, n = wp.shape
    t = np.arange(THREADS)[:, None]
    c = t % bn
    i = t // bn + THREADS // bn * np.arange(bn * step_w // THREADS)[None, :]
    col = (np.arange(cdiv(n, bn))[:, None, None] * bn + c)[:, None]
    kword = (np.arange(cdiv(kw, step_w))[:, None, None] * step_w + i)[None]
    valid = (col < n) & (kword < kw)
    src = wp.view(np.uint32)[np.minimum(kword, kw - 1), np.minimum(col, n - 1)]
    tiles = np.zeros((col.shape[0], kword.shape[1], bn * step_w), np.uint32)
    tiles[:, :, word_addr(c, i, step_w) // 4] = np.where(valid, src, 0)
    return tiles


def tma_boxes(mat, rows):
    """Every TMA box of 32 words x ``rows`` rows of the K-major word matrix
    ``mat``, (row blocks, steps, rows 32), as the Tensor Memory Accelerator
    writes it (CU_TENSOR_MAP_SWIZZLE_128B): zeros outside ``mat``, 16-byte
    chunk c of box row r at chunk c ^ (r % 8)."""
    n_rows, kw = mat.shape
    nb, steps = cdiv(n_rows, rows), cdiv(kw, KW_STEP)
    padded = np.zeros((nb * rows, steps * KW_STEP), np.uint32)
    padded[:n_rows, :kw] = mat.view(np.uint32)
    boxes = padded.reshape(nb, rows, steps, KW_STEP).transpose(0, 2, 1, 3)
    tiles = np.zeros((nb, steps, rows * KW_STEP), np.uint32)
    r, i = np.arange(rows)[:, None], np.arange(KW_STEP)[None, :]
    tiles[:, :, word_addr(r, i) // 4] = boxes
    return tiles


def read_rows(tiles, rows, step_w=KW_STEP):
    """(..., rows, step_w) words of swizzled tiles as wgmma reads them."""
    r, i = np.arange(rows)[:, None], np.arange(step_w)[None, :]
    return tiles[..., word_addr(r, i, step_w) // 4]


def tile_popc(tiles, rows, step_w=KW_STEP):
    """Each tile row's popcount, (..., rows), read as ``row_popc`` reads it:
    its 16-byte chunks at their swizzled places."""
    c = np.arange(step_w // 4)[None, :]
    at = word_addr(np.arange(rows)[:, None], 4 * c, step_w) // 4
    words = tiles[..., at[..., None] + np.arange(4)]
    return np.bitwise_count(words).sum((-1, -2)).astype(np.int64)


def whole(blocks):
    """(blocks, steps, rows, step_w) tile words as one (blocks rows, steps,
    step_w) operand."""
    nb, steps, rows, step_w = blocks.shape
    return blocks.transpose(0, 2, 1, 3).reshape(nb * rows, steps, step_w)


def live_k256(kw, steps, step_w=KW_STEP):
    """(steps, step_w) True on the words of the k256 sub-steps a K step
    issues: those that hold words below ``kw``."""
    k256 = np.minimum(step_w // 8, (kw - np.arange(steps) * step_w + 7) // 8)
    return np.arange(step_w)[None, :] // 8 < k256[:, None]


def _bits(words):
    """(rows, w) words as (rows, 32 w) {0, 1} float32 torch tensor."""
    return torch.from_numpy(np.unpackbits(np.ascontiguousarray(words).view(np.uint8),
                                          axis=-1).astype(np.float32))


def and_popc(a, b):
    """popc(a_i & b_j) summed over the words of every row a_i of ``a`` and
    b_j of ``b``, as int32 (rows_a, rows_b): a matmul of the unpacked bits,
    exact in float32 for up to 2^24 bits (on torch's two threads)."""
    return (_bits(a) @ _bits(b).T).numpy().astype(np.int32)


def step_products(a, b, live):
    """Each K step's AND-popcount product of every row of ``a`` against every
    row of ``b`` (operands (rows, steps, step_w) words) over the live k256
    sub-steps, as int32 (steps, rows_a, rows_b): one matmul of the unpacked
    bits a step."""
    for s in range(a.shape[1]):
        yield and_popc(a[:, s] * live[s], b[:, s] * live[s])


def epilogue(k, rx, cw, p, m, n):
    """k - 2 (rx + cw) + 4 P of every block at once, wrapping as the
    kernels' unsigned sums, cropped to (m, n)."""
    s = (k - 2 * rx)[:, None] - 2 * cw[None, :] + 4 * p.astype(np.int64)
    return (s & 0xFFFFFFFF).astype(np.uint32).view(np.int32)[:m, :n]


def staged_model(xp, wp, k, bn, nacc=1, step_w=KW_STEP):
    """B's staged walk (G, and F2 at narrower steps): x by B's copies, the
    weights by its word transpose, ``bn`` columns a block, K steps of
    ``step_w`` words; K step i into fragment set i % nacc, the sets summed
    before the epilogue."""
    m, kw = xp.shape
    n = wp.shape[1]
    tx = stage_x_all(xp, 16 if kw % 4 == 0 else 4, step_w)
    tw = stage_w_all(wp, bn, step_w)
    a = whole(read_rows(tx, BM, step_w))
    b = whole(read_rows(tw, bn, step_w))
    sets = np.zeros((nacc, a.shape[0], b.shape[0]), np.int32)
    for step, prod in enumerate(step_products(a, b, live_k256(kw, a.shape[1], step_w))):
        sets[step % nacc] += prod
    rx = tile_popc(tx, BM, step_w).sum(1).reshape(-1)
    cw = tile_popc(tw, bn, step_w).sum(1).reshape(-1)
    return epilogue(k, rx, cw, sets.sum(0), m, n)


def lanered_model(xp, wpt, k, bn):
    """F4's walk: the operands padded as ``tma_operands`` pads them, both
    tiles TMA boxes; one fragment set."""
    m, kw = xp.shape
    n = wpt.shape[0]
    kw4 = -(-kw // 4) * 4
    tx, tw = (tma_boxes(np.pad(t, ((0, 0), (0, kw4 - kw))), rows)
              for t, rows in ((xp, BM), (wpt, bn)))
    a, b = whole(read_rows(tx, BM)), whole(read_rows(tw, bn))
    p = sum(step_products(a, b, live_k256(kw4, a.shape[1])))
    rx, cw = tile_popc(tx, BM).sum(1).reshape(-1), tile_popc(tw, bn).sum(1).reshape(-1)
    return epilogue(k, rx, cw, p, m, n)


def multiacc_model(xp, wp, k, nacc):
    """G's walk: B's staged fill at the tiling of ``nacc``; K step i into
    fragment set i % nacc; the sets summed before the epilogue."""
    return staged_model(xp, wp, k, G.MULTIACC_TILING[nacc][0], nacc)


@functools.lru_cache(maxsize=None)
def _case(m, k, n):
    rng = np.random.default_rng(m * 1000 + k + n)
    xp = random_words(rng, m, k)
    wp = random_words(rng, n, k, along_rows=True)
    return xp, wp


def _body(kernel, x, w, m, n, **kw):
    """A Pallas kernel body run on numpy refs."""
    out = np.zeros((m, n), np.int32)
    kernel(x, w, out, **kw)
    return out


@functools.lru_cache(maxsize=None)
def _jax_lanered(m, k, n):
    xp, wp = _case(m, k, n)
    return _body(SHOOTOUT._lanered_kernel, xp, np.ascontiguousarray(wp.T), m, n, k=k, bn=n)


@functools.lru_cache(maxsize=None)
def _jax_multiacc(m, k, n, nacc):
    xp, wp = _case(m, k, n)
    return _body(SOL._kernel_multiacc, xp, wp, m, n, k=k, kw=xp.shape[1], nacc=nacc)


@pytest.mark.parametrize("geometry", G.LANERED_GEOMETRIES,
                         ids=[G.lanered_name(*g) for g in G.LANERED_GEOMETRIES])
@pytest.mark.parametrize("m,kn", SHAPES, ids=IDS)
def test_lanered_walk_matches_jax(m, kn, geometry):
    k, n = kn
    xp, wp = _case(m, k, n)
    wpt = np.ascontiguousarray(wp.T)
    want = _jax_lanered(m, k, n)
    np.testing.assert_array_equal(lanered_model(xp, wpt, k, geometry[0]), want)
    got = G.gemm_lanered(torch.from_numpy(xp), torch.from_numpy(wpt), k, *geometry)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("nacc", G.NACCS)
@pytest.mark.parametrize("m,kn", SHAPES, ids=IDS)
def test_multiacc_walk_matches_jax(m, kn, nacc):
    k, n = kn
    xp, wp = _case(m, k, n)
    want = _jax_multiacc(m, k, n, nacc)
    np.testing.assert_array_equal(multiacc_model(xp, wp, k, nacc), want)
    got = G.xnor_multiacc(torch.from_numpy(xp), torch.from_numpy(wp), k, nacc=nacc)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kw", [2, 3, 9, 17, 128])
def test_tma_boxes_read_back_as_the_padded_operands(kw):
    """Through the swizzle a box holds its rows' 32 words K-major, zero past
    the padded Kw and past the last row; the padding appends zero words."""
    rng = np.random.default_rng(kw)
    xp = random_words(rng, 70, 32 * kw - 3)
    x4, _ = G.tma_operands(torch.from_numpy(xp), torch.from_numpy(xp[:5]))
    x4 = x4.numpy()
    assert x4.shape == (70, -(-kw // 4) * 4)
    np.testing.assert_array_equal(x4[:, :kw], xp)
    assert not x4[:, kw:].any()
    for rows in (128, 64):
        a = read_rows(tma_boxes(x4, rows), rows)  # (row blocks, steps, rows, 32)
        back = a.transpose(0, 2, 1, 3).reshape(a.shape[0] * rows, -1)
        np.testing.assert_array_equal(back[:70, :x4.shape[1]], x4.view(np.uint32))
        assert not back[70:].any() and not back[:, x4.shape[1]:].any()


def test_vectorized_staging_is_kernel_b_s_tile_by_tile():
    """The whole-operand staging leaves, block by block and step by step,
    the tiles of ``test_torch_popcount_and``'s model of B's copies."""
    rng = np.random.default_rng(3)
    xp = random_words(rng, 140, 32 * 40)  # Kw 40: a second, partial step
    wp = random_words(rng, 200, 32 * 40 - 7, along_rows=True)
    for vec in (16, 4):
        tx = stage_x_all(xp, vec)
        for mb in range(2):
            for st in range(2):
                np.testing.assert_array_equal(tx[mb, st], stage_x(xp, mb * BM, st * KW_STEP, vec))
    for bn in (128, 64):
        tw = stage_w_all(wp, bn)
        for nb in range(tw.shape[0]):
            for st in range(2):
                np.testing.assert_array_equal(tw[nb, st], stage_w(wp, nb * bn, st * KW_STEP, bn))
    np.testing.assert_array_equal(read_rows(tx[0, 0], BM), logical_rows(tx[0, 0]))


def test_tma_operands_copy_only_what_the_boxes_cannot_take():
    """Kw % 4 == 0 at an aligned address: the operands themselves; else a
    zero-padded copy (a misaligned view too), whose product is unchanged."""
    xp, wp = _case(37, 256, 10)  # Kw = 8
    x, wt = torch.from_numpy(xp), torch.from_numpy(np.ascontiguousarray(wp.T))
    x4, w4 = G.tma_operands(x, wt)
    assert x4 is x and w4 is wt
    flat = torch.zeros(38 * 8 + 1, dtype=torch.int32)[1:].view(38, 8)  # 4 bytes on
    assert flat.data_ptr() % 16 and flat.is_contiguous()
    f4, _ = G.tma_operands(flat, wt)
    assert f4 is not flat and f4.data_ptr() % 16 == 0 and torch.equal(f4, flat)
    xo, wo = _case(37, 153, 10)  # Kw = 5: padded to 8
    x5, w5 = G.tma_operands(torch.from_numpy(xo), torch.from_numpy(np.ascontiguousarray(wo.T)))
    assert x5.shape == (37, 8) and w5.shape == (10, 8)
    want = G.xnor_gemm_popcount_ref(torch.from_numpy(xo), torch.from_numpy(wo), 153)
    assert torch.equal(G.xnor_gemm_popcount_ref(x5, w5.t().contiguous(), 153), want)


def ring_schedule(steps, stages, nacc, tma, ahead=None):
    """Replay one block's schedule of copies and wgmma groups, asserting
    that a stage is refilled only once the group that read it is done and
    (TMA) that each wait reads its stage's current parity.  The copies run
    ``stages - 1 - nacc`` steps ahead, as the kernel's (or ``ahead``).
    Returns the steps whose tiles each stage held, in order."""
    ahead = stages - 1 - nacc if ahead is None else ahead
    assert ahead >= 1
    held = {s: [] for s in range(stages)}
    done = -1          # every group up to this step has completed
    landed = {}        # stage -> completions of its barrier
    issued = 0

    def issue():
        nonlocal issued
        if issued < steps:
            st = issued % stages
            if held[st]:
                assert held[st][-1] <= done, (issued, st, held[st][-1], done)
            held[st].append(issued)
            landed[st] = landed.get(st, 0) + 1
            issued += 1

    for _ in range(ahead):
        issue()
    stage, phase = 0, 0
    for step in range(steps):
        assert held[stage][-1] == step  # the tiles this step reads
        if tma:  # the wait on parity `phase` sees this use's completion
            assert (landed[stage] - 1) % 2 == phase
        stage += 1
        if stage == stages:
            stage, phase = 0, phase ^ 1
        issue()               # after the barrier: step + ahead
        done = step - nacc    # wgmma.wait_group(nacc) after the commit
    return held


@pytest.mark.parametrize("steps", [1, 2, 5, 128])
def test_the_ring_never_refills_a_stage_in_use(steps):
    for _, stages in G.LANERED_GEOMETRIES:
        ring_schedule(steps, stages, 1, tma=True)
    for nacc, (_, stages) in G.MULTIACC_TILING.items():
        ring_schedule(steps, stages, nacc, tma=False)
        assert stages >= nacc + 2
    with pytest.raises(AssertionError):  # copies one step further ahead
        ring_schedule(steps + 3, 3, 1, tma=False, ahead=2)


@pytest.mark.parametrize("x_fill,w_fill,sign", [(1, 1, 1), (-1, -1, 1), (1, -1, -1)])
@pytest.mark.parametrize("k", [64, 251, 4091])
def test_all_ones_and_all_zero_words(x_fill, w_fill, sign, k):
    """All-ones and all-zero words (pad bits 0): s = +-k everywhere, on both
    walks and both fills."""
    xp = pack_bits_np(np.full((5, k), x_fill, np.float32), -1)
    wp = pack_bits_np(np.full((k, 33), w_fill, np.float32), 0)
    want = np.full((5, 33), sign * k, np.int32)
    for bn, _ in G.LANERED_GEOMETRIES:
        np.testing.assert_array_equal(
            lanered_model(xp, np.ascontiguousarray(wp.T), k, bn), want)
    for nacc in G.NACCS:
        np.testing.assert_array_equal(multiacc_model(xp, wp, k, nacc), want)
