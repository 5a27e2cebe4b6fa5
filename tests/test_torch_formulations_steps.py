"""F1 and F2 on the single-bit tensor cores (``gemm_outer`` and
``gemm_outer_acc``; ``qnx_torch/kernels/csrc/gemm_formulations.cu``, F2
through ``popcount_gemm.cuh``'s mainloop): a numpy model of each kernel's
walk held equal, exactly in int32, to the JAX kernel bodies
``experiments/gemm_shootout.py:_outer_kernel`` and ``_outer_acc_kernel``
run on numpy refs, and to the port's wrappers on CPU tensors (their plain
version).

F1's model: x padded to Kw rounded up to 4 words as the wrapper pads it
(``tma_rows``); the block's whole (bm, Kw) x strip as TMA boxes of 32 words
x 128 rows, one per K tile and filled 128-row sub-strip, in the 128-byte
swizzle, the sub-strips past M left unwritten (a sentinel); the (Kw, bn)
weight strip by B's word transpose; all of K's live k256 AND products in
one product; rx and cw from the staged strips; the bytes that layout takes
against ``outer_smem_bytes`` and the 232,448 a block may have.  F2's model:
kernel B's staged walk at K steps of ``bk`` = 16 or 8 words, 64- or
32-byte rows in the swizzle of that width, one AND product a live k256,
``bn`` columns a block, and its ring's schedule.  Both end in ``k - 2 (rx
+ cw) + 4 P`` in wrapping 32-bit arithmetic, over every block and step at
once (the helpers of ``test_torch_formulations_tc``).  The CUDA kernels
themselves are held against the plain version on the card by
``chip_smoke.py``."""
import functools
import types

import numpy as np
import pytest
import torch

from qnx_torch.kernels import gemm_formulations as G
from qnx_torch.ops.packing import pack_bits_np
from test_torch_formulations_tc import (BM, KW_STEP, PHASE_SHIFT, SHAPES, THREADS,
                                        _body, _case, _load, and_popc, cdiv, epilogue,
                                        live_k256, read_rows, ring_schedule,
                                        stage_w_all, staged_model, step_products,
                                        tile_popc, tma_boxes, whole, word_addr)

torch.set_num_threads(2)

IDS = [f"m{m}k{k}n{n}" for m, (k, n) in SHAPES]
SHOOTOUT = _load("gemm_shootout")
# a copy of the module whose ``pl`` is a stand-in that drives
# ``_outer_acc_kernel`` over its K grid outside Pallas
OUTER_ACC = _load("gemm_shootout")
GRID = [0, 0, 0]
OUTER_ACC.pl = types.SimpleNamespace(
    program_id=lambda axis: GRID[axis],
    when=lambda cond: (lambda body: body() if cond else None))
SENTINEL = 0xA5A5A5A5  # shared memory no fill writes
OUTER_IDS = [f"outer-{bm}x{bn}" for bm, bn in G.OUTER_GEOMETRIES]
OUTER_ACC_IDS = [G.outer_acc_name(*g) for g in G.OUTER_ACC_GEOMETRIES]


def outer_model(xp, wp, k, bm, bn):
    """F1's walk, or :class:`G.DoesNotFit` where its strips and terms take
    more shared memory than a block may have."""
    m, kw = xp.shape
    n = wp.shape[1]
    kw4 = -(-kw // 4) * 4
    tiles = cdiv(kw, KW_STEP)
    # the block's layout: 1024 bytes of alignment, the x strip [tiles][bm
    # rows][128 bytes], the w strip [tiles][bn][128 bytes], the barrier,
    # the row and column terms
    need = 1024 + 4 * KW_STEP * tiles * (bm + bn) + 8 + 4 * (bm + bn)
    assert need == G.outer_smem_bytes(bm, bn, kw)
    if need > G.SMEM_LIMIT:
        raise G.DoesNotFit(f"{bm}x{bn} at Kw={kw}: {need} bytes")
    # x: a box a K tile and filled 128-row sub-strip (rows below M); the
    # block's other sub-strips are never written
    boxes = tma_boxes(np.pad(xp, ((0, 0), (0, kw4 - kw))), BM)
    sub = cdiv(m, bm) * bm // BM  # sub-strips of every block
    strip = np.full((sub, tiles, BM * KW_STEP), SENTINEL, np.uint32)
    strip[:boxes.shape[0], :boxes.shape[1]] = boxes
    assert boxes.shape[1] == tiles
    filled = np.arange(sub) * BM < m
    ws = stage_w_all(wp, bn)  # (column blocks, tiles, bn 32)
    # every live k256 of all of K in one product (exact in float32: at most
    # 32 Kw bits), the sub-tiles' columns side by side
    a = whole(read_rows(strip, BM)).reshape(sub * BM, -1)
    b = whole(read_rows(ws, bn)).reshape(ws.shape[0] * bn, -1)
    live = live_k256(kw, tiles).reshape(-1)
    p = and_popc(a * live, b * live)
    # the terms of the filled rows and of every column, from the strips
    rx = np.where(np.repeat(filled, BM), tile_popc(strip, BM).sum(1).reshape(-1), 0)
    cw = tile_popc(ws, bn).sum(1).reshape(-1)
    return epilogue(k, rx, cw, p, m, n)


def outer_acc_model(xp, wp, k, bn, bk, stages):
    """F2's walk: kernel B's staged fill and product at K steps of ``bk``
    words, ``bn`` columns a block, one fragment set; the ring of
    ``stages`` replayed by :func:`ring_schedule`."""
    ring_schedule(cdiv(xp.shape[1], bk), stages, 1, tma=False)
    return staged_model(xp, wp, k, bn, 1, bk)


@functools.lru_cache(maxsize=None)
def _jax_outer(m, k, n):
    xp, wp = _case(m, k, n)
    return _body(SHOOTOUT._outer_kernel, xp, wp, m, n, k=k, kw=xp.shape[1])


@functools.lru_cache(maxsize=None)
def _jax_outer_acc(m, k, n, bk):
    """``_outer_acc_kernel`` over its K grid of ``bk``-word blocks (``bk``
    capped at Kw, as ``v_outer_acc`` caps it), the last block's words past
    Kw zero (pad words: their XOR is 0)."""
    xp, wp = _case(m, k, n)
    kw = xp.shape[1]
    bk = min(bk, kw)
    steps = cdiv(kw, bk)
    x = np.pad(xp, ((0, 0), (0, steps * bk - kw)))
    w = np.pad(wp, ((0, steps * bk - kw), (0, 0)))
    out = np.zeros((m, n), np.int32)
    for q in range(steps):
        GRID[2] = q
        OUTER_ACC._outer_acc_kernel(x[:, q * bk:(q + 1) * bk], w[q * bk:(q + 1) * bk],
                                    out, k=k, bk=bk)
    return out


@pytest.mark.parametrize("geometry", G.OUTER_GEOMETRIES, ids=OUTER_IDS)
@pytest.mark.parametrize("m,kn", SHAPES, ids=IDS)
def test_outer_walk_matches_jax(m, kn, geometry):
    k, n = kn
    xp, wp = _case(m, k, n)
    x, w = torch.from_numpy(xp), torch.from_numpy(wp)
    if G.outer_smem_bytes(*geometry, xp.shape[1]) > G.SMEM_LIMIT:
        for call in (lambda: outer_model(xp, wp, k, *geometry),
                     lambda: G.gemm_outer(x, w, k, *geometry)):
            with pytest.raises(G.DoesNotFit):
                call()
        return
    want = _jax_outer(m, k, n)
    np.testing.assert_array_equal(outer_model(xp, wp, k, *geometry), want)
    np.testing.assert_array_equal(G.gemm_outer(x, w, k, *geometry).numpy(), want)


@pytest.mark.parametrize("geometry", G.OUTER_ACC_GEOMETRIES, ids=OUTER_ACC_IDS)
@pytest.mark.parametrize("m,kn", SHAPES, ids=IDS)
def test_outer_acc_walk_matches_jax(m, kn, geometry):
    k, n = kn
    xp, wp = _case(m, k, n)
    want = _jax_outer_acc(m, k, n, geometry[1])
    np.testing.assert_array_equal(outer_acc_model(xp, wp, k, *geometry), want)
    np.testing.assert_array_equal(
        G.gemm_outer_acc(torch.from_numpy(xp), torch.from_numpy(wp), k, *geometry).numpy(),
        want)


@pytest.mark.parametrize("x_fill,w_fill,sign", [(1, 1, 1), (-1, -1, 1), (1, -1, -1),
                                                (-1, 1, -1)])
@pytest.mark.parametrize("k", [64, 251, 4091])
def test_all_ones_and_all_zero_words(x_fill, w_fill, sign, k):
    """All-ones and all-zero words (pad bits 0): s = +-k everywhere, on
    every geometry of both walks that fits."""
    xp = pack_bits_np(np.full((5, k), x_fill, np.float32), -1)
    wp = pack_bits_np(np.full((k, 33), w_fill, np.float32), 0)
    want = np.full((5, 33), sign * k, np.int32)
    for bm, bn in G.OUTER_GEOMETRIES:
        if G.outer_smem_bytes(bm, bn, xp.shape[1]) <= G.SMEM_LIMIT:
            np.testing.assert_array_equal(outer_model(xp, wp, k, bm, bn), want)
    for g in G.OUTER_ACC_GEOMETRIES:
        np.testing.assert_array_equal(outer_acc_model(xp, wp, k, *g), want)


@pytest.mark.parametrize("step_w", [32, 16, 8])
def test_swizzles_permute_each_atom(step_w):
    """Each swizzle moves a word only within its atom (8 rows of 4 step_w
    bytes) and fills it exactly; the x copies' units land on every 16-byte
    chunk of a tile once, eight consecutive units on eight distinct bank
    groups; and the hardware's swizzle (address bits [7, 7 + log2 chunks)
    XORed into bits [4, ...)) is the model's."""
    row_bytes = 4 * step_w
    r, i = np.arange(8)[:, None], np.arange(step_w)[None, :]
    for atom in range(4):
        words = word_addr(r + 8 * atom, i, step_w).reshape(-1) // 4
        assert sorted(words) == list(range(atom * 8 * step_w, (atom + 1) * 8 * step_w))
    rows = np.arange(BM)[:, None]
    logical = rows * row_bytes + 4 * i
    chunks = row_bytes // 16
    hw = logical ^ (((logical >> 7) & (chunks - 1)) << 4)
    np.testing.assert_array_equal(word_addr(rows, i, step_w), hw)
    assert PHASE_SHIFT[step_w] == {8: 0, 4: 1, 2: 2}[chunks]
    u = np.arange(BM * chunks)
    row = u // (8 * chunks) * 8 + (u & 7)
    at = word_addr(row, 4 * ((u >> 3) % chunks), step_w)
    assert sorted(at) == list(range(0, BM * row_bytes, 16))
    assert all(len(set(g)) == 8 for g in at.reshape(-1, 8) % 128)


@pytest.mark.parametrize("geometry", G.OUTER_GEOMETRIES, ids=OUTER_IDS)
def test_does_not_fit_exactly_past_the_block_s_shared_memory(geometry):
    """gemm_outer raises :class:`G.DoesNotFit`, before any launch and on any
    device, exactly where its layout takes more than 232,448 bytes."""
    bm, bn = geometry
    fits = []
    for kw in range(1, 257):
        x = torch.empty((2, kw), dtype=torch.int32, device="meta")
        w = torch.empty((kw, 3), dtype=torch.int32, device="meta")
        need = 1024 + (bm + bn) * 128 * cdiv(kw, 32) + 8 + 4 * (bm + bn)
        assert G.outer_smem_bytes(bm, bn, kw) == need
        if need > G.SMEM_LIMIT:
            with pytest.raises(G.DoesNotFit, match="shared memory"):
                G.gemm_outer(x, w, 32 * kw, bm, bn)
        else:
            fits.append(kw)
            with pytest.raises(ValueError, match="no kernel for device meta"):
                G.gemm_outer(x, w, 32 * kw, bm, bn)
    assert fits == list(range(1, len(fits) + 1))  # a prefix of Kw: 32 a tile
    assert len(fits) % 32 == 0


@pytest.mark.parametrize("steps", [1, 2, 5, 16])
def test_the_ring_never_refills_a_stage_in_use(steps):
    """F2's rings: a stage is refilled only once the wgmma group that read
    it is done; two blocks a SM fit, and (128, 16, 6) and (128, 8, 12) hold
    kernel B's 96 words of tiles."""
    for bn, bk, stages in G.OUTER_ACC_GEOMETRIES:
        ring_schedule(steps * 32 // bk, stages, 1, tma=False)
        ring = stages * (BM + bn) * 4 * bk
        assert 2 * (1024 + ring + 4 * (THREADS + bn + BM) + 1024) <= 233472
    assert {bk * st for bn, bk, st in G.OUTER_ACC_GEOMETRIES if bn == 128} >= {96}
    with pytest.raises(AssertionError):  # copies a step further ahead
        ring_schedule(steps + 3, 3, 1, tma=False, ahead=2)


def test_products_skip_only_the_sub_steps_past_kw():
    """A K step issues the k256 that hold words below Kw: at Kw = 9 one
    32-word step issues two, one 16-word step two, each of two 8-word
    steps one."""
    np.testing.assert_array_equal(live_k256(9, 1, 32)[0], np.arange(32) < 16)
    np.testing.assert_array_equal(live_k256(9, 2, 8).sum(1), [8, 8])
    np.testing.assert_array_equal(live_k256(9, 1, 16).sum(1), [16])
    a = np.full((3, 2, 8), 0xFFFFFFFF, np.uint32)
    assert [int(p[0, 0]) for p in step_products(a, a, live_k256(9, 2, 8))] == [256, 256]
