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
model of B, whose staging, swizzle and products this file takes), ``bn`` columns a block; K step
i accumulated into fragment set i % nacc, the sets summed at the end.  Both
end in ``k - 2 (rx + cw) + 4 P`` in wrapping 32-bit arithmetic.  A model of
the ring's schedule checks that no stage is refilled while a wgmma group
still reads it.  The CUDA kernels themselves are held against the plain
version on the card by ``chip_smoke.py``."""
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from qnx_torch.experiments.gemm_shootout import random_words
from qnx_torch.kernels import gemm_formulations as G
from qnx_torch.ops.packing import pack_bits_np
from test_torch_popcount_and import (BM, K256, KW_STEP, ROW_BYTES, THREADS,
                                     and_product, logical_rows, row_popc,
                                     stage_w, stage_x)

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


def tma_box(mat, c0, r0, rows):
    """The smem tile one TMA box of 32 words x ``rows`` rows at (c0, r0) of
    the K-major word matrix ``mat`` leaves: zeros outside it, 16-byte chunk
    c of box row r written at chunk c ^ (r % 8) (CU_TENSOR_MAP_SWIZZLE_128B)."""
    n_rows, kw = mat.shape
    box = np.zeros((rows, KW_STEP), np.uint32)
    rr, cc = min(rows, n_rows - r0), min(KW_STEP, kw - c0)
    if rr > 0 and cc > 0:
        box[:rr, :cc] = mat[r0:r0 + rr, c0:c0 + cc].view(np.uint32)
    tile = np.zeros(rows * KW_STEP, np.uint32)
    r = np.arange(rows)[:, None]
    c = np.arange(KW_STEP // 4)[None, :]
    for j in range(4):
        tile[(r * ROW_BYTES + ((c ^ (r & 7)) << 4)) // 4 + j] = box[:, 4 * c[0] + j]
    return tile


def tile_popc(tile, rows):
    """Each tile row's popcount, read as the kernel's threads read it."""
    return row_popc(tile, np.arange(rows), 0, 8)


def epilogue(k, part, acc, n_rows, bn):
    """k - 2 (rx + cw) + 4 P of a block, wrapping as the kernel's unsigned
    sums: rx from threads 0..127, cw from threads 128..128 + bn."""
    s = (k - 2 * part[:BM])[:, None] - 2 * part[BM:BM + bn][None, :] + 4 * acc
    return (s & 0xFFFFFFFF).astype(np.uint32).view(np.int32)[:n_rows]


def lanered_model(xp, wpt, k, bn):
    """F4's walk: the operands padded as ``tma_operands`` pads them, both
    tiles TMA boxes; one fragment set."""
    m, kw = xp.shape
    n = wpt.shape[0]
    kw4 = -(-kw // 4) * 4
    x4, w4 = (np.pad(t, ((0, 0), (0, kw4 - kw))) for t in (xp, wpt))
    out = np.zeros((m, n), np.int32)
    for m0 in range(0, m, BM):
        for n0 in range(0, n, bn):
            acc = np.zeros((BM, bn), np.int64)
            part = np.zeros(THREADS, np.int64)
            for k0 in range(0, kw4, KW_STEP):
                tx, tw = tma_box(x4, k0, m0, BM), tma_box(w4, k0, n0, bn)
                a, b = logical_rows(tx, BM), logical_rows(tw, bn)
                for kc in range(min(K256, (kw4 - k0 + 7) // 8)):
                    acc += and_product(a, b, kc)
                part[:BM] += tile_popc(tx, BM)
                part[BM:BM + bn] += tile_popc(tw, bn)
            s = epilogue(k, part, acc, min(BM, m - m0), bn)
            out[m0:m0 + BM, n0:n0 + bn] = s[:, :min(bn, n - n0)]
    return out


def multiacc_model(xp, wp, k, nacc):
    """G's walk: B's staged fill at the tiling of ``nacc``; K step i into
    fragment set i % nacc; the sets summed before the epilogue."""
    bn, _ = G.MULTIACC_TILING[nacc]
    m, kw = xp.shape
    n = wp.shape[1]
    out = np.zeros((m, n), np.int32)
    for m0 in range(0, m, BM):
        for n0 in range(0, n, bn):
            sets = np.zeros((nacc, BM, bn), np.int64)
            part = np.zeros(THREADS, np.int64)
            for step, k0 in enumerate(range(0, kw, KW_STEP)):
                tx = stage_x(xp, m0, k0, 16 if kw % 4 == 0 else 4)
                tw = stage_w(wp, n0, k0, bn)
                a, b = logical_rows(tx, BM), logical_rows(tw, bn)
                for kc in range(min(K256, (kw - k0 + 7) // 8)):
                    sets[step % nacc] += and_product(a, b, kc)
                part[:BM] += tile_popc(tx, BM)
                part[BM:BM + bn] += tile_popc(tw, bn)
            s = epilogue(k, part, sets.sum(0), min(BM, m - m0), bn)
            out[m0:m0 + BM, n0:n0 + bn] = s[:, :min(bn, n - n0)]
    return out


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
    for k0 in range(0, x4.shape[1], KW_STEP):
        live = min(KW_STEP, x4.shape[1] - k0)
        for rows in (128, 64):
            for r0 in range(0, 70, rows):
                a = logical_rows(tma_box(x4, k0, r0, rows), rows)
                real = min(rows, 70 - r0)
                np.testing.assert_array_equal(
                    a[:real, :live], x4[r0:r0 + real, k0:k0 + live].view(np.uint32))
                assert not a[real:].any() and not a[:, live:].any()


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
