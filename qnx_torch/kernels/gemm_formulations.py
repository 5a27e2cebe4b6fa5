"""Formulations of the packed binary popcount GEMM (torch port of the Pallas
kernels of ``experiments/gemm_shootout.py``, F1-F4, and
``experiments/xnor_sol_variants.py``, G).

Every one computes kernel B's function (:mod:`qnx_torch.kernels.xnor_gemm`)

    s[m, n] = k - 2 * sum_kw popcount(xp[m, kw] ^ wp[kw, n])

exactly, through another schedule, written by hand for Hopper in
``csrc/gemm_formulations.cu``; F3 on the CUDA cores' popc unit, F1, F2, F4
and G on the single-bit tensor cores, with kernel B's tiles, algebra and
(F2, F4, G) mainloop (``csrc/popcount_gemm.cuh``, ``wgmma`` AND-popcount):

* :func:`gemm_outer` (F1, ``v_outer``): a (bm, bn) block stages its whole-K
  strips of x (TMA boxes, all on one barrier) and w (B's word transpose) in
  shared memory in one fill, then issues every K step's ``wgmma`` of each
  128-row sub-tile in one group, with no barrier or refill between steps;
* :func:`gemm_outer_acc` (F2, ``v_outer_acc``): B's mainloop at K steps of
  ``bk`` = 16 or 8 words (64- or 32-byte swizzled tile rows) through a ring
  of ``stages``, ``bn`` columns a block;
* :func:`gemm_chunk3d` (F3, ``v_chunk3d``) on the CUDA cores: K in slabs of
  32 words through a ``cp.async`` ring, each ``kc``-word chunk of an output
  reduced by a carry-save tree of full adders (:func:`chunk3d_tree`, LOP3)
  to a few counter words, one POPC each (:func:`chunk3d_issue`);
* :func:`gemm_lanered` (F4, ``v_lanered``): the dot form against the
  transposed weights ``wpt`` (N, Kw): both operands K-major, so both tiles
  arrive by TMA boxes (no word transpose), ``bn`` columns a block, a ring of
  ``stages``;
* :func:`xnor_multiacc` (G): B's mainloop on B's (Kw, N) weights with
  ``nacc`` accumulator fragment sets, K step i into set i % nacc, ``nacc``
  independent ``wgmma`` groups in flight; ``nacc=1`` is B's schedule.

One plain version serves all five: :func:`xnor_gemm_popcount_ref`.  Each
wrapper runs it only for a CPU tensor; for a CUDA tensor it launches its
kernel or raises, and counts ``.launches``.  The geometries are those
compiled into the CUDA source; another raises ``ValueError``, and an
``outer`` geometry whose strips do not fit in one block's shared memory
(:func:`outer_smem_bytes` above :data:`SMEM_LIMIT`) raises
:class:`DoesNotFit` (on any device, before any launch), the counterpart of
the VMEM failures the JAX shootout prints.
"""
from __future__ import annotations

import torch

from . import _build
from .xnor_gemm import check_and_products, xnor_gemm_popcount_ref

# The geometries compiled into csrc/gemm_formulations.cu; the first of each
# is the wrapper's default.
#: (bm, bn) of :func:`gemm_outer`: 128-row sub-tiles of min(bn, 128) columns;
#: (128, 64) leaves two blocks a SM where Kw <= 128
OUTER_GEOMETRIES = ((128, 128), (256, 128), (256, 256), (512, 256), (1024, 128),
                    (128, 64))
#: (bn, bk, stages) of :func:`gemm_outer_acc`: columns a block, words a K
#: step and ring stages; (128, 16, 6) and (128, 8, 12) ring kernel B's 96
#: words of tiles, (128, 16, 6) and (64, 16, 9) as deep as two blocks a SM
#: allow
OUTER_ACC_GEOMETRIES = ((128, 16, 6), (128, 8, 12), (128, 16, 3), (64, 16, 9))
#: (bm, bn, kc) of :func:`gemm_chunk3d`: a thread owns (bm / 16) x (bn /
#: 16) outputs and holds its rows' kc words of a chunk; each geometry at two
#: blocks a SM (128 registers, :func:`chunk3d_smem_bytes`) with no spill:
#: kc = 16 holds two rows a thread, 64x64x16 and 32x128x16 spilled
CHUNK3D_GEOMETRIES = ((64, 128, 8), (64, 64, 8), (64, 64, 4), (64, 128, 4),
                      (32, 64, 16))
#: (bn, stages) of :func:`gemm_lanered`: columns a block (the wgmma's N)
#: and tiles in its TMA ring; (128, 3) is kernel B's tiling
LANERED_GEOMETRIES = ((128, 3), (128, 4), (64, 4))
#: accumulator fragment sets of :func:`xnor_multiacc`
NACCS = (1, 2, 4)
#: nacc -> (bn, stages) the G instance of that count runs: nacc + 2 stages
#: at least, and 64 columns at nacc = 4, whose four sets of 64 accumulators
#: would not fit a thread
MULTIACC_TILING = {1: (128, 3), 2: (128, 4), 4: (64, 6)}
#: shared memory one block of an H100 may opt in to (227 KiB)
SMEM_LIMIT = 232448


class DoesNotFit(ValueError):
    """A geometry whose shared-memory strips exceed one block's limit."""


#: a 128-byte K-major tile row of the single-bit wgmma: 32 words
TILE_WORDS = 32


def outer_smem_bytes(bm: int, bn: int, kw: int) -> int:
    """Dynamic shared memory of one :func:`gemm_outer` block: 1024 bytes to
    align the strips, the x and w strips as ceil(Kw / 32) tiles of 128-byte
    rows (bm + bn rows each), the fill's barrier (8 bytes) and the row and
    column terms (an int32 each)."""
    tiles = -(-kw // TILE_WORDS)
    return 1024 + (bm + bn) * tiles * 4 * TILE_WORDS + 8 + 4 * (bm + bn)


def check_outer_fits(bm: int, bn: int, kw: int) -> None:
    """Raise :class:`DoesNotFit` where :func:`gemm_outer`'s strips exceed
    :data:`SMEM_LIMIT`."""
    need = outer_smem_bytes(bm, bn, kw)
    if need > SMEM_LIMIT:
        raise DoesNotFit(f"gemm_outer {bm}x{bn} at Kw={kw} needs {need} bytes of "
                         f"shared memory, above the {SMEM_LIMIT} one block may use")


def _check(name: str, xp: torch.Tensor, w: torch.Tensor, w_kw_axis: int,
           geometry: tuple, allowed: tuple, fits=None) -> bool:
    """Shape, geometry, ``fits()`` (where given) and operand checks; True
    where the kernel launches."""
    if xp.dim() != 2 or w.dim() != 2 or w.shape[w_kw_axis] != xp.shape[1]:
        raise ValueError(f"{name}: xp {tuple(xp.shape)} and weights "
                         f"{tuple(w.shape)} disagree on Kw")
    if geometry not in allowed:
        raise ValueError(f"{name}: geometry {geometry} is not compiled in; "
                         f"choose one of {allowed}")
    if fits is not None:
        fits()
    return _build.check_operands(name, xp, w=w)


def _launch(fn_name: str, wrapper, xp: torch.Tensor, w: torch.Tensor, n: int,
            k: int, *geometry: int, pad_rows: bool = False) -> torch.Tensor:
    """Launch ``fn_name`` on (M, Kw) x against ``w`` into a new (M, n) int32
    output and count it on ``wrapper``; ``pad_rows``: the kernel reads x
    through :func:`tma_rows` (Kw passed as it is)."""
    m, kw = xp.shape
    out = torch.empty((m, n), dtype=torch.int32, device=xp.device)
    if out.numel():
        _build.launch(fn_name, xp.device, tma_rows(xp) if pad_rows else xp, w, out,
                      m, kw, n, k, *geometry)
        wrapper.launches += 1
    return out


def gemm_outer(xp: torch.Tensor, wp: torch.Tensor, k: int, bm: int = 128,
               bn: int = 128) -> torch.Tensor:
    """F1: (M, Kw) x (Kw, N) packed words -> (M, N) int32 s, whole-K strips
    per (bm, bn) block, staged once on the single-bit tensor cores.  x
    arrives by TMA boxes, which need 16-byte row strides: where Kw % 4 != 0
    (or x is not 16-byte aligned) the kernel reads a copy of x with zero
    words appended (:func:`tma_rows`)."""
    launch = _check("gemm_outer", xp, wp, 0, (bm, bn), OUTER_GEOMETRIES,
                    lambda: check_outer_fits(bm, bn, xp.shape[1]))
    check_and_products("gemm_outer", xp.shape[1])
    if not launch:
        return xnor_gemm_popcount_ref(xp, wp, k)
    return _launch("qnx_gemm_outer", gemm_outer, xp, wp, wp.shape[1], k, bm, bn,
                   pad_rows=True)


def outer_acc_name(bn: int, bk: int, stages: int) -> str:
    """The name of an F2 geometry, as the shootout and ``chip_smoke.py``
    print it: ``outer_acc-n128-k16-s6``."""
    return f"outer_acc-n{bn}-k{bk}-s{stages}"


def gemm_outer_acc(xp: torch.Tensor, wp: torch.Tensor, k: int, bn: int = 128,
                   bk: int = 16, stages: int = 6) -> torch.Tensor:
    """F2: kernel B's mainloop on the single-bit tensor cores at K steps of
    ``bk`` words (16 or 8; B's are 32) through a ring of ``stages``, ``bn``
    columns a block."""
    if not _check("gemm_outer_acc", xp, wp, 0, (bn, bk, stages), OUTER_ACC_GEOMETRIES):
        return xnor_gemm_popcount_ref(xp, wp, k)
    check_and_products("gemm_outer_acc", xp.shape[1])
    return _launch("qnx_gemm_outer_acc", gemm_outer_acc, xp, wp, wp.shape[1], k,
                   bn, bk, stages)


#: words of K a slab of :func:`gemm_chunk3d`, and the slabs in its ring
CHUNK3D_SLAB = 32
CHUNK3D_RING = 3


def chunk3d_smem_bytes(bm: int, bn: int) -> int:
    """Dynamic shared memory of one :func:`gemm_chunk3d` block: the ring's
    stages, each a slab of x (bm rows) and of w transposed (bn rows), rows of
    32 words and 4 of padding (16-byte aligned, a quarter warp's 16-byte
    reads of 8 rows on all 32 banks)."""
    return 4 * CHUNK3D_RING * (bm + bn) * (CHUNK3D_SLAB + 4)


def chunk3d_tree(kc: int) -> tuple[list, list]:
    """The carry-save tree that reduces one ``kc``-word chunk of an output
    in ``csrc/gemm_formulations.cu`` (``chunk_popc``): words 0 .. kc - 1
    are the chunk's XOR words, of weight 2^0.  Lowest weight first, a
    weight's words go through full adders three at a time, oldest first; a
    full adder's sum (a new word) joins its weight's words and its carry the
    next weight's, until fewer than three are left.  Returns ``(adders,
    counters)``: each adder ``(weight, a, b, c, sum, carry)`` over word ids,
    in order, and the counter words left, ``(weight, id)``, each of which
    takes one POPC, shifted left by its weight.  Then
    ``sum_c popc(z_c) == sum 2^weight popc(counter)`` for any words."""
    if kc not in (4, 8, 16):
        raise ValueError(f"chunk3d_tree: kc={kc}; one of 4, 8, 16")
    columns, adders, next_id = {0: list(range(kc))}, [], kc
    weight = 0
    while weight in columns:
        words = columns[weight]
        while len(words) >= 3:
            a, b, c = words[:3]
            del words[:3]
            adders.append((weight, a, b, c, next_id, next_id + 1))
            words.append(next_id)
            columns.setdefault(weight + 1, []).append(next_id + 1)
            next_id += 2
        weight += 1
    counters = [(w, i) for w in sorted(columns) for i in columns[w]]
    return adders, counters


def chunk3d_issue(kc: int) -> dict:
    """The SASS instructions one ``kc``-word chunk of one output issues in
    :func:`gemm_chunk3d`'s tree (:func:`chunk3d_tree`): LOP3 the kc XOR
    words and two a full adder (its sum a ^ b ^ c and its carry maj(a, b,
    c)); POPC one a counter word; IMAD the shift-and-add that folds each
    counter's popcount into the int32 accumulator.  kc = 4: 6, 3, 3; 8: 16,
    4, 4; 16: 38, 5, 5 (the chunk loop's SASS on the card, PERF.md §6)."""
    adders, counters = chunk3d_tree(kc)
    return {"LOP3": kc + 2 * len(adders), "IMAD": len(counters),
            "POPC": len(counters)}


def gemm_chunk3d(xp: torch.Tensor, wp: torch.Tensor, k: int, bm: int = 64,
                 bn: int = 128, kc: int = 8) -> torch.Tensor:
    """F3 on the CUDA cores: K in slabs of 32 words through a ``cp.async``
    ring; each ``kc``-word chunk of an output reduced by a carry-save tree
    to :func:`chunk3d_issue`'s counter words, one POPC each, ``(bm / 16) x
    (bn / 16)`` outputs a thread.  x's slab rows copy as 16-byte units, so
    where Kw % 4 != 0 (or x is not 16-byte aligned) the kernel reads a copy
    of x with zero words appended (:func:`tma_rows`)."""
    if not _check("gemm_chunk3d", xp, wp, 0, (bm, bn, kc), CHUNK3D_GEOMETRIES):
        return xnor_gemm_popcount_ref(xp, wp, k)
    return _launch("qnx_gemm_chunk3d", gemm_chunk3d, xp, wp, wp.shape[1], k, bm, bn,
                   kc, pad_rows=True)


def lanered_name(bn: int, stages: int) -> str:
    """The name of an F4 geometry, as the shootout and ``chip_smoke.py``
    print it: ``lanered-n128-s3``."""
    return f"lanered-n{bn}-s{stages}"


def tma_rows(t: torch.Tensor) -> torch.Tensor:
    """A K-major word matrix as TMA boxes and 16-byte copies take it: rows
    of Kw rounded up to 4 words (16-byte row strides) at a 16-byte aligned
    address.  One that
    already is comes back as it is; another is copied with zero words
    appended, which AND to 0 and leave every sum unchanged."""
    kw = t.shape[1]
    kw4 = -(-kw // 4) * 4
    if kw4 == kw and t.data_ptr() % 16 == 0:
        return t
    out = t.new_zeros((t.shape[0], kw4))
    out[:, :kw] = t
    return out


def tma_operands(xp: torch.Tensor, wpt: torch.Tensor) -> tuple:
    """F4's operands as its TMA boxes take them (:func:`tma_rows`)."""
    return tma_rows(xp), tma_rows(wpt)


def gemm_lanered(xp: torch.Tensor, wpt: torch.Tensor, k: int, bn: int = 128,
                 stages: int = 3) -> torch.Tensor:
    """F4, the dot form: xp (M, Kw) against the transposed weights ``wpt``
    (N, Kw), both K-major, on the single-bit tensor cores: each K step's
    tiles are two TMA boxes into a ring of ``stages``, ``bn`` columns a
    block.  TMA needs 16-byte row strides, so where Kw % 4 != 0 (or an
    operand is not 16-byte aligned) the kernel runs on a copy of the
    operands padded to Kw rounded up to 4 with zero words
    (:func:`tma_operands`)."""
    if not _check("gemm_lanered", xp, wpt, 1, (bn, stages), LANERED_GEOMETRIES):
        return xnor_gemm_popcount_ref(xp, wpt.t(), k)
    check_and_products("gemm_lanered", xp.shape[1])
    m = xp.shape[0]
    out = torch.empty((m, wpt.shape[0]), dtype=torch.int32, device=xp.device)
    if out.numel():
        x4, w4 = tma_operands(xp, wpt)
        _build.launch("qnx_gemm_lanered", xp.device, x4, w4, out, m, x4.shape[1],
                      wpt.shape[0], k, bn, stages)
        gemm_lanered.launches += 1
    return out


def xnor_multiacc(xp: torch.Tensor, wp: torch.Tensor, k: int,
                  nacc: int = 2) -> torch.Tensor:
    """G: kernel B's mainloop on B's (Kw, N) weights with ``nacc``
    accumulator fragment sets, K step i into set i % nacc, ``nacc``
    independent ``wgmma`` groups in flight, the sets summed before the
    epilogue (tiling :data:`MULTIACC_TILING`); ``nacc=1`` is B's
    schedule."""
    if not _check("xnor_multiacc", xp, wp, 0, (nacc,), tuple((a,) for a in NACCS)):
        return xnor_gemm_popcount_ref(xp, wp, k)
    check_and_products("xnor_multiacc", xp.shape[1])
    return _launch("qnx_xnor_multiacc", xnor_multiacc, xp, wp, wp.shape[1], k, nacc)


gemm_outer.launches = 0
gemm_outer_acc.launches = 0
gemm_chunk3d.launches = 0
gemm_lanered.launches = 0
xnor_multiacc.launches = 0
