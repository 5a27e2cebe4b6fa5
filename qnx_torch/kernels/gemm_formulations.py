"""Formulations of the packed binary popcount GEMM (torch port of the Pallas
kernels of ``experiments/gemm_shootout.py``, F1-F4, and
``experiments/xnor_sol_variants.py``, G).

Every one computes kernel B's function (:mod:`qnx_torch.kernels.xnor_gemm`)

    s[m, n] = k - 2 * sum_kw popcount(xp[m, kw] ^ wp[kw, n])

exactly, through another schedule, written by hand for Hopper in
``csrc/gemm_formulations.cu``:

* :func:`gemm_outer` (F1, ``v_outer``): whole-K strips of x and w staged in
  shared memory once per (bm, bn) block, an 8x8 register tile per thread;
* :func:`gemm_outer_acc` (F2, ``v_outer_acc``): the same tile over K steps of
  ``bk`` words through a double-buffered ``cp.async`` ring;
* :func:`gemm_chunk3d` (F3, ``v_chunk3d``): ``kc`` words per step as vector
  loads, the chunk's popcounts summed;
* :func:`gemm_lanered` (F4, ``v_lanered``): the dot form against the
  transposed weights ``wpt`` (N, Kw), the words split across a warp's lanes;
* :func:`xnor_multiacc` (G): the lane-per-column layout B had on the CUDA
  cores with ``nacc`` independent accumulators; ``nacc=1`` is that layout.

One plain version serves all five: :func:`xnor_gemm_popcount_ref`.  Each
wrapper runs it only for a CPU tensor; for a CUDA tensor it launches its
kernel or raises, and counts ``.launches``.  The geometries are those
compiled into the CUDA source; another raises ``ValueError``, and an
``outer`` geometry whose strips do not fit in one block's shared memory
raises :class:`DoesNotFit` (on any device, before any launch), the
counterpart of the VMEM failures the JAX shootout prints.
"""
from __future__ import annotations

import torch

from . import _build
from .xnor_gemm import xnor_gemm_popcount_ref

# The geometries compiled into csrc/gemm_formulations.cu; the first of each
# is the wrapper's default.
#: (bm, bn) of :func:`gemm_outer`
OUTER_GEOMETRIES = ((128, 128), (256, 128), (256, 256), (512, 256), (1024, 128))
#: (bm, bn, bk) of :func:`gemm_outer_acc`
OUTER_ACC_GEOMETRIES = ((128, 128, 16), (128, 128, 8), (64, 128, 16), (256, 128, 8))
#: (bm, bn, kc) of :func:`gemm_chunk3d`
CHUNK3D_GEOMETRIES = ((64, 64, 4), (64, 64, 8), (64, 64, 16), (128, 128, 4),
                      (128, 128, 8))
#: (rows, cols) per warp of :func:`gemm_lanered`
LANERED_GEOMETRIES = ((1, 16), (1, 8), (4, 8))
#: accumulators per output of :func:`xnor_multiacc`
NACCS = (1, 2, 4)
#: shared memory one block of an H100 may opt in to (227 KiB)
SMEM_LIMIT = 232448


class DoesNotFit(ValueError):
    """A geometry whose shared-memory strips exceed one block's limit."""


def outer_smem_bytes(bm: int, bn: int, kw: int) -> int:
    """Shared memory of one :func:`gemm_outer` block: the (bm, Kw) x strip
    at an odd row stride (``kw | 1``, so two rows never share a bank) and
    the (Kw, bn) w strip, int32 words."""
    return 4 * (bm * (kw | 1) + kw * bn)


def check_outer_fits(bm: int, bn: int, kw: int) -> None:
    """Raise :class:`DoesNotFit` where :func:`gemm_outer`'s strips exceed
    :data:`SMEM_LIMIT`."""
    need = outer_smem_bytes(bm, bn, kw)
    if need > SMEM_LIMIT:
        raise DoesNotFit(f"gemm_outer {bm}x{bn} at Kw={kw} needs {need} bytes of "
                         f"shared memory, above the {SMEM_LIMIT} one block may use")


def _check(name: str, xp: torch.Tensor, w: torch.Tensor, w_kw_axis: int,
           geometry: tuple, allowed: tuple) -> bool:
    """Shape, geometry and operand checks; True where the kernel launches."""
    if xp.dim() != 2 or w.dim() != 2 or w.shape[w_kw_axis] != xp.shape[1]:
        raise ValueError(f"{name}: xp {tuple(xp.shape)} and weights "
                         f"{tuple(w.shape)} disagree on Kw")
    if geometry not in allowed:
        raise ValueError(f"{name}: geometry {geometry} is not compiled in; "
                         f"choose one of {allowed}")
    return _build.check_operands(name, xp, w=w)


def _launch(fn_name: str, wrapper, xp: torch.Tensor, w: torch.Tensor, n: int,
            k: int, *geometry: int) -> torch.Tensor:
    m, kw = xp.shape
    out = torch.empty((m, n), dtype=torch.int32, device=xp.device)
    if out.numel():
        _build.launch(fn_name, xp.device, xp, w, out, m, kw, n, k, *geometry)
        wrapper.launches += 1
    return out


def gemm_outer(xp: torch.Tensor, wp: torch.Tensor, k: int, bm: int = 128,
               bn: int = 128) -> torch.Tensor:
    """F1: (M, Kw) x (Kw, N) packed words -> (M, N) int32 s, whole-K strips
    per (bm, bn) block."""
    launch = _check("gemm_outer", xp, wp, 0, (bm, bn), OUTER_GEOMETRIES)
    check_outer_fits(bm, bn, xp.shape[1])
    if not launch:
        return xnor_gemm_popcount_ref(xp, wp, k)
    return _launch("qnx_gemm_outer", gemm_outer, xp, wp, wp.shape[1], k, bm, bn)


def gemm_outer_acc(xp: torch.Tensor, wp: torch.Tensor, k: int, bm: int = 128,
                   bn: int = 128, bk: int = 16) -> torch.Tensor:
    """F2: as :func:`gemm_outer`, K in steps of ``bk`` words through a
    double-buffered ``cp.async`` ring."""
    if not _check("gemm_outer_acc", xp, wp, 0, (bm, bn, bk), OUTER_ACC_GEOMETRIES):
        return xnor_gemm_popcount_ref(xp, wp, k)
    return _launch("qnx_gemm_outer_acc", gemm_outer_acc, xp, wp, wp.shape[1], k,
                   bm, bn, bk)


def gemm_chunk3d(xp: torch.Tensor, wp: torch.Tensor, k: int, bm: int = 64,
                 bn: int = 64, kc: int = 4) -> torch.Tensor:
    """F3: ``kc`` words of a row and a column per step, the chunk's
    popcounts summed."""
    if not _check("gemm_chunk3d", xp, wp, 0, (bm, bn, kc), CHUNK3D_GEOMETRIES):
        return xnor_gemm_popcount_ref(xp, wp, k)
    return _launch("qnx_gemm_chunk3d", gemm_chunk3d, xp, wp, wp.shape[1], k,
                   bm, bn, kc)


def gemm_lanered(xp: torch.Tensor, wpt: torch.Tensor, k: int, rows: int = 1,
                 cols: int = 16) -> torch.Tensor:
    """F4, the dot form: xp (M, Kw) against the transposed weights ``wpt``
    (N, Kw), one warp per ``rows`` x ``cols`` outputs."""
    if not _check("gemm_lanered", xp, wpt, 1, (rows, cols), LANERED_GEOMETRIES):
        return xnor_gemm_popcount_ref(xp, wpt.t(), k)
    return _launch("qnx_gemm_lanered", gemm_lanered, xp, wpt, wpt.shape[0], k,
                   rows, cols)


def xnor_multiacc(xp: torch.Tensor, wp: torch.Tensor, k: int,
                  nacc: int = 2) -> torch.Tensor:
    """G: kernel B's former CUDA-core layout with ``nacc`` independent
    accumulators (1: that layout)."""
    if not _check("xnor_multiacc", xp, wp, 0, (nacc,), tuple((a,) for a in NACCS)):
        return xnor_gemm_popcount_ref(xp, wp, k)
    return _launch("qnx_xnor_multiacc", xnor_multiacc, xp, wp, wp.shape[1], k, nacc)


gemm_outer.launches = 0
gemm_outer_acc.launches = 0
gemm_chunk3d.launches = 0
gemm_lanered.launches = 0
xnor_multiacc.launches = 0
