"""Shootout of packed popcount-GEMM formulations on the card (the port of
``experiments/gemm_shootout.py``).

At the JAX file's three shapes, at full size, and at the MNIST MLP head's
(256 x 4096 x 10), it runs kernel B (the
baseline, :func:`qnx_torch.kernels.xnor_gemm.xnor_gemm_popcount`, on the
single-bit tensor cores: :data:`BASELINE_ROUTE`), every
geometry of the four formulations F1-F4
(:mod:`qnx_torch.kernels.gemm_formulations`: F1 on the single-bit tensor
cores with all of K staged once a block, :data:`OUTER_ROUTE`; F2 on B's
mainloop at narrower K steps, :data:`STEPS_ROUTE`; F3 on the CUDA cores; F4
on the single-bit tensor cores with its K-major tiles fed by TMA,
:data:`TMA_ROUTE`) and, as context, one ``torch._int_mm`` on the unpacked ±1
int8 operands (a library GEMM with no packing).  Every candidate's output must equal B's; a geometry
whose shared-memory strips do not fit prints as "does not fit", and any
other error propagates.  Times are marginal and interleaved
(:func:`qnx_torch.bench.microbench.time_fns_marginal_interleaved`); each row
gives ms, TMAC/s, and its share of the bounds of the units it runs on
(:data:`qnx_torch.bench.roofline.H100_PEAKS`): F3 the MACs at the int8
tensor-core rate and its unit bound (the integer, POPC and shared-memory
issue of its carry-save tree, :func:`qnx_torch.bench.roofline.chunk3d_unit_bound`),
the library the int8 rate, B, F1, F2 and F4 the measured single-bit rate; a
share that does not apply is None.

    python -m qnx_torch.experiments.gemm_shootout
"""
from __future__ import annotations

import numpy as np
import torch

from qnx_torch.bench.microbench import (device_label, l2_warm, resolve_device,
                                        time_fns_marginal_interleaved)
from qnx_torch.bench.roofline import H100_PEAKS, chunk3d_unit_bound
from qnx_torch.kernels import gemm_formulations as G
from qnx_torch.kernels.xnor_gemm import xnor_gemm_popcount
from qnx_torch.ops.packing import WORD, packed_len, unpack_bits

#: (name, M, K, N): the JAX file's shapes (gemm_shootout.py:135-139), and
#: the MNIST MLP head's at batch 256, where one lane per column of B leaves
#: 22 of 32 lanes idle
SHAPES = [("conv1-like", 262144, 1152, 128),
          ("conv3-like", 65536, 2304, 256),
          ("dense-mlp", 4096, 4096, 4096),
          ("mnist-head", 256, 4096, 10)]
BASELINE = "B popcount_gemm"
BASELINE_ROUTE = ("wgmma m64n128k256 .b1.b1.and.popc, the single-bit tensor cores "
                  "(csrc/popcount_gemm.cu)")
TMA_ROUTE = ("the same wgmma on K-major x and wt tiles, both fed by TMA "
             "(csrc/popcount_gemm.cuh)")
OUTER_ROUTE = ("the same wgmma on whole-K strips staged once a block, x by TMA "
               "(csrc/gemm_formulations.cu)")
STEPS_ROUTE = "B's mainloop at K steps of 16 or 8 words (csrc/popcount_gemm.cuh)"
#: the candidates on the single-bit tensor cores, by name prefix
B1_PREFIXES = ("outer-", "outer_acc-", "lanered-")
LIBRARY = "torch._int_mm ±1 int8 (library, unpacked)"


def random_words(rng: np.random.Generator, rows: int, k: int,
                 along_rows: bool = False) -> np.ndarray:
    """Seeded int32 words packing ``k`` bits along the last axis (or the
    first, ``along_rows``), with the pad bits of the last word 0."""
    kw = packed_len(k)
    words = rng.integers(-2**31, 2**31, (rows, kw), dtype=np.int64)
    if k % WORD:
        words[:, -1] &= (1 << (k % WORD)) - 1
    words = words.astype(np.uint32).view(np.int32)
    return np.ascontiguousarray(words.T if along_rows else words)


def candidates(k: int) -> dict:
    """``{name: fn(xp, wp, wpt)}``: B first, then every geometry of F1-F4."""
    cands = {BASELINE: lambda xp, wp, wpt: xnor_gemm_popcount(xp, wp, k)}
    for bm, bn in G.OUTER_GEOMETRIES:
        cands[f"outer-{bm}x{bn}"] = (
            lambda xp, wp, wpt, g=(bm, bn): G.gemm_outer(xp, wp, k, *g))
    for g in G.OUTER_ACC_GEOMETRIES:
        cands[G.outer_acc_name(*g)] = (
            lambda xp, wp, wpt, g=g: G.gemm_outer_acc(xp, wp, k, *g))
    for bm, bn, kc in G.CHUNK3D_GEOMETRIES:
        cands[f"chunk3d-{bm}x{bn}x{kc}"] = (
            lambda xp, wp, wpt, g=(bm, bn, kc): G.gemm_chunk3d(xp, wp, k, *g))
    for bn, stages in G.LANERED_GEOMETRIES:
        cands[G.lanered_name(bn, stages)] = (
            lambda xp, wp, wpt, g=(bn, stages): G.gemm_lanered(xp, wpt, k, *g))
    return cands


def run_shape(name: str, m: int, k: int, n: int, *, iters: int, repeats: int,
              device, seed: int = 0) -> list[dict]:
    """Every candidate at one (M, K, N) on seeded words; one row each."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    xp = torch.from_numpy(random_words(rng, m, k)).to(device)
    wp = torch.from_numpy(random_words(rng, n, k, along_rows=True)).to(device)
    wpt = wp.t().contiguous()
    args = (xp, wp, wpt)
    cands = candidates(k)
    ref = cands[BASELINE](*args)
    rows, targets = [], {}
    for cname, fn in cands.items():
        try:
            out = fn(*args)
        except G.DoesNotFit as e:
            rows.append({"shape": name, "candidate": cname, "fits": False,
                         "note": str(e)})
            continue
        if out.shape != ref.shape or not torch.equal(out, ref):
            raise AssertionError(f"{name} {cname}: output differs from {BASELINE}'s")
        targets[cname] = (fn, args)
        del out
    if m > 16 and k % 8 == 0 and n % 8 == 0:  # what _int_mm takes on the card
        a8 = unpack_bits(xp, k).contiguous()
        b8t = unpack_bits(wpt, k).contiguous()  # (N, K): the product's B column-major
        if not torch.equal(torch._int_mm(a8, b8t.t()), ref):
            raise AssertionError(f"{name}: torch._int_mm differs from {BASELINE}'s s")
        targets[LIBRARY] = (lambda a, b: torch._int_mm(a, b.t()), (a8, b8t))
    warm = l2_warm(xp, wp, ref)
    del ref
    macs = m * k * n
    # a call with under 2^30 MACs takes less than 10 us at the popc ceiling,
    # less than its host launch: time graph replays of its chains
    graph = macs <= 2**30
    res = time_fns_marginal_interleaved(targets, iters=iters, repeats=repeats,
                                        device=device, graph=graph)
    int8_s = macs / H100_PEAKS["int8_macs"]
    b1_s = macs / H100_PEAKS["b1_macs"]
    for cname, r in res.items():
        b1 = cname == BASELINE or cname.startswith(B1_PREFIXES)
        unit = (chunk3d_unit_bound(m, k, n, *(int(v) for v in cname[8:].split("x")))
                if cname.startswith("chunk3d-") else None)
        rows.append({"shape": name, "candidate": cname, "fits": True,
                     "equal": True, "ms": r["t"] * 1e3, "tmacs": macs / r["t"] / 1e12,
                     "int8_share": None if b1 else int8_s / r["t"],
                     "unit_share": None if unit is None else unit["bound_s"] / r["t"],
                     "unit": None if unit is None else unit["unit"],
                     "b1_share": b1_s / r["t"] if b1 else None,
                     "spread": r["spread"], "unreliable": r["unreliable"],
                     "l2_warm": warm, "graph": graph})
    return rows


def format_row(row: dict) -> str:
    if not row["fits"]:
        return f"{row['shape']:12s} {row['candidate']:44s}: does not fit ({row['note']})"
    share = lambda v, digits: "-" if v is None else f"{v:.{digits}f}"
    return (f"{row['shape']:12s} {row['candidate']:44s}: {row['ms']:9.4f} ms "
            f"{row['tmacs']:7.2f} TMAC/s  int8-bound share "
            f"{share(row['int8_share'], 4)}  unit-bound share "
            f"{share(row['unit_share'], 3)}"
            f"{'' if row['unit'] is None else ' (' + row['unit'] + ')'}  b1-bound share "
            f"{share(row['b1_share'], 4)}  spread {row['spread']:.3f}"
            f"{'  UNRELIABLE' if row['unreliable'] else ''}"
            f"{'  L2-warm' if row['l2_warm'] else ''}"
            f"{'  CUDA graph' if row['graph'] else ''}  equal to B")


def main(shapes=SHAPES, iters: int = 16, repeats: int = 5, device="cuda") -> list[dict]:
    device = resolve_device(device)
    print(f"# gemm shootout on {device_label(device)}; marginal ms, interleaved, "
          f"{iters} calls x {repeats} rounds; L2-warm where the operands fit in "
          f"50 MB; the baseline {BASELINE} runs {BASELINE_ROUTE}, F1 "
          f"{OUTER_ROUTE}, F2 {STEPS_ROUTE}, F3 the CUDA cores, F4 {TMA_ROUTE}",
          flush=True)
    rows = []
    for name, m, k, n in shapes:
        shape_rows = run_shape(name, m, k, n, iters=iters, repeats=repeats,
                               device=device)
        for row in shape_rows:
            print(format_row(row), flush=True)
        rows += shape_rows
    return rows


if __name__ == "__main__":
    main()
