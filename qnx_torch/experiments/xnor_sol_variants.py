"""Accumulator scan of the packed popcount GEMM on the card (the port of
``experiments/xnor_sol_variants.py``).

Does the accumulator dependency chain limit the popcount loop?  At the JAX
file's 1024 x 4096 x 4096 it runs kernel G
(:func:`qnx_torch.kernels.gemm_formulations.xnor_multiacc`), kernel B's
mainloop on the single-bit tensor cores with 1 (``acc1``), 2 and 4
accumulator fragment sets, K step i into set i % nacc, so that ``nacc``
independent ``wgmma`` groups stay in flight; beside them kernel B
(``b_tensor_core``, the baseline: ``acc1`` is its schedule) and C
(``ternary_tensor_core``, at the JAX file's density, 30% zeros).  Checks
``acc1``, ``acc2`` and ``acc4`` against B first, then times all five
interleaved as CUDA graph replays.  One JSON row per variant, fastest
first, with the JAX file's keys; ``vops_per_s_1e12`` counts CUDA-core
integer operations per packed word (xor, popc, add), None for every row
now that no variant runs on the CUDA cores.

    python -m qnx_torch.experiments.xnor_sol_variants
"""
from __future__ import annotations

import json

import numpy as np
import torch

from qnx_torch.bench.microbench import (device_label, l2_warm, resolve_device,
                                        time_fns_marginal_interleaved)
from qnx_torch.kernels.gemm_formulations import xnor_multiacc
from qnx_torch.kernels.ternary_gemm import ternary_gemm
from qnx_torch.kernels.xnor_gemm import xnor_gemm_popcount
from qnx_torch.ops.packing import pack_bits_np, pack_ternary_np

M, K, N = 1024, 4096, 4096


def main(m: int = M, k: int = K, n: int = N, iters: int = 16, repeats: int = 5,
         device="cuda") -> list[dict]:
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    x = np.where(rng.random((m, k)) > 0.5, 1.0, -1.0).astype(np.float32)
    w = np.where(rng.random((k, n)) > 0.5, 1.0, -1.0).astype(np.float32)
    wt = np.where(rng.random((k, n)) < 0.3, 0.0, w)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    xp, wp = dev(pack_bits_np(x, -1)), dev(pack_bits_np(w, 0))
    mask, sign, nnz = map(dev, pack_ternary_np(wt, 0))
    targets = {
        "acc1": (lambda a, b: xnor_multiacc(a, b, k, nacc=1), (xp, wp)),
        "acc2": (lambda a, b: xnor_multiacc(a, b, k, nacc=2), (xp, wp)),
        "acc4": (lambda a, b: xnor_multiacc(a, b, k, nacc=4), (xp, wp)),
        "b_tensor_core": (lambda a, b: xnor_gemm_popcount(a, b, k), (xp, wp)),
        "ternary_tensor_core": (lambda a, b: ternary_gemm(a, b, sign, nnz),
                                (xp, mask)),
    }
    # correctness first, against kernel B
    ref = xnor_gemm_popcount(xp, wp, k)
    for name in ("acc1", "acc2", "acc4"):
        fn, args = targets[name]
        if not torch.equal(fn(*args), ref):
            raise AssertionError(f"{name}: output differs from kernel B's")
    warm = l2_warm(xp, wp, ref)
    del ref

    # graph replays: every row takes less device time than a host launch
    # through its wrapper
    res = time_fns_marginal_interleaved(targets, iters=iters, repeats=repeats,
                                        device=device, graph=True)
    macs = m * k * n
    rows = []
    for name, r in res.items():
        rows.append({
            "variant": name,
            "ms": r["t"] * 1e3,
            "tmacs": macs / r["t"] / 1e12,
            "spread": r["spread"],
            "vops_per_s_1e12": None,  # no CUDA-core variant left
            "unreliable": r["unreliable"],
        })
    rows.sort(key=lambda row: row["ms"])
    print(f"# xnor_sol_variants {m}x{k}x{n} on {device_label(device)}; marginal, "
          f"interleaved, CUDA graph replays, {iters} calls x {repeats} rounds"
          f"{'; L2-warm: the operands fit in 50 MB' if warm else ''}", flush=True)
    for row in rows:
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
