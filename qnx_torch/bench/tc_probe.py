"""Tensor-core rate probe on the card: the MACs a second of Hopper's
single-bit ``wgmma`` (m64n128k256 ``.b1.b1.and.popc``) against its int8 one
(m64n128k32 ``.s8.s8``), on the same tiles resident in shared memory
(``kernels/csrc/tc_probe.cu``; it replaces no TPU kernel).

It answers two questions before the packed GEMMs at wide N (kernels B and
C, ``csrc/popcount_gemm.cu``) rest on the single-bit instruction: does
``ptxas`` take it for ``sm_90a`` (the library builds, and the probe's
output equals its plain version), and at how many MACs a second does it
run, against the int8 instruction that moves the same bytes?  The measured
rate is :data:`qnx_torch.bench.roofline.H100_PEAKS` ``["b1_macs"]``.

    python -m qnx_torch.bench.tc_probe     # one JSON row a mode

Each launch runs ``iters`` iterations of four ``wgmma`` in every warpgroup
of ``blocks`` blocks of two; the rate is the marginal one between two
lengths (CUDA events, medians of ``repeats``), so the launch and the tiles'
load drop out.  The SM clock is read with ``nvidia-smi`` while it runs.
"""
from __future__ import annotations

import json
import statistics

import numpy as np
import torch

from qnx_torch.bench.microbench import device_label, resolve_device
from qnx_torch.kernels import _build
from qnx_torch.ops.packing import popcount

#: the instructions, by the probe's mode: (K of one wgmma, label)
MODES = {"b1": (256, "wgmma m64n128k256 .s32.b1.b1.and.popc"),
         "s8": (32, "wgmma m64n128k32 .s32.s8.s8")}
ROWS_A, ROWS_B, WORDS = 64, 128, 32  # the tiles: rows of 128 bytes
STEPS = 4  # wgmma an iteration: the 128 bytes of a row in 32-byte steps
WARPGROUPS = 2  # a block's


def _check(a: torch.Tensor, b: torch.Tensor, mode: str, iters: int) -> None:
    if mode not in MODES:
        raise ValueError(f"tc_probe: unknown mode {mode!r}; one of {tuple(MODES)}")
    if tuple(a.shape) != (ROWS_A, WORDS) or tuple(b.shape) != (ROWS_B, WORDS):
        raise ValueError(f"tc_probe: a {tuple(a.shape)} and b {tuple(b.shape)} "
                         f"must be ({ROWS_A}, {WORDS}) and ({ROWS_B}, {WORDS})")
    if iters < 0:
        raise ValueError(f"tc_probe: iters={iters} < 0")


def tc_probe_ref(a: torch.Tensor, b: torch.Tensor, mode: str, iters: int,
                 blocks: int = 1) -> torch.Tensor:
    """Plain version of :func:`tc_probe`: ``iters`` times the AND-popcount
    (b1) or the int8 dot (s8) of every row of ``a`` with every row of
    ``b``, wrapped to int32, for each of the ``blocks`` x 2 warpgroups."""
    _check(a, b, mode, iters)
    if mode == "b1":
        one = popcount(a[:, None, :] & b[None, :, :]).sum(-1, dtype=torch.int64)
    else:  # float64 products and sums of int8 values: exact
        a8 = a.contiguous().view(torch.int8).double()
        b8 = b.contiguous().view(torch.int8).double()
        one = (a8 @ b8.T).to(torch.int64)
    v = (one * iters) & 0xFFFFFFFF
    v = torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)
    return v.expand(WARPGROUPS * blocks, ROWS_A, ROWS_B).contiguous()


def tc_probe(a: torch.Tensor, b: torch.Tensor, mode: str, iters: int,
             blocks: int = 1) -> torch.Tensor:
    """(2 ``blocks``, 64, 128) int32: each warpgroup's ``iters``-fold product
    of the (64, 32) and (128, 32) int32 tiles by ``mode``'s instruction."""
    _check(a, b, mode, iters)
    if blocks < 1:
        raise ValueError(f"tc_probe: blocks={blocks} < 1")
    if not _build.check_operands("tc_probe", a, b=b):
        return tc_probe_ref(a, b, mode, iters, blocks)
    out = torch.empty((WARPGROUPS * blocks, ROWS_A, ROWS_B), dtype=torch.int32,
                      device=a.device)
    _build.launch("qnx_tc_probe", a.device, a, b, out, int(mode == "b1"), blocks,
                  iters)
    tc_probe.launches += 1
    return out


tc_probe.launches = 0


def operands(device, seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Seeded tiles whose int8 bytes lie in [-8, 8), so no s8 sum wraps at
    the lengths :func:`measure` runs, and whose bits are dense enough for
    the AND-popcount."""
    rng = np.random.default_rng(seed)
    make = lambda rows: torch.from_numpy(
        rng.integers(-8, 8, (rows, 4 * WORDS), dtype=np.int8).view(np.int32).copy())
    return make(ROWS_A).to(device), make(ROWS_B).to(device)


def macs(mode: str, iters: int, blocks: int) -> int:
    """MACs one launch does."""
    return WARPGROUPS * blocks * iters * STEPS * ROWS_A * ROWS_B * MODES[mode][0]


def measure(iters: int = 2048, repeats: int = 5, device="cuda") -> list[dict]:
    """Each mode's rate on the card: its output checked against the plain
    version at a short length, then CUDA events around launches of
    ``iters`` and 4 ``iters`` iterations on two blocks a SM, in turns; the
    rate is the MACs of the difference over the difference of the medians.
    One row a mode, with the SM clock ``nvidia-smi`` read meanwhile."""
    from qnx_torch.experiments.vpu_probe import SmClock

    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("tc_probe.measure times the card; no CPU route")
    a, b = operands(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = 2 * sms
    for mode in MODES:
        got = tc_probe(a, b, mode, 3, blocks)
        if not torch.equal(got, tc_probe_ref(a, b, mode, 3, blocks)):
            raise AssertionError(f"tc_probe {mode}: output differs from the plain "
                                 f"version's")
    lengths = (iters, 4 * iters)
    times = {(mode, n): [] for mode in MODES for n in lengths}
    with SmClock(device.index) as clock:
        for mode in MODES:
            tc_probe(a, b, mode, iters, blocks)  # warm-up
        for _ in range(repeats):
            for mode in MODES:
                for n in lengths:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    tc_probe(a, b, mode, n, blocks)
                    end.record()
                    end.synchronize()
                    times[mode, n].append(start.elapsed_time(end) * 1e-3)
    mhz = statistics.median(clock.samples) if clock.samples else None
    rows = []
    for mode, (k, label) in MODES.items():
        dt = statistics.median(times[mode, lengths[1]]) - statistics.median(
            times[mode, lengths[0]])
        rate = (macs(mode, lengths[1], blocks) - macs(mode, lengths[0], blocks)) / dt
        rows.append({"mode": mode, "instruction": label, "blocks": blocks,
                     "iters": lengths, "ms": [statistics.median(times[mode, n]) * 1e3
                                              for n in lengths],
                     "macs_per_s": rate, "sm_clock_mhz": mhz,
                     "macs_per_clock_per_sm": None if mhz is None else
                     rate / (mhz * 1e6) / sms})
    rate = {r["mode"]: r["macs_per_s"] for r in rows}
    for r in rows:
        r["b1_over_s8"] = rate["b1"] / rate["s8"]
    return rows


def main(device="cuda", **kwargs) -> list[dict]:
    label = device_label(device)
    rows = measure(device=device, **kwargs)
    print(f"# tc_probe on {label}: wgmma on tiles in shared memory, marginal "
          f"between {rows[0]['iters'][0]} and {rows[0]['iters'][1]} iterations",
          flush=True)
    for r in rows:
        print(json.dumps({"device": label, **r}), flush=True)
    return rows


if __name__ == "__main__":
    main()
