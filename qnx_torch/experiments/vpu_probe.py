"""Integer issue-rate probe on the card (the port of
``experiments/vpu_probe.py``).

For each of the six steps of kernel H (:mod:`qnx_torch.kernels.int_probe`)
it times chains over the JAX file's 4096 x 1024 int32 elements and
differences two lengths, which strips the launch and the loads: the JAX
file's LONG = 96 against SHORT = 32, and 384 against 128 (:data:`PAIRS`).
At 32 steps the cheapest mode (``xor``) issues for less time than its 12
bytes an element take, so its 96 - 32 difference reads memory; at 128 steps
and more every mode's issue outlasts its bytes, so the 384 - 128 difference
is its issue rate.  Each row gives ps per element-step, element-steps per
second and steps per clock per SM at the SM clock ``nvidia-smi`` reads
while the chains run, for both differences.  It counts, in the built
library's SASS (``cuobjdump -sass``), the instructions of each chain's
builds, which shows that the compiler neither folded nor hoisted the
chain, and turns the 384 - 128 steps a clock into each opcode's rate per
clock per SM: ``pc`` and ``pconly`` give the POPC rate, the ceiling of
every popcount kernel on the CUDA cores, and ``xor`` (one LOP3 and one
IADD3 a step) the integer rate of kernel F3's carry-save tree
(``H100_PEAKS["int_ops"]``); ``mul``'s IMAD the FMA pipe's integer rate
(``imad_ops``), and ``xor``'s two instructions a step the issue slots'
(``issue_ops``).  Each mode's least time at each length is the larger of
its bytes and its issue, each opcode on its pipe
(:func:`qnx_torch.bench.roofline.issue_times`).

    python -m qnx_torch.experiments.vpu_probe
"""
from __future__ import annotations

import re
import shutil
import statistics
import subprocess
import threading
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from qnx_torch.bench.microbench import device_label, resolve_device, time_fn_marginal
from qnx_torch.bench.roofline import H100_PEAKS, issue_times
from qnx_torch.kernels.int_probe import MODES, int_chain

SHAPE = (256 * 16, 1024)  # the JAX file's BLOCK (256, 1024) x GRID 16
LONG, SHORT = 96, 32
#: (long, short) chain lengths differenced: the issue pair, then the JAX
#: file's; each row's unprefixed keys are the first pair's, ``jax_`` the
#: second's
PAIRS = ((384, 128), (LONG, SHORT))
BYTES_PER_ELEMENT = 12  # x and y read, out written, int32 each


class SmClock:
    """Polls ``nvidia-smi``'s ``clocks.sm`` (MHz) in a thread while the
    ``with`` block runs; ``samples`` holds the readings."""

    def __init__(self, index: int):
        self.cmd = ["nvidia-smi", f"--id={index}", "--query-gpu=clocks.sm",
                    "--format=csv,noheader,nounits"]
        self.samples: list[int] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)

    def _poll(self) -> None:
        while not self._stop.is_set():
            out = subprocess.run(self.cmd, capture_output=True, text=True,
                                 timeout=30).stdout
            self.samples += [int(v) for v in out.split() if v.isdigit()]

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=60)
        return False


def _cuobjdump() -> str | None:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("cuobjdump")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "cuobjdump").exists():
        return str(Path(CUDA_HOME) / "bin" / "cuobjdump")
    return None


def sass_counts(library: Path) -> dict:
    """``{(mode, reps): Counter of SASS opcodes}`` of every int_chain_kernel
    instance in the built library, or {} without ``cuobjdump``."""
    tool = _cuobjdump()
    if tool is None:
        return {}
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, key = {}, None
    for line in sass.splitlines():
        head = re.search(r"Function : \S*int_chain_kernelILi(\d+)ELi(\d+)E", line)
        if head:
            key = (MODES[int(head.group(1))], int(head.group(2)))
            counts[key] = Counter()
        elif "Function :" in line:
            key = None
        elif key is not None:
            op = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                          line)
            if op:
                counts[key][op.group(1).split(".")[0]] += 1
    return counts


def sass_per_step(counts: dict, mode: str, long: int, short: int) -> dict:
    """``mode``'s SASS instructions a chain step, by opcode: the difference
    of its ``long``- and ``short``-step builds in :func:`sass_counts`'s
    ``counts`` over the steps between them, the opcodes with none left
    out, the one most added first."""
    lo, sh = counts[(mode, long)], counts[(mode, short)]
    return {op: (lo[op] - sh[op]) / (long - short)
            for op in sorted(set(lo) | set(sh), key=lambda op: sh[op] - lo[op])
            if lo[op] != sh[op]}


def issue_ms(per_step: dict, steps: int, elements: int) -> float:
    """The least time ``steps`` chained steps over ``elements`` issue in, by
    the SASS counts a step (``per_step``): each opcode on its pipe at the
    rate this probe measured, and all of them through the issue slots
    (:func:`qnx_torch.bench.roofline.issue_times`)."""
    times = issue_times({op: c * steps * elements for op, c in per_step.items()})
    return max(times.values()) * 1e3


def main(shape=SHAPE, iters: int = 64, repeats: int = 3, device="cuda") -> list[dict]:
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-2**31, 2**31, shape, dtype=np.int64)
                         .astype(np.int32)).to(device)
    y = torch.from_numpy(rng.integers(-2**31, 2**31, shape, dtype=np.int64)
                         .astype(np.int32)).to(device)
    n = x.numel()
    lengths = sorted({r for pair in PAIRS for r in pair}, reverse=True)
    print(f"# vpu_probe {tuple(shape)} int32, " + " and ".join(
        f"{lo} against {sh} steps" for lo, sh in PAIRS) + f", on {device_label(device)}",
        flush=True)
    if device.type == "cuda":
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows = []
    for mode in MODES:
        # graph replays: the short chain's device time is near a host launch
        timing = dict(iters=iters, repeats=repeats, device=device, graph=True)
        if device.type == "cuda":
            with SmClock(device.index) as clock:
                t = {r: time_fn_marginal(int_chain, x, y, mode, r, **timing)
                     for r in lengths}
                # keep the long chain running until the clock has been read
                deadline = time.perf_counter() + 10
                while len(clock.samples) < 3 and time.perf_counter() < deadline:
                    for _ in range(20):
                        int_chain(x, y, mode, lengths[0])
                    torch.cuda.synchronize(device)
            mhz = statistics.median(clock.samples) if clock.samples else None
        else:
            t = {r: time_fn_marginal(int_chain, x, y, mode, r, **timing) for r in lengths}
            mhz = None
        row = {"mode": mode, "sm_clock_mhz": mhz, "us": {r: t[r] * 1e6 for r in lengths},
               "bytes_ms": BYTES_PER_ELEMENT * n / H100_PEAKS["hbm_bytes"] * 1e3}
        for prefix, (long, short) in zip(("", "jax_"), PAIRS):
            dt = t[long] - t[short]
            steps_per_s = n * (long - short) / dt if dt > 0 else float("nan")
            row[prefix + "ps_per_elem_step"] = 1e12 / steps_per_s
            row[prefix + "elem_steps_per_s_1e12"] = steps_per_s / 1e12
            row[prefix + "steps_per_clock_per_sm"] = (
                steps_per_s / (mhz * 1e6 * sms) if mhz and device.type == "cuda" else None)
        rows.append(row)
        clock_txt = lambda v: ("clock not measured" if v is None else
                               f"{v:6.2f} per clock per SM at {mhz:.0f} MHz")
        print(f"{mode:7s}: " + "; ".join(
            f"{lo} - {sh} steps {row[p + 'ps_per_elem_step']:8.4f} ps/elem/step "
            f"({row[p + 'elem_steps_per_s_1e12']:6.2f} T elem-steps/s, "
            f"{clock_txt(row[p + 'steps_per_clock_per_sm'])})"
            for p, (lo, sh) in zip(("", "jax_"), PAIRS))
            + "  [" + ", ".join(f"{r} steps {row['us'][r]:8.1f} us" for r in lengths)
            + "]", flush=True)
    if device.type == "cuda":
        from qnx_torch.kernels import _build

        counts = sass_counts(_build.library_path())
        for row in rows:
            mode = row["mode"]
            if any((mode, r) not in counts for r in lengths):
                print(f"{mode:7s}: SASS not read (cuobjdump missing)", flush=True)
                continue
            for prefix, (long, short) in zip(("", "jax_"), PAIRS):
                row[prefix + "sass_per_step"] = sass_per_step(counts, mode, long, short)
            per_step, rate = row["sass_per_step"], row["steps_per_clock_per_sm"]
            if rate is not None:
                row["per_clock_per_sm"] = {op: c * rate for op, c in per_step.items()}
            row["issue_ms"] = {r: issue_ms(per_step, r, n) for r in (LONG, lengths[0])}
            print(f"{mode:7s}: SASS per element of the {lengths[0]}-step build: "
                  + ", ".join(f"{op} {c}" for op, c in counts[(mode, lengths[0])].most_common())
                  + "; per step: " + "; ".join(
                      f"{lo} - {sh} builds " + ", ".join(
                          f"{op} {c:g}" for op, c in row[p + "sass_per_step"].items())
                      for p, (lo, sh) in zip(("", "jax_"), PAIRS))
                  + ("" if rate is None else "; per clock per SM (384 - 128): " + ", ".join(
                      f"{op} {v:.2f}" for op, v in row["per_clock_per_sm"].items()))
                  + f"; bound at {LONG} steps {max(row['bytes_ms'], row['issue_ms'][LONG]):.4f}"
                  f" ms (bytes {row['bytes_ms']:.4f}, issue {row['issue_ms'][LONG]:.4f}), at "
                  f"{lengths[0]} steps {max(row['bytes_ms'], row['issue_ms'][lengths[0]]):.4f}"
                  f" ms (issue {row['issue_ms'][lengths[0]]:.4f})", flush=True)
    return rows


if __name__ == "__main__":
    main()
