"""Integer issue-rate probe on the card (the port of
``experiments/vpu_probe.py``).

For each of the six steps of kernel H (:mod:`qnx_torch.kernels.int_probe`)
it times a chain of LONG = 96 and of SHORT = 32 steps over the JAX file's
4096 x 1024 int32 elements and differences them, which strips the launch and
the loads: ps per element-step, element-steps per second, and steps per
clock per SM at the SM clock ``nvidia-smi`` reads while the chains run.  For
the popc steps (``pc``, ``pconly``) that is the popc issue rate, the
ceiling of every popcount kernel on the CUDA cores.  It also counts, in the
built library's SASS (``cuobjdump -sass``), the instructions of each
chain's LONG and SHORT builds, to show that the compiler neither folded nor
hoisted the chain.

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
from qnx_torch.kernels.int_probe import MODES, int_chain

SHAPE = (256 * 16, 1024)  # the JAX file's BLOCK (256, 1024) x GRID 16
LONG, SHORT = 96, 32


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


def main(shape=SHAPE, iters: int = 64, repeats: int = 3, device="cuda") -> list[dict]:
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-2**31, 2**31, shape, dtype=np.int64)
                         .astype(np.int32)).to(device)
    y = torch.from_numpy(rng.integers(-2**31, 2**31, shape, dtype=np.int64)
                         .astype(np.int32)).to(device)
    n, long, short = x.numel(), LONG, SHORT
    print(f"# vpu_probe {tuple(shape)} int32, {long} against {short} steps, on "
          f"{device_label(device)}", flush=True)
    if device.type == "cuda":
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows = []
    for mode in MODES:
        # graph replays: the short chain's device time is near a host launch
        timing = dict(iters=iters, repeats=repeats, device=device, graph=True)
        if device.type == "cuda":
            with SmClock(device.index) as clock:
                t_long = time_fn_marginal(int_chain, x, y, mode, long, **timing)
                t_short = time_fn_marginal(int_chain, x, y, mode, short, **timing)
                # keep the long chain running until the clock has been read
                deadline = time.perf_counter() + 10
                while len(clock.samples) < 3 and time.perf_counter() < deadline:
                    for _ in range(20):
                        int_chain(x, y, mode, long)
                    torch.cuda.synchronize(device)
            mhz = statistics.median(clock.samples) if clock.samples else None
        else:
            t_long = time_fn_marginal(int_chain, x, y, mode, long, **timing)
            t_short = time_fn_marginal(int_chain, x, y, mode, short, **timing)
            mhz = None
        dt = t_long - t_short
        steps_per_s = n * (long - short) / dt if dt > 0 else float("nan")
        per_clock = (steps_per_s / (mhz * 1e6 * sms)
                     if mhz and device.type == "cuda" else None)
        row = {"mode": mode, "ps_per_elem_step": 1e12 / steps_per_s,
               "elem_steps_per_s_1e12": steps_per_s / 1e12,
               "steps_per_clock_per_sm": per_clock, "sm_clock_mhz": mhz,
               "long_us": t_long * 1e6, "short_us": t_short * 1e6}
        rows.append(row)
        clock_txt = ("clock not measured" if per_clock is None else
                     f"{per_clock:6.2f} per clock per SM at {mhz:.0f} MHz")
        print(f"{mode:7s}: {row['ps_per_elem_step']:8.4f} ps/elem/step  "
              f"({row['elem_steps_per_s_1e12']:6.2f} T elem-steps/s, {clock_txt})  "
              f"[long {row['long_us']:8.1f} us, short {row['short_us']:8.1f} us]",
              flush=True)
    if device.type == "cuda":
        from qnx_torch.kernels import _build

        counts = sass_counts(_build.library_path())
        for mode in MODES:
            lo, sh = counts.get((mode, long)), counts.get((mode, short))
            if lo is None or sh is None:
                print(f"{mode:7s}: SASS not read (cuobjdump missing)", flush=True)
                continue
            ops = sorted(set(lo) | set(sh), key=lambda op: -(lo[op] - sh[op]))
            per_step = ", ".join(f"{op} {(lo[op] - sh[op]) / (long - short):g}"
                                 for op in ops if lo[op] != sh[op])
            print(f"{mode:7s}: SASS per element of the {long}-step build: "
                  + ", ".join(f"{op} {lo[op]}" for op in ops if lo[op])
                  + f"; per step ({long} - {short} builds): {per_step}", flush=True)
            next(r for r in rows if r["mode"] == mode)["sass_per_step"] = {
                op: (lo[op] - sh[op]) / (long - short) for op in ops if lo[op] != sh[op]}
    return rows


if __name__ == "__main__":
    main()
