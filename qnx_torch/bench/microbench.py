"""Microbenchmark harness on the card (torch port of
:mod:`qnx.bench.microbench`).

A call's device time is read from CUDA events around a run of calls: an
``iters``-long chain and a single call, and ``(long - short) / (iters - 1)``
is the marginal time of one call, with the launch and the first call's
latency stripped.  The JAX harness's workarounds for XLA and the remote TPU
are not carried over: on the card an eager call is neither dead-code
eliminated nor hoisted, so no carry threads the calls, and the events
synchronise, so no readback does.

The card's own traps.  Its 50 MB L2 cache holds the operands of every
repeat of a kernel whose inputs are smaller than that, so a marginal time
is an **L2-warm** time, not the time a caller with cold operands would see:
:func:`l2_warm` says whether the operands fit, and the callers print it
beside the result.  And a chain whose calls take less device time than
their launch on the host (tens of microseconds through the Python wrappers)
measures the host: ``graph=True`` captures each chain once in a CUDA graph
and times its replay, which launches the calls without the host.

Every entry point takes ``device``, the card by default; without a card it
raises.  ``device="cpu"`` times with ``time.perf_counter`` around torch CPU
ops and is for the tests only: no CPU number is a device time.
"""
from __future__ import annotations

import subprocess
import time
from typing import Callable

import torch

#: L2 cache of one H100 (NVIDIA's data sheet)
L2_BYTES = 50 * 2**20


def resolve_device(device) -> torch.device:
    """``device`` as a torch device; raises for a CUDA device without a card
    and for any device but the card and the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card (torch.cuda.is_available() is False); "
                               "device='cpu' is the tests' route")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"no timing route for device {device}")
    return device


def device_label(device) -> str:
    """The card's ``name, power.limit`` as ``nvidia-smi`` prints them, or a
    label saying the numbers are not a device's."""
    device = resolve_device(device)
    if device.type == "cpu":
        return "cpu (torch CPU ops: not a device measurement)"
    proc = subprocess.run(["nvidia-smi", f"--id={device.index}",
                           "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60)
    return proc.stdout.strip().splitlines()[0]


def l2_warm(*tensors: torch.Tensor) -> bool:
    """True where the tensors fit in the card's L2 together, so repeats of a
    call on them read L2 and not device memory."""
    return sum(t.numel() * t.element_size() for t in tensors) < L2_BYTES


def _seconds(device: torch.device, fn: Callable, args: tuple, n: int) -> float:
    """Seconds of ``n`` back-to-back calls of ``fn(*args)``: CUDA events on
    the card, the host clock on the CPU."""
    if device.type == "cuda":
        with torch.cuda.device(device):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn(*args)
            end.record()
            end.synchronize()
        return start.elapsed_time(end) * 1e-3
    t0 = time.perf_counter()
    for _ in range(n):
        fn(*args)
    return time.perf_counter() - t0


def _graph(device: torch.device, fn: Callable, args: tuple, n: int) -> Callable:
    """The replay of a CUDA graph that captured ``n`` calls of ``fn(*args)``
    after a warm-up call on a side stream; its outputs live in the graph's
    own memory pool."""
    with torch.cuda.device(device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*args)
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(n):
                fn(*args)
    return g.replay


def _timer(device: torch.device, fn: Callable, args: tuple, n: int,
           graph: bool) -> Callable[[], float]:
    """A function returning the seconds of one run of ``n`` calls: the calls
    themselves, or (``graph`` on the card) one replay of their graph."""
    if not (graph and device.type == "cuda"):
        return lambda: _seconds(device, fn, args, n)
    replay = _graph(device, fn, args, n)
    return lambda: _seconds(device, replay, (), 1)


def summarize(long: list[float], short: list[float], iters: int) -> dict:
    """The marginal estimate from paired long (``iters`` calls) and short
    (one call) timings, the arithmetic of the JAX harness
    (``qnx/bench/microbench.py:144-165``): ``t`` is (min long - min short)
    / (iters - 1); ``samples`` the sorted per-round paired differences,
    ``median`` their median and ``spread`` (max - min) / median.  Where
    ``t`` comes out non-positive and the median does not, ``t`` is the
    median; where both are non-positive both are clamped to 1e-9 s.  Either
    way ``unreliable`` is True."""
    samples = sorted((tl - ts) / (iters - 1) for tl, ts in zip(long, short))
    median = samples[len(samples) // 2]
    est = (min(long) - min(short)) / (iters - 1)
    unreliable = not (est > 0 and median > 0)
    if est <= 0 < median:
        est = median
    return {
        "t": max(est, 1e-9),
        "median": max(median, 1e-9),
        "samples": samples,
        "spread": (samples[-1] - samples[0]) / median if median > 0 else 0.0,
        "unreliable": unreliable,
    }


def time_fns_marginal_interleaved(targets: dict, *, iters: int = 32,
                                  repeats: int = 5, device="cuda",
                                  graph: bool = False) -> dict:
    """Marginal per-call time of several targets, measured interleaved so a
    drift of clock or host load hits every target alike.

    ``targets``: ``{name: (fn, args_tuple)}``.  Each target is called once
    as a warm-up (the first call builds the kernels; with ``graph`` its
    chains are captured); then ``repeats`` rounds run round-robin over the
    targets, each timing the ``iters``-long chain and the single call back
    to back.  Returns ``{name: summarize(...)}``: ``t``, ``median``,
    ``samples``, ``spread``, ``unreliable``."""
    if iters < 2:
        raise ValueError("iters must be at least 2")
    device = resolve_device(device)
    timers = {}
    for name, (fn, args) in targets.items():
        fn(*args)
        timers[name] = (_timer(device, fn, args, iters, graph),
                        _timer(device, fn, args, 1, graph))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    raw = {name: ([], []) for name in targets}
    for _ in range(repeats):
        for name, (long, short) in timers.items():
            raw[name][0].append(long())
            raw[name][1].append(short())
    return {name: summarize(lo, sh, iters) for name, (lo, sh) in raw.items()}


def time_fn_marginal(fn: Callable, *args, iters: int | None = None,
                     repeats: int = 3, target_s: float = 0.15,
                     device="cuda", graph: bool = False) -> float:
    """Marginal per-call seconds of ``fn(*args)``: min over ``repeats`` of an
    ``iters``-long chain less min of a single call, over ``iters - 1``.
    ``iters=None`` scales the chain to about ``target_s`` seconds (16 to
    2048 calls).  ``graph``: time CUDA graph replays of the chains."""
    device = resolve_device(device)

    def measure(n: int, reps: int) -> float:
        fn(*args)
        long = _timer(device, fn, args, n, graph)
        short = _timer(device, fn, args, 1, graph)
        t_long = t_short = float("inf")
        for _ in range(reps):
            t_long = min(t_long, long())
            t_short = min(t_short, short())
        return (t_long - t_short) / (n - 1)

    if iters is not None:
        return measure(iters, repeats)
    est = measure(16, 1)
    if not est > 0:
        est = 1e-4
    return measure(max(16, min(2048, int(target_s / est))), repeats)


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2,
            device="cuda") -> float:
    """Host seconds per call of ``fn(*args)``, each call waited for
    (``torch.cuda.synchronize``): what a caller that needs the result on the
    host sees, launch included."""
    device = resolve_device(device)

    def call():
        fn(*args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(warmup):
        call()
    t0 = time.perf_counter()
    for _ in range(iters):
        call()
    return (time.perf_counter() - t0) / iters


def chain_time(call: Callable, x: torch.Tensor, w, *, mix: Callable,
               acc0: torch.Tensor, iters: int = 8, repeats: int = 3) -> float:
    """Marginal seconds per call of ``call(mix(x, carry), w)`` where each
    call's input depends on the last one's output (carry = running sum of
    ``|out|``), on ``x``'s device: min of the ``iters``-long chain less min
    of the single call, over ``iters - 1``."""
    device = resolve_device(x.device)

    def chain(n: int):
        carry = acc0
        for _ in range(n):
            out = call(mix(x, carry), w)
            carry = carry + out.abs().float().sum()
        return carry

    chain(1)
    t_long = t_short = float("inf")
    for _ in range(repeats):
        t_long = min(t_long, _seconds(device, chain, (iters,), 1))
        t_short = min(t_short, _seconds(device, chain, (1,), 1))
    return (t_long - t_short) / (iters - 1)


def gemm_tmacs(m: int, n: int, k: int, seconds: float) -> float:
    """Effective tera-MACs/s of an (m, k) x (k, n) product."""
    return m * n * k / seconds / 1e12
