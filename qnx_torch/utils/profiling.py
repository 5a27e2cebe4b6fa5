"""Tracing and step timing (torch port of :mod:`qnx.utils.profiling`).

* :func:`trace`: ``torch.profiler.profile`` over the CPU and, with a card,
  CUDA activities, exported as a Chrome trace (``trace.json``, open it in
  Perfetto or ``chrome://tracing``) into ``log_dir``; spans from
  :func:`annotate` show up by name.
* :func:`annotate`: a named span, ``torch.profiler.record_function`` plus
  an NVTX range on the card.
* :class:`StepTimer`: wall-clock step timing with JSONL output through
  :class:`qnx_torch.utils.metrics.MetricsLogger`; ``stop(sync=...)``
  waits for the device through the value it is given, so a step covers
  the device's work and not only its launch.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

from qnx_torch.utils.metrics import MetricsLogger

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a host (+ device) profile into ``log_dir/trace.json``.

    Example::

        with profiling.trace("runs/trace"):
            logits = i8_forward(model, images)
            logits.cpu()
    """
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str):
    """Named span visible in profiler timelines (host, and NVTX on the
    card)."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


def _sync(value) -> None:
    """Wait until ``value`` (a tensor or a nest of them) is computed: a
    CUDA value synchronizes its device; a CPU value is ready."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            torch.cuda.synchronize(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _sync(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _sync(v)


class StepTimer:
    """Per-step timing -> JSONL metrics.

    ``sync`` makes the step interval cover the device's work, not just its
    dispatch."""

    def __init__(self, logger: MetricsLogger | None = None,
                 name: str = "step"):
        self.logger = logger or MetricsLogger(None)
        self.name = name
        self._t = None
        self.history: list[float] = []

    def start(self):
        self._t = time.perf_counter()
        return self

    def stop(self, sync=None, **fields) -> float:
        if sync is not None:
            _sync(sync)
        dt = time.perf_counter() - self._t
        self.history.append(dt)
        self.logger.log(event=self.name, seconds=round(dt, 6), **fields)
        return dt

    @contextlib.contextmanager
    def step(self, **fields):
        """``with timer.step(batch=i): ...``; the caller synchronizes the
        body's output (or passes it to :meth:`stop`)."""
        self.start()
        try:
            yield self
        finally:
            self.stop(**fields)

    def summary(self) -> dict:
        import numpy as np

        if not self.history:
            return {"steps": 0}
        h = np.asarray(self.history)
        return {
            "steps": int(h.size),
            "mean_s": float(h.mean()),
            "p50_s": float(np.percentile(h, 50)),
            "p99_s": float(np.percentile(h, 99)),
        }
