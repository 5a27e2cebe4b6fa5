"""Tracing (torch port of :mod:`qnx.utils.profiling`).

* :func:`trace`: ``torch.profiler.profile`` over the CPU and, with a card,
  CUDA activities, exported as a Chrome trace (``trace.json``, open it in
  Perfetto or ``chrome://tracing``) into ``log_dir``; spans from
  :func:`annotate` and :func:`span` show up by name.
* :func:`annotate`: a named span, ``torch.profiler.record_function`` plus
  an NVTX range on the card.
* :func:`recording` and :func:`span`: a host range with arguments that
  exists only while a profiler records, for code that runs on every
  request (``qnx_torch.serve.engine``): with no profiler, one flag read.
"""
from __future__ import annotations

import contextlib
import os

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a host (+ device) profile of every thread of the process (a
    serving engine's dispatcher as well as the caller) into
    ``log_dir/trace.json``.

    Example::

        with profiling.trace("runs/trace"):
            logits = i8_forward(model, images)
            logits.cpu()
    """
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(activities=acts,
                                experimental_config=every_thread) as prof:
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


def recording() -> bool:
    """Whether a torch profiler records anywhere in this process."""
    return torch.autograd.profiler._is_profiler_enabled


def span(name: str, **args: int):
    """A host range ``name`` on the profiler's clock while a profiler
    records, else a no-op context.  ``args`` (integers) show as the
    range's arguments where the profiler records shapes
    (``record_shapes=True``) on the range's own thread.  Meant for host
    work between launches: the serving engine puts none around a stage
    that launches device work, so no device event bears its names."""
    if not recording():
        return contextlib.nullcontext()
    return torch._C._profiler._RecordFunctionFast(name, (), args)
