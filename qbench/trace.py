"""The traced run's spans, put at the model's own stage boundaries from the
benchmark's side: forward hooks on the model's children (``first``,
``convs``, ``denses``, ``head``) and a ``forward=`` wrapper handed to the
serving engine.  Nothing inside the program changes.

Over a steady slice of the window the wrapper, which runs on the engine's
dispatcher thread, turns ``torch.profiler`` on and off (the CPU ops of that
thread and, on a card, every device activity through CUPTI), and the hooks
open a ``qbench.<stage>`` range and record a CUDA event at each boundary of
each forward.  The profiler's events are read in memory (no trace file is
written):

* a stage's device time is the summed duration of the kernels and copies
  that start inside that stage's device-side range;
* busy time is the union of all kernels and copies; the breakdown lists the
  device operations that took most time and the idle gaps by what the host
  was doing.

Where the profiler gives no device activity, stage times fall back to the
CUDA events' spans (which also count the device's waits for the host inside
a stage) and busy time to the summed forward spans.

The engine's counters are read at the slice's edges (``edges``): as the
profiler starts, and at the first forward after it stopped, once the batch
that paid for the stop has been counted.  A host-clock reading of the
traced run takes the window less that stretch, which holds the profiler's
cost.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

STAGES = ("first", "convs", "denses", "head")
PREFIX = "qbench."
BREAKDOWN_ROWS = 10
NAME_CHARS = 160
HOST_LOOKBACK = 256  # host ops searched back from a gap for the one open


class _HostMark:
    """A CPU run's stand-in for a CUDA event: the host clock (tests only)."""

    def __init__(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


class Tracer:
    """Spans of the forwards that run in the slice :meth:`arm` sets;
    ``counters()`` is read at its edges."""

    def __init__(self, model, device: torch.device, counters):
        self.device = device
        self.counters = counters
        self.edges: list = []
        self._edge_due = False
        self.forwards: list[dict] = []
        self.prof = None
        self.slice = None     # (start, stop) asked for, host clock
        self.window = None    # [started, stopped] as profiled
        self.active = False
        self._marks = None
        self._ranges: list = []
        parts = {"first": (model.first, model.first),
                 "convs": (model.convs[0], model.convs[-1]),
                 "denses": (model.denses[0], model.denses[-1]),
                 "head": (model.head, model.head)}
        for stage, (a, b) in parts.items():
            a.register_forward_pre_hook(self._enter(stage))
            b.register_forward_hook(self._leave(stage))

    def _mark(self):
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return _HostMark()

    def _enter(self, stage):
        def hook(module, args):
            if self._marks is not None:
                self._ranges.append(torch.autograd.profiler.record_function(
                    PREFIX + stage).__enter__())
                self._marks[f"{stage}.start"] = self._mark()
        return hook

    def _leave(self, stage):
        def hook(module, args, out):
            if self._marks is not None:
                self._marks[f"{stage}.end"] = self._mark()
                self._ranges.pop().__exit__(None, None, None)
        return hook

    # ---- the wrapper the engine calls, on its dispatcher thread ----

    def arm(self, start: float, seconds: float) -> None:
        """Trace the forwards that start in [start, start + seconds) on the
        host clock."""
        self.slice = (start, start + seconds)

    def warm(self, engine, images) -> None:
        """One forward under the profiler in set-up (and one more, at the
        start of which it stops), so that the first traced forward does not
        pay the profiler's start-up."""
        self.slice = (0.0, 0.0)
        engine.predict(images)
        engine.predict(images)
        self.forwards.clear()
        self.edges.clear()
        self._edge_due = False
        self.prof = self.window = self.slice = None

    def forward(self, model, x):
        if self._edge_due:
            self._edge()
        now = time.perf_counter()
        if self.slice is not None and self.window is None and now >= self.slice[0]:
            self._start()
        elif self.active and now >= self.slice[1]:
            self._stop()
        if not self.active:
            return model(x)
        self._marks = {}
        out = model(x)
        self.forwards.append(self._marks)
        self._marks = None
        return out

    def _edge(self):
        self._edge_due = False
        self.edges.append(self.counters())

    def _start(self):
        self._edge()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.active = True
        self.window = [time.perf_counter(), None]

    def _stop(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.window[1] = time.perf_counter()
        self.prof.stop()
        self.active = False
        self._edge_due = True

    def finish(self) -> None:
        """Close a slice that the window ended inside, and read its last
        edge (once the engine is idle)."""
        if self.active:
            self._stop()
        if self._edge_due:
            self._edge()

    # ---- readings ----

    def _spans(self) -> dict:
        """Mean ms a traced forward between each stage's CUDA events."""
        return {s: sum(f[f"{s}.start"].elapsed_time(f[f"{s}.end"])
                       for f in self.forwards) / len(self.forwards) for s in STAGES}

    def reading(self) -> dict:
        """The traced slice: ``stage_ms`` (device ms a forward of each stage,
        of ``dense_head`` and of the whole ``forward``) and its
        ``stage_source``, ``span_ms``, ``forwards``, ``window_s``,
        ``busy_s`` and its ``busy_source``, and the ``breakdown``."""
        if not self.forwards or self.window is None or self.window[1] is None:
            return {}
        spans = self._spans()
        dev, host = _events(self.prof)
        ops = [d for d in dev if not d[2].startswith(PREFIX)]
        ranges = {s: sorted((a, b) for a, b, n in dev if n == PREFIX + s)
                  for s in STAGES}
        out = {"span_ms": spans, "forwards": len(self.forwards),
               "window_s": self.window[1] - self.window[0],
               "device_events": len(ops), "host_events": len(host)}
        if ops and all(ranges.values()):
            stage = {s: _inside(ops, ranges[s]) / len(ranges[s]) / 1e6 for s in STAGES}
            out["stage_source"] = "profiler"
        else:
            stage, out["stage_source"] = dict(spans), "cuda_events"
        stage["dense_head"] = stage["denses"] + stage["head"]
        stage["forward"] = sum(stage[s] for s in STAGES)
        out["stage_ms"] = stage
        if ops:
            busy = _union(ops)
            out.update(busy_s=sum(b - a for a, b in busy) / 1e9, busy_source="profiler",
                       breakdown={"device_ops": _top_ops(ops),
                                  "idle_gaps": _idle_gaps(busy, host)})
        else:
            out.update(busy_s=sum(spans.values()) * len(self.forwards) / 1e3,
                       busy_source="cuda_events",
                       breakdown={"device_ops": [[f"stage {s}", spans[s] * len(
                           self.forwards) / 1e3] for s in STAGES], "idle_gaps": []})
        return out


def _events(prof):
    """(device, host) events of a stopped profiler as (start_ns, end_ns,
    name) tuples; host ones only of the thread the wrapper ran on (the one
    that opened the stage ranges), runtime calls included."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        row = (e.start_ns(), e.end_ns(), e.name())
        if "CUDA" in str(e.device_type()):
            if row[1] > row[0]:
                dev.append(row)
        else:
            host.append((*row, e.start_thread_id()))
    threads = {h[3] for h in host if h[2].startswith(PREFIX)}
    return dev, sorted(h[:3] for h in host if h[3] in threads)


def _inside(ops, ranges) -> int:
    """ns of the ops that start inside one of the sorted ``ranges``."""
    starts = [a for a, _ in ranges]
    total = 0
    for a, b, _ in ops:
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0 and a < ranges[i][1]:
            total += b - a
    return total


def _union(rows):
    merged = []
    for a, b, _ in sorted(rows):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _short(name: str) -> str:
    name = " ".join(name.split())
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def _top_ops(ops):
    total = defaultdict(float)
    for a, b, name in ops:
        total[_short(name)] += (b - a) / 1e9
    return sorted(([k, v] for k, v in total.items()), key=lambda r: -r[1])[:BREAKDOWN_ROWS]


def _idle_gaps(busy, host):
    """Idle seconds between device activities, summed by what the host was
    doing at each gap's midpoint: the innermost host op open then, or the
    Python that ran after the host op that had ended last."""
    starts = [h[0] for h in host]
    total = defaultdict(float)
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid)
        near = host[max(0, i - HOST_LOOKBACK):i]
        open_ = [h for h in near if h[1] >= mid]
        if open_:  # the latest to start of those still open is innermost
            label = open_[-1][2]
        elif near:
            label = "python after " + max(near, key=lambda h: h[1])[2]
        else:
            label = "python"
        total[_short(label)] += (b - a) / 1e9
    return sorted(([k, v] for k, v in total.items()), key=lambda r: -r[1])[:BREAKDOWN_ROWS]
