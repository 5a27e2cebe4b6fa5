"""Continuous-batching serving engine (torch port of :mod:`qnx.serve.engine`).

Requests (single images or micro-batches) land in a host-side queue; a
dispatcher thread drains up to ``batch_size`` images, carrying over the
rest of a chunk that does not fit, pads the tail to the static batch and
answers per-request futures.  The dispatcher decides when a batch forms and
is answered; the route picked when the engine is built decides where it
runs (:mod:`qnx_torch.serve.routes`: the CPU, a card, or a mesh's ranks).

Two batches are in flight: each turn of the dispatcher drains and forms
batch k, launches it, and only then waits for batch k-1's logits and
answers its futures, so that on a card the host forms the next batch while
the device runs the last one's forward.  A mesh's route is ``serial``: its
batches are ordered broadcasts, so each is answered before the next forms.
No answer waits on an empty queue, where a client that sends once it is
answered would wait out the linger: where the queue holds nothing and no
carry is left, the dispatcher answers the batch in flight before it blocks,
and ``stop()`` answers it too; lingering on an empty queue, it answers a
batch in flight whose logits are on the host already, and lingers anew.

While engines serve, what outlived their set-up sits in the collector's
permanent generation (``gc.freeze()``), so that a full collection walks
only what serving makes (the futures in flight, the chunks) and not every
object the imports of torch and numpy left.  The first leader started in
the process freezes, and each engine freezes once more when its first
batch's logits are on the host, before its futures are set, since the
first forward loads modules lazily.  The last one stopped unfreezes (which
also thaws the tuples CPython 3.12 freezes at start-up).  Where something
else had frozen objects before the first engine started (more than were
frozen when this module was imported), the engines neither freeze nor
unfreeze.  None of the engine's per-request objects forms a cycle, so a
frozen future is still freed when its last reference goes.
"""
from __future__ import annotations

import gc
import queue
import random
import threading
import time
import weakref
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch

from qnx_torch.native import u8_to_f32
from qnx_torch.serve import routes
from qnx_torch.serve.routes import normalize_u8  # noqa: F401 (the JAX engine's name)
from qnx_torch.utils import profiling

#: Cap on retained latency samples — the engine runs indefinitely, so stats
#: use reservoir sampling instead of an unbounded list.
LATENCY_RESERVOIR = 8192

#: Cap on the stages and collector pauses an engine's timeline keeps: at
#: four stages and about ten collections a batch, a few thousand batches.
TIMELINE = 1 << 16

#: How often a dispatcher lingering on an empty queue looks whether the
#: batch in flight has its logits on the host yet.
_LOOK_AGAIN_S = 0.5e-3

_STAGES = ("drain", "enqueue", "wait", "resolve")
_GC_RANGES = tuple(f"qnx.gc.gen{g}" for g in range(3))

_last_started = None  # a weak reference to the engine started last

# the collector's freeze is the process's, so the engines share its owner;
# CPython 3.12 keeps a few hundred tuples of its static types frozen from
# start-up, which count as nothing frozen
_FROZEN_AT_IMPORT = gc.get_freeze_count()
_freeze_lock = threading.Lock()
_serving = 0       # leaders started and not stopped
_freezing = False  # they froze (nothing else had): the last one unfreezes


def last_started() -> "ServeEngine | None":
    """The engine this process started last, while it lives."""
    return _last_started() if _last_started is not None else None


def _fail(chunks, error: Exception) -> None:
    """Resolve, never leak, the futures of a batch that failed."""
    for _, futs, *_ in chunks:
        for fut in futs:
            if not fut.done():
                fut.set_exception(error)


@dataclass
class _InFlight:
    """A batch launched and not yet answered."""
    chunks: list
    batch: int      # its id
    images: int     # and its images, less the padding
    pad: int
    t0: int         # ns, its dispatch
    logits: torch.Tensor  # as the route's ``launch`` gave them
    ready: object         # and the event behind them, or None


@dataclass
class ServeStats:
    """The engine's counters.  The dispatcher's cycle is four stages, timed
    always, that divide its time exactly: ``drain_ns``, batch k's drain,
    queue waits, linger, concatenation and padding; ``enqueue_ns``, its copy
    to the device, the normalisation and the forward's launches (on a card,
    without waiting for them); ``wait_ns``, waiting for batch k-1's logits
    on the host, which waits for the device; ``resolve_ns``, setting batch
    k-1's futures.  A batch's ``total_batch_ms`` runs from its dispatch to
    its logits on the host, so the times of batches in flight together
    overlap.  The collector's pauses on any thread while the engine runs
    (``gc_ns``, ``gc_collections_0/1/2``) overlap the stages.  A request's
    id, in the profiler's ranges, is its place in the queue's order, which
    a chunk split over two batches keeps.  ``gc_frozen`` counts the objects
    the engine's freezes moved out of the collector's walk (less any
    another thread frees while it reads the count)."""
    batches: int = 0
    images: int = 0
    padded: int = 0
    total_batch_ms: float = 0.0  # from dispatch to the logits on the host
    requests: int = 0  # answered in full
    overlapped: int = 0  # batches launched while another was in flight
    # the dispatcher's cycle, in ns
    drain_ns: int = 0
    enqueue_ns: int = 0
    wait_ns: int = 0
    resolve_ns: int = 0
    # the collector's pauses on any thread while the engine runs
    gc_ns: int = 0
    gc_collections_0: int = 0
    gc_collections_1: int = 0
    gc_collections_2: int = 0
    gc_frozen: int = 0
    first_dispatch: float | None = None  # perf_counter of the first batch
    last_answer: float = 0.0  # perf_counter after the last batch's futures
    latencies_ms: list = field(default_factory=list)
    # (counter, start ns, end ns) of the last stages and collector pauses
    timeline: deque = field(default_factory=lambda: deque(maxlen=TIMELINE))
    _rng: random.Random = field(default_factory=lambda: random.Random(0))
    _gc_start: int | None = None
    _gc_range: object = None

    COUNTERS = ("batches", "images", "padded", "total_batch_ms", "requests",
                "overlapped", *(f"{s}_ns" for s in _STAGES), "gc_ns",
                *(f"gc_collections_{g}" for g in range(3)), "gc_frozen")

    def record_latency(self, lat_ms: float) -> None:
        """Count an answered request and reservoir-sample its latency, so
        memory stays O(LATENCY_RESERVOIR) over an unbounded serving
        lifetime; percentiles remain unbiased."""
        self.requests += 1
        if len(self.latencies_ms) < LATENCY_RESERVOIR:
            self.latencies_ms.append(lat_ms)
        else:
            j = self._rng.randrange(self.requests)
            if j < LATENCY_RESERVOIR:
                self.latencies_ms[j] = lat_ms

    def on_gc(self, phase: str, info: dict) -> None:
        """A ``gc.callbacks`` entry: time each collection, and while a
        profiler records, open ``qnx.gc.gen<g>`` over it on the thread
        that runs it."""
        if phase == "start":
            self._gc_start = time.perf_counter_ns()
            if profiling.recording():
                self._gc_range = profiling.span(_GC_RANGES[info["generation"]])
                self._gc_range.__enter__()
            return
        if self._gc_range is not None:
            self._gc_range.__exit__(None, None, None)
            self._gc_range = None
        if self._gc_start is not None:
            end = time.perf_counter_ns()
            self.gc_ns += end - self._gc_start
            self.timeline.append(("gc_ns", self._gc_start, end))
            self._gc_start = None
            name = f"gc_collections_{info['generation']}"
            setattr(self, name, getattr(self, name) + 1)

    def counters(self) -> dict:
        return {k: getattr(self, k) for k in self.COUNTERS}

    def summary(self) -> dict:
        """``throughput_ips`` is images over the summed busy time of the
        batches (the JAX engine's figure); ``wall_throughput_ips`` is images
        over the host clock from the first batch's dispatch to the last
        batch's answers, so it also counts the dispatcher's gaps.  Latency
        is a request's, from ``submit_many`` to its last image's logits on
        the host.  ``stage_ms``: host ms a batch of each stage of the
        dispatcher's cycle; ``gc``: the collector's collections by
        generation and its pauses in ms, while the engine ran, and the
        objects the engine froze."""
        lat = np.asarray(self.latencies_ms) if self.latencies_ms else np.zeros(1)
        busy_s = self.total_batch_ms / 1e3
        wall_s = (self.last_answer - self.first_dispatch
                  if self.first_dispatch is not None else 0.0)
        per_batch = 1e6 * max(self.batches, 1)
        return {
            "batches": self.batches,
            "overlapped": self.overlapped,
            "images": self.images,
            "pad_fraction": self.padded / max(self.images + self.padded, 1),
            "throughput_ips": self.images / busy_s if busy_s > 0 else 0.0,
            "wall_throughput_ips": self.images / wall_s if wall_s > 0 else 0.0,
            "latency_ms_p50": float(np.percentile(lat, 50)),
            "latency_ms_p99": float(np.percentile(lat, 99)),
            "latency_samples": self.requests,
            "stage_ms": {s: getattr(self, f"{s}_ns") / per_batch for s in _STAGES},
            "gc": {"collections": [self.gc_collections_0, self.gc_collections_1,
                                   self.gc_collections_2],
                   "pause_ms": self.gc_ns / 1e6, "frozen": self.gc_frozen},
        }


class ServeEngine:
    """Continuous-batching inference engine over a packed model.

    Args:
      model: packed ``nn.Module`` (images -> logits), already on its device.
      batch_size: static device batch (requests are padded up to it).
      mesh: None (one process), or the world's (data, model)
        ``DeviceMesh``: :class:`qnx_torch.serve.routes.MeshRoute`.
      max_wait_ms: dispatcher linger — how long to wait to fill a batch
        before flushing a partial one.
      forward: ``forward(model, x)`` on the normalised device batch; None
        means ``model(x)``, or under a mesh the ring TP forward where the
        model takes it.  A given forward runs on the replicated path under
        a mesh.  It runs under ``torch.inference_mode()``.
      device_normalize: ship an all-uint8 batch raw (4x fewer bytes to the
        device than float32) and normalise it there; else (and for a batch
        that mixes uint8 and float32 chunks) the uint8 chunks are normalised
        on the host by :func:`qnx_torch.native.u8_to_f32`, to the same bits.
      max_queue: bound on queued request *chunks* (backpressure). When the
        queue is full, ``submit``/``submit_many`` block until there is room
        (or raise ``queue.Full`` after ``timeout`` seconds if one is given).
        ``None`` = unbounded.
    """

    def __init__(self, model, batch_size: int = 256, mesh=None,
                 max_wait_ms: float = 2.0, forward=None,
                 device_normalize: bool = True,
                 max_queue: int | None = 1024):
        self.batch_size = batch_size
        self.max_wait_ms = max_wait_ms
        self.device_normalize = device_normalize
        self.route = route = routes.pick(model.eval(), batch_size, mesh, forward)
        # the served model (the ring's local one under a mesh) and its path
        self.model, self.forward_path = route.model, route.forward_path
        self.backend, self.transport = route.backend, route.transport
        self.leader = route.leader  # it owns the queue and answers
        self._queue: queue.Queue = queue.Queue(maxsize=max_queue or 0)
        self._carry = None   # split-chunk remainder (dispatcher-only)
        self._inflight: _InFlight | None = None  # dispatcher-only
        self._next_request = 0  # the id of the next request taken
        self._next_batch = 0    # and of the next batch formed
        # the dispatcher's running stage's counter and start (ns), or None
        self._running: tuple | None = None
        self._running_lock = threading.Lock()
        self._stats = ServeStats()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._serving = False   # counted in the module's ``_serving``
        self._closed = None     # why submit_many refuses, on a follower
        if not route.leader:
            route.follow()  # returns at rank 0's stop()
            self._closed = ("a follower rank serves no requests; submit to "
                            "rank 0's engine")

    # ---------------- public API ----------------

    def start(self):
        if self._closed:
            return self  # a follower has served and stopped already
        self._stop.clear()
        if self._stats.on_gc not in gc.callbacks:
            gc.callbacks.append(self._stats.on_gc)
        self._lap("drain_ns")
        global _last_started, _serving, _freezing
        with _freeze_lock:
            if not self._serving:
                if _serving == 0:
                    _freezing = gc.get_freeze_count() <= _FROZEN_AT_IMPORT
                    if _freezing:
                        self._freeze()
                _serving += 1
                self._serving = True
        _last_started = weakref.ref(self)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        """Stop the dispatcher, which first answers the batch in flight, and
        CANCEL all still-queued requests, so every future handed out by
        submit/submit_many is resolved one way or another."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        global _serving, _freezing
        with _freeze_lock:
            if self._serving:
                self._serving = False
                _serving -= 1
                if _serving == 0 and _freezing:
                    _freezing = False
                    gc.unfreeze()
        if self._stats.on_gc in gc.callbacks:
            gc.callbacks.remove(self._stats.on_gc)
        self.route.release()  # a mesh's followers stop
        pending = []
        if self._inflight is not None:  # a dispatcher that did not end
            pending.extend(self._inflight.chunks)
            self._inflight = None
        if self._carry is not None:
            pending.append(self._carry)
            self._carry = None
        while True:
            try:
                pending.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for _, futs, *_ in pending:
            for fut in futs:
                fut.cancel()

    def submit(self, image: np.ndarray, timeout: float | None = None) -> Future:
        """Enqueue one image; resolves to its logits (np.ndarray)."""
        return self.submit_many(np.asarray(image)[None], timeout=timeout)[0]

    def submit_many(self, images: np.ndarray,
                    timeout: float | None = None) -> list[Future]:
        """Enqueue a chunk of images as ONE queue item.  A full queue blocks
        (backpressure); ``timeout`` seconds turns the block into
        ``queue.Full``."""
        if self._closed or self._stop.is_set():
            raise RuntimeError(self._closed or "engine is stopped")
        images = np.asarray(images)
        if images.dtype != np.uint8:
            images = np.asarray(images, np.float32)
        futs = [Future() for _ in range(len(images))]
        self._queue.put((images, futs, time.perf_counter_ns()), timeout=timeout)
        return futs

    def predict(self, images: np.ndarray) -> np.ndarray:
        """Synchronous convenience: batch of images -> logits."""
        futs = self.submit_many(images)
        return np.stack([f.result(timeout=300) for f in futs])

    def counters(self) -> dict:
        """The engine's cumulative counters, flat (``ServeStats.COUNTERS``).
        The running stage counts up to this call, so that between two
        calls the stages add up to the time between them."""
        with self._running_lock:
            out = self._stats.counters()
            if self._running is not None:
                stage, start = self._running
                out[stage] += time.perf_counter_ns() - start
        return out

    def between(self, since: float, until: float) -> dict | None:
        """The ns of each stage (``drain_ns``, ``enqueue_ns``, ``wait_ns``,
        ``resolve_ns``) and of the collector's pauses (``gc_ns``) that fell
        between two ``time.perf_counter()`` readings, from the timeline,
        the running stage counted up to this call; None where the timeline
        no longer reaches back to ``since``."""
        lo, hi = round(since * 1e9), round(until * 1e9)
        with self._running_lock:
            records = list(self._stats.timeline)
            full = len(records) == TIMELINE
            if self._running is not None:
                records.append((*self._running, time.perf_counter_ns()))
        if full and records[0][1] > lo:
            return None
        out = dict.fromkeys((*(f"{s}_ns" for s in _STAGES), "gc_ns"), 0)
        for key, start, end in records:
            if start < hi and end > lo:
                out[key] += min(end, hi) - max(start, lo)
        return out

    def stats(self) -> dict:
        """The batches' figures (``ServeStats.summary``: throughput,
        request latency, ``stage_ms`` and ``gc``), the path the forward
        took, and under a mesh the backend, transport and world."""
        return {**self._stats.summary(), "forward_path": self.forward_path,
                **self.route.stats()}

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ---------------- dispatcher ----------------

    def _drain(self):
        """Collect request CHUNKS totaling up to batch_size images,
        lingering max_wait_ms. A chunk larger than the remaining room is
        split; the remainder carries over to the next batch.  A chunk is
        ``(images, futures, submitted_ns, request_id, last)``, ``last``
        when it ends its request.  Answers the batch in flight where no
        answer may wait (module docstring).  Returns the chunks and their
        images' count."""
        chunks: list = []
        total = 0

        def take(imgs, futs, t, rid):
            nonlocal total
            room = self.batch_size - total
            last = len(imgs) <= room
            if not last:
                self._carry = (imgs[room:], futs[room:], t, rid)
                imgs, futs = imgs[:room], futs[:room]
            chunks.append((imgs, futs, t, rid, last))
            total += len(imgs)

        def take_queued(timeout):
            item = self._queue.get(timeout=timeout)
            self._next_request += 1
            take(*item, self._next_request - 1)

        if self._carry is not None:
            item, self._carry = self._carry, None
            take(*item)
        if not chunks:
            if self._inflight is not None and self._queue.empty():
                self._settle()  # no answer waits on an empty queue
            try:
                take_queued(0.1)
            except queue.Empty:
                return chunks, total
        deadline = time.perf_counter() + self.max_wait_ms / 1e3
        while total < self.batch_size and self._carry is None:
            b = self._inflight
            if b is not None and self._queue.empty() and self.route.done(b):
                self._settle()  # its logits are on the host: answer, linger anew
                deadline = time.perf_counter() + self.max_wait_ms / 1e3
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            if self._inflight is not None:  # and look at it again soon
                remaining = min(remaining, _LOOK_AGAIN_S)
            try:
                take_queued(remaining)
            except queue.Empty:
                pass
        return chunks, total

    def _lap(self, then: str | None) -> int:
        """End the running stage, adding its ns to its counter, and start
        ``then`` (None: no stage runs); returns the clock (ns)."""
        now = time.perf_counter_ns()
        with self._running_lock:
            if self._running is not None:
                stage, start = self._running
                setattr(self._stats, stage, getattr(self._stats, stage) + now - start)
                self._stats.timeline.append((stage, start, now))
            self._running = (then, now) if then else None
        return now

    def _freeze(self):
        """Collect, so that no garbage is frozen, then move every object
        left into the collector's permanent generation (the caller holds
        ``_freeze_lock``)."""
        gc.collect()
        before = gc.get_freeze_count()
        gc.freeze()
        self._stats.gc_frozen += gc.get_freeze_count() - before

    def _loop(self):
        while not self._stop.is_set():
            chunks, launched = [], None  # nothing of a batch outlives a turn
            try:
                first = (self._carry[3] if self._carry is not None
                         else self._next_request)
                with profiling.span("qnx.serve.drain", batch=self._next_batch,
                                    first_request=first):
                    chunks, total = self._drain()
                    if not chunks:
                        continue
                    images, pad = self._host_batch(chunks, total)
                t0 = self._lap("enqueue_ns")
                if self._stats.first_dispatch is None:
                    self._stats.first_dispatch = t0 / 1e9
                launched = _InFlight(chunks, self._next_batch - 1, total, pad, t0,
                                     *self.route.launch(images))
            except Exception as e:  # this batch fails, and it alone
                _fail(chunks, e)
                if self._inflight is not None:  # before a batch takes its slot
                    self._settle()
                else:
                    self._lap("drain_ns")
                continue
            if self._inflight is not None:  # batch k-1, launched last turn
                self._stats.overlapped += 1
                self._settle()
            elif not self.route.serial:
                self._lap("drain_ns")
            self._inflight = launched
            if self.route.serial:  # answered before the next batch forms
                self._settle()
        if self._inflight is not None:
            self._settle()
        self._lap(None)

    def _host_batch(self, chunks, total):
        """The chunks as one static host batch, the route's: (images,
        padding).  A batch that is not all uint8 to be normalised on the
        device has its uint8 chunks normalised here, on the host."""
        self._next_batch += 1
        arrs = [imgs for imgs, *_ in chunks]
        if not (self.device_normalize
                and all(a.dtype == np.uint8 for a in arrs)):
            # normalise the uint8 chunks on the host (native runtime)
            arrs = [u8_to_f32(a) if a.dtype == np.uint8 else a for a in arrs]
        return self.route.stage(arrs, total)

    def _settle(self):
        """Wait for the batch in flight's logits (stage ``wait``) and answer
        its futures (``resolve``); the dispatcher drains next."""
        st, b, self._inflight = self._stats, self._inflight, None
        try:
            self._lap("wait_ns")
            logits = self.route.fetch(b)
            done = self._lap("resolve_ns")
            st.batches += 1
            st.images += b.images
            st.padded += b.pad
            st.total_batch_ms += (done - b.t0) / 1e6
            if st.batches == 1:  # what the first forward loaded outlives serving
                with _freeze_lock:
                    if self._serving and _freezing:
                        self._freeze()
            with profiling.span("qnx.serve.resolve", batch=b.batch,
                                first_request=b.chunks[0][3],
                                last_request=b.chunks[-1][3]):
                off = 0
                for _, futs, t_in, _, last in b.chunks:
                    if last:
                        st.record_latency((done - t_in) / 1e6)
                    for fut in futs:
                        fut.set_result(logits[off])
                        off += 1
        except Exception as e:  # this batch fails, and it alone
            _fail(b.chunks, e)
            self._lap("drain_ns")
            return
        st.last_answer = self._lap("drain_ns") / 1e9
