"""Continuous-batching serving engine (torch port of :mod:`qnx.serve.engine`,
single device).

Requests (single images or micro-batches) land in a host-side queue; a
dispatcher thread drains up to ``batch_size`` images, splitting a chunk that
does not fit and carrying the rest over, pads the tail to the static batch,
runs the packed forward on the model's device and resolves per-request
futures.  uint8 images ship to the device raw (4x fewer host->device bytes
than f32) and are normalised there with the JAX engine's exact float32 ops;
with ``device_normalize=False``, or in a batch that mixes uint8 and float32
chunks, the native host runtime (:mod:`qnx_torch.native`) normalises the
uint8 chunks on the host to the same bits.

Two batches are in flight: each turn of the dispatcher drains and forms
batch k, launches it, and only then waits for batch k-1's logits and
answers its futures, so that on a card the host forms the next batch while
the device runs the last one's forward.  No answer waits on an empty queue:
where the queue holds nothing and no carry is left, the dispatcher answers
the batch in flight before it blocks, and ``stop()`` answers it too; while
the dispatcher lingers on an empty queue, a batch in flight whose logits
are on the host already (a forward that waited for the device inside, or
one on the CPU) is answered, so that its clients may send more, and the
linger starts again.  On a card every batch is staged in one of two
page-locked host buffers, used in turn and refilled only once the copy
that last read it has ended; the copy runs on a stream the engine owns,
the forward's stream waits for it, and the logits' copy back to the slot's
page-locked logits is launched right after the forward, so that waiting for
batch k-1's logits never waits for batch k's forward; each batch's answers
are rows of an array of its own, copied out of the slot before the batch
after next reuses it.  The answers are the serial engine's, bit for bit:
the same forward on the same bytes.  ``overlapped`` counts the batches
launched while another was in flight.

With a ``mesh`` (:func:`qnx_torch.parallel.mesh.make_mesh`) the engine
spans the world's ranks.  The JAX engine is one controller driving every
device; here the ranks are processes, so each batch forms once: rank 0
owns the queue and the dispatcher and broadcasts each static batch (uint8
or float32, padded as on one device) over the world with a stop flag, the
other ranks follow it, and rank 0 answers, one batch after another (a
mesh keeps one batch in flight).  On a rank other than 0 the
constructor runs the follower loop and returns when rank 0's ``stop()``
broadcasts the flag; that engine serves nothing.  The forward is the ring
TP path (:func:`qnx_torch.parallel.tp_forward.make_tp_forward`) where the
model takes it, else the data-parallel replicated path; the stats name it
(``forward_path``: ``single``, ``ring`` or ``replicated``) with the
backend and the transport.

The engine times its own host work, always: the dispatcher's cycle is four
stages whose nanoseconds ``ServeStats`` sums (``drain_ns``: batch k's
drain, queue waits, linger, concatenation and padding; ``enqueue_ns``: its
copy to the device, the normalisation and the forward's launches (on a
card, without waiting for them); ``wait_ns``: waiting for batch k-1's
logits on the host, which waits for the device; ``resolve_ns``: setting
batch k-1's futures), so the stages divide the dispatcher's time exactly; a batch's
``total_batch_ms`` runs from its dispatch to its logits on the host, so
the times of batches in flight together overlap; ``counters()`` returns
these flat, the running stage counted up to the call, so that between two
calls the stages add up to the time between them, and ``stats()`` as ms a
batch.  A ``gc.callbacks`` entry, in place from ``start()`` to ``stop()``,
sums the collector's pauses on any thread (``gc_ns``,
``gc_collections_0/1/2``); they overlap the stages.  While a torch profiler
records, the two stages that launch no device work are host ranges,
``qnx.serve.drain`` and ``qnx.serve.resolve``, with the batch's id and
request ids as arguments, and each collection is ``qnx.gc.gen<g>``
(:func:`qnx_torch.utils.profiling.span`).  A request's id is its place in
the queue's order, counted as the dispatcher takes it; a chunk split over
two batches keeps its id.

Each engine also keeps a timeline of its last :data:`TIMELINE` stages and
pauses with their clocks, so that ``between(since, until)`` gives the ns
of each that fell between two ``time.perf_counter()`` readings taken
without a call to the engine; :func:`last_started` hands the engine a
process started last to code that holds no reference to it (a
benchmark's readers).

While engines serve, what outlived their set-up sits in the collector's
permanent generation (``gc.freeze()``), so that a full collection walks
only what serving makes (the futures in flight, the chunks) and not every
object the imports of torch and numpy left.  The first leader started in
the process runs one full collection, so that no garbage is frozen, and
freezes; each engine collects and freezes once more when its first
batch's logits are on the host, before its futures are set, since the
first forward loads modules lazily.  The last one stopped undoes it
(``gc.unfreeze()``, which also thaws the tuples CPython 3.12 freezes at
start-up).  Where something else had frozen objects before the first
engine started (more than were frozen when this module was imported),
the engines neither freeze nor unfreeze.  None of the engine's
per-request objects forms a cycle, so a frozen future is still freed when
its last reference goes.  ``gc_frozen`` counts the objects an engine's
freezes moved out of the collector's walk (less any frozen object another
thread frees while the engine reads the count around its freeze).  The
dispatcher's first drain starts at ``start()`` and holds the collection.
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
from qnx_torch.utils import profiling

#: the follower protocol's header: stop flag, dtype code, ndim, the dims
_HEADER = 8
_DTYPES = (torch.uint8, torch.float32)

#: Cap on retained latency samples — the engine runs indefinitely, so stats
#: use reservoir sampling instead of an unbounded list.
LATENCY_RESERVOIR = 8192

#: Cap on the stages and collector pauses an engine's timeline keeps: at
#: four stages and about ten collections a batch, a few thousand batches.
TIMELINE = 1 << 16

_INV_127_5 = np.float32(1.0 / 127.5)

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


def _pinned(shape, dtype) -> np.ndarray:
    """An empty page-locked host array: a card's copy from it runs on a
    stream without holding the host."""
    like = torch.from_numpy(np.empty(0, dtype)).dtype
    return torch.empty(shape, dtype=like, pin_memory=True).numpy()


def _fail(chunks, error: Exception) -> None:
    """Resolve, never leak, the futures of a batch that failed."""
    for _, futs, *_ in chunks:
        for fut in futs:
            if not fut.done():
                fut.set_exception(error)


@dataclass
class _Slot:
    """One of a card engine's two staging slots, used by every other batch:
    its page-locked host batch, the event behind the copy that last read
    it, and the page-locked logits that batch's forward was copied into."""
    images: np.ndarray | None = None
    copied: object = None
    logits: torch.Tensor | None = None


@dataclass
class _InFlight:
    """A batch launched and not yet answered."""
    chunks: list
    batch: int      # its id
    images: int     # and its images, less the padding
    pad: int
    t0: int         # ns, its dispatch
    logits: torch.Tensor  # on the host once ``ready`` has passed
    # on a card, the CUDA event behind the logits' copy into its slot,
    # which the batch after next reuses
    ready: object


def normalize_u8(x: torch.Tensor) -> torch.Tensor:
    """uint8 pixels -> float32 in [-1, 1], bit-identical to the JAX engine.

    XLA contracts the JAX engine's ``x * f32(1/127.5) - 1`` into one fused
    multiply-add, so its result is rounded once.  The product and the
    difference are exact in float64 (an 8-bit integer times a 24-bit
    constant), so rounding that to float32 gives the same value on any
    device, where a float32 multiply then subtract would round twice."""
    return (x.to(torch.float64) * float(_INV_127_5) - 1.0).to(torch.float32)


@dataclass
class ServeStats:
    batches: int = 0
    images: int = 0
    padded: int = 0
    total_batch_ms: float = 0.0  # from dispatch to the logits on the host
    requests: int = 0  # answered in full
    overlapped: int = 0  # batches launched while another was in flight
    # the dispatcher's cycle, in ns (module docstring)
    drain_ns: int = 0
    enqueue_ns: int = 0
    wait_ns: int = 0
    resolve_ns: int = 0
    # the collector's pauses on any thread while the engine runs
    gc_ns: int = 0
    gc_collections_0: int = 0
    gc_collections_1: int = 0
    gc_collections_2: int = 0
    gc_frozen: int = 0  # objects this engine's freezes moved (docstring)
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
        ``DeviceMesh``; module docstring.
      max_wait_ms: dispatcher linger — how long to wait to fill a batch
        before flushing a partial one.
      forward: ``forward(model, x)`` on the normalised device batch; None
        means ``model(x)``, or under a mesh the ring TP forward where the
        model takes it.  A given forward runs on the replicated path under
        a mesh.  It runs under ``torch.inference_mode()``.
      device_normalize: ship an all-uint8 batch raw and normalise it on the
        device; else (and for a batch that mixes uint8 and float32 chunks)
        the uint8 chunks are normalised on the host by
        :func:`qnx_torch.native.u8_to_f32`, to the same bits.
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
        self.model = model.eval()
        self.device = next(model.buffers()).device
        self.mesh = mesh
        self.forward_path, self.backend, self.transport = "single", None, None
        self._forward = forward or (lambda m, x: m(x))
        if mesh is not None:
            self._init_mesh(forward)
        self._queue: queue.Queue = queue.Queue(maxsize=max_queue or 0)
        self._carry = None   # split-chunk remainder (dispatcher-only)
        self._total = 0
        # dispatcher-only: on a card, the two staging slots, the one filled
        # last and the copy stream; the batch in flight
        self._slots = (_Slot(), _Slot())
        self._slot = 1
        self._copy_stream = None
        self._inflight: _InFlight | None = None
        self._next_request = 0  # the id of the next request taken
        self._next_batch = 0    # and of the next batch formed
        # the dispatcher's running stage's counter and start (ns), or None
        self._running: tuple | None = None
        self._running_lock = threading.Lock()
        self._stats = ServeStats()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._released = False  # the followers got the stop flag
        self._serving = False   # counted in the module's ``_serving``
        if not self.leader:
            self._follow()

    def _init_mesh(self, forward):
        import torch.distributed as dist

        from qnx_torch.parallel.mesh import transport
        from qnx_torch.parallel.tp_forward import (make_tp_forward,
                                                   replicated_forward)

        if not dist.is_initialized():
            raise RuntimeError("ServeEngine(mesh=...) serves over the world's "
                               "ranks: join it first (qnx_torch.parallel.mesh."
                               "initialize_distributed) and pass make_mesh()")
        self.backend = dist.get_backend()
        self.transport = transport(None, self.device)
        # nccl moves CUDA tensors only; gloo the host's (the batch starts there)
        self._comm = self.device if self.backend == "nccl" else torch.device("cpu")
        if dist.get_world_size() == 1:
            return  # one rank: the single path, through the protocol
        tp = make_tp_forward(self.model, self.mesh) if forward is None else None
        if tp is not None:
            self.forward_path = "ring"
            self.model, self._forward = tp
        else:
            self.forward_path = "replicated"
            mesh = self.mesh
            self._forward = lambda m, x: replicated_forward(m, x, mesh, forward)

    @property
    def leader(self) -> bool:
        """Rank 0 of a mesh, or the engine of one process: it owns the
        queue and answers."""
        if self.mesh is None:
            return True
        import torch.distributed as dist

        return dist.get_rank() == 0

    # ---------------- public API ----------------

    def start(self):
        if not self.leader:
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
        if self.mesh is not None and self.leader and not self._released:
            self._released = True
            self._broadcast_header(None)  # the followers' stop flag
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
        if not self.leader:
            raise RuntimeError("a follower rank serves no requests; submit "
                               "to rank 0's engine")
        if self._stop.is_set():
            raise RuntimeError("engine is stopped")
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
        """The engine's cumulative counters, flat: ``batches``, ``images``,
        ``padded``, ``total_batch_ms``, ``requests``, ``overlapped``, the
        four stages' ``*_ns``, ``gc_ns``, ``gc_collections_0/1/2`` and
        ``gc_frozen``
        (module docstring).  The running stage counts up to this call, so
        that between two calls the stages add up to the time between them."""
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
        out = self._stats.summary()
        out["forward_path"] = self.forward_path
        if self.mesh is not None:
            import torch.distributed as dist

            out.update(backend=self.backend, transport=self.transport,
                       world=dist.get_world_size())
        return out

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
        when it ends its request.  With nothing to take but from an empty
        queue, it answers the batch in flight before it blocks; lingering on
        an empty queue, it answers a batch in flight whose logits are on the
        host already, whose clients may then send more, and lingers anew."""
        chunks: list = []
        self._total = 0

        def take(imgs, futs, t, rid):
            room = self.batch_size - self._total
            last = len(imgs) <= room
            if not last:
                self._carry = (imgs[room:], futs[room:], t, rid)
                imgs, futs = imgs[:room], futs[:room]
            chunks.append((imgs, futs, t, rid, last))
            self._total += len(imgs)

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
                return chunks
        deadline = time.perf_counter() + self.max_wait_ms / 1e3
        while self._total < self.batch_size and self._carry is None:
            if self._queue.empty() and self._answered_if_done():
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
        return chunks

    def _answered_if_done(self) -> bool:
        """Answer the batch in flight if its logits are on the host already
        (on a card, once its event has passed); True if it did."""
        b = self._inflight
        if b is None or (b.ready is not None and not b.ready.query()):
            return False
        self._settle()
        return True

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
                    chunks = self._drain()
                    if not chunks:
                        continue
                    images, pad = self._host_batch(chunks)
                launched = self._launch(chunks, images, pad)
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
            elif self.mesh is None:
                self._lap("drain_ns")
            self._inflight = launched
            if self.mesh is not None:  # serial: one ordered broadcast a batch
                self._settle()
        if self._inflight is not None:
            self._settle()
        self._lap(None)

    def _host_batch(self, chunks):
        """The chunks as one static host batch: (images, padding).  Where the
        batch goes to a card, every batch, a single full chunk too, is
        copied into the next of two page-locked buffers the engine keeps
        (:meth:`_stage`), so that its pages are touched once and not once a
        batch (a fresh 154 MB array a batch spent most of the host's time
        on page faults at 224x224), its copy to the card runs without
        holding the host, and the client's array is not read after the
        drain.  On the CPU the model may keep views of its input, so each
        batch gets an array of its own."""
        self._next_batch += 1
        arrs = [imgs for imgs, *_ in chunks]
        if not (self.device_normalize
                and all(a.dtype == np.uint8 for a in arrs)):
            # normalise the uint8 chunks on the host (native runtime)
            arrs = [u8_to_f32(a) if a.dtype == np.uint8 else a for a in arrs]
        pad = self.batch_size - self._total
        if self.device.type != "cuda":
            if len(arrs) == 1 and not pad:
                return arrs[0], pad
            images = arrs[0] if len(arrs) == 1 else np.concatenate(arrs)
            if pad:
                images = np.concatenate(
                    [images, np.zeros((pad, *images.shape[1:]), images.dtype)])
            return images, pad
        buf = self._stage((self.batch_size, *arrs[0].shape[1:]),
                          np.result_type(*arrs))
        np.concatenate(arrs, out=buf[:self._total])
        buf[self._total:] = 0
        return buf, pad

    def _stage(self, shape, dtype) -> np.ndarray:
        """The staging buffer after the one filled last, once the copy that
        last read it has ended; a new one (:func:`_pinned`) for another
        shape or dtype, and the first batch makes both."""
        self._slot ^= 1
        slot = self._slots[self._slot]
        if slot.copied is not None:
            slot.copied.synchronize()
            slot.copied = None
        buf = slot.images
        if buf is None or buf.shape != shape or buf.dtype != dtype:
            slot.images = _pinned(shape, dtype)
            other = self._slots[self._slot ^ 1]
            if other.images is None:  # both at the first batch, a warm-up's
                other.images = _pinned(shape, dtype)
        return slot.images

    def _launch(self, chunks, images, pad) -> _InFlight:
        """Dispatch a static host batch (stage ``enqueue``): its copy to the
        device, the normalisation and the forward, and on a card the
        logits' copy back, launched and not waited for."""
        st = self._stats
        t0 = self._lap("enqueue_ns")
        if st.first_dispatch is None:
            st.first_dispatch = t0 / 1e9
        x = torch.from_numpy(images)
        ready = None
        if self.mesh is not None:
            logits = self._compute(self._broadcast_batch(x))
        elif self.device.type == "cuda":
            logits, ready = self._compute_staged(x)
        else:
            logits = self._compute(x)
        return _InFlight(chunks, self._next_batch - 1, self._total, pad, t0,
                         logits, ready)

    def _compute_staged(self, x: torch.Tensor):
        """The forward of the staging slot filled last, on a card: its copy
        on the engine's copy stream, which the current stream waits for
        before the normalisation; the logits copied back into the slot's
        page-locked logits right after the forward (the batch after next
        reuses them, once this one is answered).  Returns the host logits
        and the event behind their copy."""
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        compute = torch.cuda.current_stream(self.device)
        slot = self._slots[self._slot]
        with torch.cuda.stream(self._copy_stream):
            xd = x.to(self.device, non_blocking=True)
        copied = slot.copied = torch.cuda.Event()
        copied.record(self._copy_stream)
        compute.wait_event(copied)
        xd.record_stream(compute)  # alive until the normalisation has read it
        with torch.inference_mode():
            if xd.dtype == torch.uint8:
                xd = normalize_u8(xd)
            logits = self._forward(self.model, xd)
        host = slot.logits
        if host is None or host.shape != logits.shape or host.dtype != logits.dtype:
            host = slot.logits = torch.empty(logits.shape, dtype=logits.dtype,
                                             pin_memory=True)
        host.copy_(logits, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(compute)
        return host, ready

    def _settle(self):
        """Wait for the batch in flight's logits (stage ``wait``) and answer
        its futures (``resolve``); the dispatcher drains next."""
        st, b, self._inflight = self._stats, self._inflight, None
        try:
            self._lap("wait_ns")
            if b.ready is None:
                logits = b.logits.cpu().numpy()  # under a mesh, waits for the device
            else:  # the rows out of the slot the batch after next reuses
                b.ready.synchronize()
                logits = b.logits.numpy().copy()
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

    # ---------------- the ranks of a mesh ----------------

    def _compute(self, x: torch.Tensor) -> torch.Tensor:
        """The forward of one static batch, on every rank alike."""
        with torch.inference_mode():
            x = x.to(self.device)
            if x.dtype == torch.uint8:
                x = normalize_u8(x)
            return self._forward(self.model, x)

    def _broadcast_header(self, x: torch.Tensor | None) -> torch.Tensor:
        from qnx_torch.parallel.mesh import broadcast

        header = torch.zeros(_HEADER, dtype=torch.int64)
        if x is None:
            header[0] = 1
        else:
            header[1] = _DTYPES.index(x.dtype)
            header[2] = x.dim()
            header[3:3 + x.dim()] = torch.tensor(x.shape)
        return broadcast(header.to(self._comm), 0).cpu()

    def _broadcast_batch(self, x: torch.Tensor) -> torch.Tensor:
        """Rank 0: the batch to every rank, after its header."""
        from qnx_torch.parallel.mesh import broadcast

        self._broadcast_header(x)
        return broadcast(x.to(self._comm), 0)

    def _follow(self):
        """A follower rank: receive each batch rank 0 broadcasts and run the
        forward with it (its collectives need every rank), until the stop
        flag."""
        from qnx_torch.parallel.mesh import broadcast

        while True:
            header = broadcast(torch.zeros(_HEADER, dtype=torch.int64,
                                           device=self._comm), 0).cpu()
            if header[0]:
                self._released = True
                return
            shape = header[3:3 + int(header[2])].tolist()
            x = broadcast(torch.empty(shape, dtype=_DTYPES[int(header[1])],
                                      device=self._comm), 0)
            self._compute(x)
