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

With a ``mesh`` (:func:`qnx_torch.parallel.mesh.make_mesh`) the engine
spans the world's ranks.  The JAX engine is one controller driving every
device; here the ranks are processes, so each batch forms once: rank 0
owns the queue and the dispatcher and broadcasts each static batch (uint8
or float32, padded as on one device) over the world with a stop flag, the
other ranks follow it, and rank 0 answers.  On a rank other than 0 the
constructor runs the follower loop and returns when rank 0's ``stop()``
broadcasts the flag; that engine serves nothing.  The forward is the ring
TP path (:func:`qnx_torch.parallel.tp_forward.make_tp_forward`) where the
model takes it, else the data-parallel replicated path; the stats name it
(``forward_path``: ``single``, ``ring`` or ``replicated``) with the
backend and the transport.
"""
from __future__ import annotations

import queue
import random
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch

from qnx_torch.native import u8_to_f32

#: the follower protocol's header: stop flag, dtype code, ndim, the dims
_HEADER = 8
_DTYPES = (torch.uint8, torch.float32)

#: Cap on retained latency samples — the engine runs indefinitely, so stats
#: use reservoir sampling instead of an unbounded list.
LATENCY_RESERVOIR = 8192

_INV_127_5 = np.float32(1.0 / 127.5)


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
    total_batch_ms: float = 0.0
    first_dispatch: float | None = None  # perf_counter of the first batch
    last_answer: float = 0.0  # perf_counter after the last batch's futures
    latencies_ms: list = field(default_factory=list)
    _lat_seen: int = 0
    _rng: random.Random = field(default_factory=lambda: random.Random(0))

    def record_latency(self, lat_ms: float, count: int = 1) -> None:
        """Reservoir-sample latencies so memory stays O(LATENCY_RESERVOIR)
        over an unbounded serving lifetime; percentiles remain unbiased."""
        for _ in range(count):
            self._lat_seen += 1
            if len(self.latencies_ms) < LATENCY_RESERVOIR:
                self.latencies_ms.append(lat_ms)
            else:
                j = self._rng.randrange(self._lat_seen)
                if j < LATENCY_RESERVOIR:
                    self.latencies_ms[j] = lat_ms

    def summary(self) -> dict:
        """``throughput_ips`` is images over the summed busy time of the
        batches (the JAX engine's figure); ``wall_throughput_ips`` is images
        over the host clock from the first batch's dispatch to the last
        batch's answers, so it also counts the dispatcher's gaps."""
        lat = np.asarray(self.latencies_ms) if self.latencies_ms else np.zeros(1)
        busy_s = self.total_batch_ms / 1e3
        wall_s = (self.last_answer - self.first_dispatch
                  if self.first_dispatch is not None else 0.0)
        return {
            "batches": self.batches,
            "images": self.images,
            "pad_fraction": self.padded / max(self.images + self.padded, 1),
            "throughput_ips": self.images / busy_s if busy_s > 0 else 0.0,
            "wall_throughput_ips": self.images / wall_s if wall_s > 0 else 0.0,
            "latency_ms_p50": float(np.percentile(lat, 50)),
            "latency_ms_p99": float(np.percentile(lat, 99)),
            "latency_samples": self._lat_seen,
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
        self._stats = ServeStats()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._released = False  # the followers got the stop flag
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
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        """Stop the dispatcher and CANCEL all still-queued requests, so every
        future handed out by submit/submit_many is resolved one way or
        another."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        if self.mesh is not None and self.leader and not self._released:
            self._released = True
            self._broadcast_header(None)  # the followers' stop flag
        pending = []
        if self._carry is not None:
            pending.append(self._carry)
            self._carry = None
        while True:
            try:
                pending.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for _, futs, _ in pending:
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
        self._queue.put((images, futs, time.perf_counter()), timeout=timeout)
        return futs

    def predict(self, images: np.ndarray) -> np.ndarray:
        """Synchronous convenience: batch of images -> logits."""
        futs = self.submit_many(images)
        return np.stack([f.result(timeout=300) for f in futs])

    def stats(self) -> dict:
        """The batches' figures (``ServeStats.summary``), the path the
        forward took, and under a mesh the backend, transport and world."""
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
        split; the remainder carries over to the next batch."""
        chunks: list = []
        self._total = 0

        def take(item):
            imgs, futs, t = item
            room = self.batch_size - self._total
            if len(imgs) > room:
                self._carry = (imgs[room:], futs[room:], t)
                imgs, futs = imgs[:room], futs[:room]
            chunks.append((imgs, futs, t))
            self._total += len(imgs)

        if self._carry is not None:
            item, self._carry = self._carry, None
            take(item)
        if not chunks:
            try:
                take(self._queue.get(timeout=0.1))
            except queue.Empty:
                return chunks
        deadline = time.perf_counter() + self.max_wait_ms / 1e3
        while self._total < self.batch_size and self._carry is None:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                take(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return chunks

    def _loop(self):
        while not self._stop.is_set():
            chunks = self._drain()
            if not chunks:
                continue
            try:
                self._run_batch(chunks)
            except Exception as e:  # resolve, never leak, this batch's futures
                for _, futs, _ in chunks:
                    for fut in futs:
                        if not fut.done():
                            fut.set_exception(e)

    def _run_batch(self, chunks):
        n = self._total
        arrs = [imgs for imgs, _, _ in chunks]
        if not (self.device_normalize
                and all(a.dtype == np.uint8 for a in arrs)):
            # normalise the uint8 chunks on the host (native runtime)
            arrs = [u8_to_f32(a) if a.dtype == np.uint8 else a for a in arrs]
        images = arrs[0] if len(arrs) == 1 else np.concatenate(arrs)
        pad = self.batch_size - n
        if pad:
            images = np.concatenate(
                [images, np.zeros((pad, *images.shape[1:]), images.dtype)])
        t0 = time.perf_counter()
        if self._stats.first_dispatch is None:
            self._stats.first_dispatch = t0
        x = torch.from_numpy(images)
        if self.mesh is not None:
            x = self._broadcast_batch(x)
        # the copy to the host waits for the device
        logits = self._compute(x).cpu().numpy()
        dt_ms = (time.perf_counter() - t0) * 1e3
        done = time.perf_counter()
        self._stats.batches += 1
        self._stats.images += n
        self._stats.padded += pad
        self._stats.total_batch_ms += dt_ms
        off = 0
        for _, futs, t_in in chunks:
            lat = (done - t_in) * 1e3
            self._stats.record_latency(lat, count=len(futs))
            for fut in futs:
                fut.set_result(logits[off])
                off += 1
        self._stats.last_answer = time.perf_counter()

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
