"""Where a served batch runs: on the CPU, on a card, or over the ranks of a
mesh.  :class:`~qnx_torch.serve.engine.ServeEngine` picks one route when
it is built (:func:`pick`) and asks it, batch by batch, to ``stage`` the
static host batch, ``launch`` its forward and ``fetch`` its logits.  Every
route runs the same forward on the same bytes (:func:`infer`), so the
answers are the same, bit for bit."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from qnx_torch.parallel.mesh import broadcast, transport

#: the follower protocol's header: stop flag, dtype code, ndim, the dims
_HEADER = 8
_DTYPES = (torch.uint8, torch.float32)

_INV_127_5 = np.float32(1.0 / 127.5)


def normalize_u8(x: torch.Tensor) -> torch.Tensor:
    """uint8 pixels -> float32 in [-1, 1], bit-identical to the JAX engine.

    XLA contracts the JAX engine's ``x * f32(1/127.5) - 1`` into one fused
    multiply-add, so its result is rounded once.  The product and the
    difference are exact in float64 (an 8-bit integer times a 24-bit
    constant), so rounding that to float32 gives the same value on any
    device, where a float32 multiply then subtract would round twice."""
    return (x.to(torch.float64) * float(_INV_127_5) - 1.0).to(torch.float32)


def infer(forward, model, x: torch.Tensor) -> torch.Tensor:
    """``forward(model, x)`` on a batch on the model's device, uint8 pixels
    normalised there first, under ``torch.inference_mode()``."""
    with torch.inference_mode():
        if x.dtype == torch.uint8:
            x = normalize_u8(x)
        return forward(model, x)


def _pinned(shape, dtype) -> np.ndarray:
    """An empty page-locked host array: a card's copy from it runs on a
    stream without holding the host."""
    like = torch.from_numpy(np.empty(0, dtype)).dtype
    return torch.empty(shape, dtype=like, pin_memory=True).numpy()


def pick(model, batch_size: int, mesh, forward):
    """The route for ``model`` (on its device, ``eval()``): over ``mesh``
    where one is given, else on the card or the CPU that holds the model."""
    device = next(model.buffers()).device
    if mesh is not None:
        return MeshRoute(model, device, batch_size, forward, mesh)
    if device.type == "cuda":
        return CardRoute(model, device, batch_size, forward)
    return HostRoute(model, device, batch_size, forward)


class HostRoute:
    """A model on the CPU, and what every route of one process says of
    itself.  The forward has run when ``launch`` returns, so its logits are
    on the host at once.  The model may keep views of its input, so each
    batch is an array of its own: the client's chunk where it fills the
    batch alone, else a new one."""
    serial = False  # the dispatcher may launch a batch with another in flight
    leader = True   # this process owns the queue and answers
    forward_path, backend, transport = "single", None, None

    def __init__(self, model, device, batch_size, forward):
        self.model, self.device, self.batch_size = model, device, batch_size
        self.forward = forward or (lambda m, x: m(x))

    def stage(self, arrs: list, total: int) -> tuple[np.ndarray, int]:
        """The chunks ``arrs`` (``total`` images) as one static host batch,
        zero-padded: (images, padding)."""
        pad = self.batch_size - total
        if len(arrs) == 1 and not pad:
            return arrs[0], pad
        zeros = np.zeros((pad, *arrs[0].shape[1:]), arrs[0].dtype)
        return np.concatenate([*arrs, zeros]), pad

    def compute(self, x: torch.Tensor) -> torch.Tensor:
        """The forward of one static batch, on every rank of a mesh alike."""
        return infer(self.forward, self.model, x.to(self.device))

    def launch(self, images: np.ndarray):
        """(logits, ready): ``ready`` is None, the logits are there."""
        return self.compute(torch.from_numpy(images)), None

    def fetch(self, b) -> np.ndarray:
        """The logits of the batch in flight ``b`` on the host."""
        return b.logits.cpu().numpy()

    def done(self, b) -> bool:
        """Whether ``b``'s logits are on the host already."""
        return True

    def release(self) -> None:
        """At ``stop()``: no other process waits on this one."""

    def stats(self) -> dict:
        """The entries this route adds to ``ServeEngine.stats()``."""
        return {}


@dataclass
class _Slot:
    """One of the card route's two staging slots, used by every other
    batch: its page-locked host batch, the event behind the copy that last
    read it, and the page-locked logits that batch's forward was copied
    into."""
    images: np.ndarray | None = None
    copied: object = None
    logits: torch.Tensor | None = None


class CardRoute(HostRoute):
    """A model on a card.  Every batch, a single full chunk too, is copied
    into the next of two page-locked host buffers, used in turn and
    refilled only once the copy that last read it has ended: their pages
    are touched once and not once a batch (a fresh 154 MB array a batch
    spent most of the host's time on page faults at 224x224), the copy to
    the card runs on a stream of the route's own without holding the host,
    and the client's array is not read after the drain.  The forward's
    stream waits for that copy, and the logits' copy back to the slot's
    page-locked logits is launched right after the forward, behind an
    event, so that waiting for batch k-1's logits never waits for batch k's
    forward.  Each batch's answers are rows of an array of its own, copied
    out of the slot before the batch after next reuses it."""

    def __init__(self, model, device, batch_size, forward):
        super().__init__(model, device, batch_size, forward)
        self._slots = (_Slot(), _Slot())
        self._slot = 1  # the one filled last
        self._copy_stream = None

    def stage(self, arrs: list, total: int) -> tuple[np.ndarray, int]:
        """The chunks in the buffer after the one filled last, once the copy
        that last read it has ended, zero-padded: (images, padding).  A new
        buffer (:func:`_pinned`) for another shape or dtype; the first batch
        makes both."""
        self._slot ^= 1
        slot = self._slots[self._slot]
        if slot.copied is not None:
            slot.copied.synchronize()
            slot.copied = None
        shape, dtype = (self.batch_size, *arrs[0].shape[1:]), np.result_type(*arrs)
        buf = slot.images
        if buf is None or buf.shape != shape or buf.dtype != dtype:
            buf = slot.images = _pinned(shape, dtype)
            other = self._slots[self._slot ^ 1]
            if other.images is None:  # both at the first batch, a warm-up's
                other.images = _pinned(shape, dtype)
        np.concatenate(arrs, out=buf[:total])
        buf[total:] = 0
        return buf, self.batch_size - total

    def launch(self, images: np.ndarray):
        """The slot filled last: its copy on the copy stream, the forward
        once it has ended, the logits' copy back into the slot.  Returns the
        slot's host logits and the event behind their copy."""
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        compute = torch.cuda.current_stream(self.device)
        slot = self._slots[self._slot]
        with torch.cuda.stream(self._copy_stream):
            xd = torch.from_numpy(images).to(self.device, non_blocking=True)
        copied = slot.copied = torch.cuda.Event()
        copied.record(self._copy_stream)
        compute.wait_event(copied)
        xd.record_stream(compute)  # alive until the normalisation has read it
        logits = infer(self.forward, self.model, xd)
        host = slot.logits
        if host is None or host.shape != logits.shape or host.dtype != logits.dtype:
            host = slot.logits = torch.empty(logits.shape, dtype=logits.dtype,
                                             pin_memory=True)
        host.copy_(logits, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(compute)
        return host, ready

    def fetch(self, b) -> np.ndarray:
        """The rows out of the slot the batch after next reuses."""
        b.ready.synchronize()
        return b.logits.numpy().copy()

    def done(self, b) -> bool:
        return b.ready.query()


class MeshRoute(HostRoute):
    """The world's ranks (:func:`qnx_torch.parallel.mesh.make_mesh`).  The
    JAX engine is one controller driving every device; here the ranks are
    processes, so each batch forms once: rank 0 owns the queue and the
    dispatcher and broadcasts each static batch (the host route's, uint8 or
    float32) over the world after an int64 header (stop flag, dtype,
    shape); the other ranks follow it (:meth:`follow`) and rank 0 answers,
    one batch at a time (``serial``).  The forward is the ring TP path
    (:func:`qnx_torch.parallel.tp_forward.make_tp_forward`) where the model
    takes it, else the data-parallel replicated path, and ``model(x)`` on a
    world of one."""
    serial = True

    def __init__(self, model, device, batch_size, forward, mesh):
        import torch.distributed as dist

        from qnx_torch.parallel.tp_forward import (make_tp_forward,
                                                   replicated_forward)

        if not dist.is_initialized():
            raise RuntimeError("ServeEngine(mesh=...) serves over the world's "
                               "ranks: join it first (qnx_torch.parallel.mesh."
                               "initialize_distributed) and pass make_mesh()")
        super().__init__(model, device, batch_size, forward)
        self.backend = dist.get_backend()
        self.transport = transport(None, device)
        self.world = dist.get_world_size()
        self.leader = dist.get_rank() == 0
        self._released = False  # the followers got the stop flag
        # nccl moves CUDA tensors only; gloo the host's (the batch starts there)
        self._comm = device if self.backend == "nccl" else torch.device("cpu")
        if self.world == 1:
            return  # one rank: the single path, through the protocol
        tp = make_tp_forward(model, mesh) if forward is None else None
        if tp is not None:
            self.forward_path = "ring"
            self.model, self.forward = tp
        else:
            self.forward_path = "replicated"
            self.forward = lambda m, x: replicated_forward(m, x, mesh, forward)

    def _header(self, x: torch.Tensor | None) -> None:
        header = torch.zeros(_HEADER, dtype=torch.int64)
        if x is None:
            header[0] = 1
        else:
            header[1:3 + x.dim()] = torch.tensor([_DTYPES.index(x.dtype), x.dim(),
                                                  *x.shape])
        broadcast(header.to(self._comm), 0).cpu()

    def launch(self, images: np.ndarray):
        """Rank 0: the batch to every rank, after its header, then the
        forward."""
        x = torch.from_numpy(images)
        self._header(x)
        return self.compute(broadcast(x.to(self._comm), 0)), None

    def follow(self) -> None:
        """A follower rank: receive each batch rank 0 broadcasts and run the
        forward with it (its collectives need every rank), until the stop
        flag."""
        while True:
            header = broadcast(torch.zeros(_HEADER, dtype=torch.int64,
                                           device=self._comm), 0).cpu()
            if header[0]:
                self._released = True
                return
            shape = header[3:3 + int(header[2])].tolist()
            self.compute(broadcast(torch.empty(shape, dtype=_DTYPES[int(header[1])],
                                               device=self._comm), 0))

    def release(self) -> None:
        """Rank 0's ``stop()``: the followers' stop flag, once."""
        if not self._released:
            self._released = True
            self._header(None)

    def stats(self) -> dict:
        return {"backend": self.backend, "transport": self.transport,
                "world": self.world}
