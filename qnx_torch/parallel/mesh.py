"""The (data, model) mesh over ``torch.distributed`` (torch port of
:mod:`qnx.parallel.mesh`), and the collectives every parallel path uses.

The JAX package runs one controller over every device; here each rank is a
process (:mod:`qnx_torch.parallel.launch` starts them), joined by
:func:`initialize_distributed`.  :func:`make_mesh` lays the world out as a
``torch.distributed.device_mesh.DeviceMesh`` of shape ``(n // mp, mp)``
with dims ``("data", "model")``; its per-dim process groups are the groups
the ring, the gathers and the all-reduces run on.  A mesh of ``None``
stands for one process alone (every axis of size 1).

Sharding is described by :class:`P`, the counterpart of JAX's
``PartitionSpec``: one mesh axis name (or None) per tensor dim.

The transport is the backend's, never switched on an error:

* ``"nccl"``: the tensors on the card travel as they are;
* ``"gloo"``: CPU tensors travel as they are;
* ``"gloo-host"``: CUDA tensors on a gloo group.  gloo's all_reduce,
  all_gather and broadcast take them as they are (gloo copies through the
  host itself); send and recv, which gloo runs on host memory only, are
  staged through pinned host buffers, explicitly, around every ring hop
  (:class:`RingLink`).  NCCL refuses two ranks on one card, so several
  ranks sharing one card run gloo with their tensors on that card.
"""
from __future__ import annotations

import math
from datetime import timedelta

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def initialize_distributed(init_method: str, world_size: int, rank: int,
                           backend: str, timeout: float = 120.0) -> int:
    """Join the world (``dist.init_process_group``) with an explicit
    ``backend``: ``"nccl"`` for ranks on cards of their own, ``"gloo"`` for
    the CPU and for several ranks on one card.  ``init_method`` is
    ``file://PATH`` or ``tcp://HOST:PORT``; ``timeout`` seconds bound every
    collective, so a deadlocked ring fails instead of hanging.  Returns the
    rank."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout))
    return dist.get_rank()


def default_model_parallel(n: int) -> int:
    """Default TP degree for an n-device mesh: the largest power of two
    <= sqrt(n) that divides n (the JAX package's closed form):
    1->1, 2->1, 4->2, 8->2, 16->4, 32->4."""
    mp = 1
    while mp * 2 <= math.isqrt(n) and n % (mp * 2) == 0:
        mp *= 2
    return mp


def make_mesh(n_devices: int | None = None, model_parallel: int | None = None,
              device_type: str = "cuda"):
    """The (data, model) ``DeviceMesh`` over the world's ranks.

    ``n_devices`` must be the world size when given (every rank is in the
    mesh); ``model_parallel`` fixes the TP degree, default
    :func:`default_model_parallel`; ``device_type`` is where the ranks
    compute, ``"cuda"`` or ``"cpu"``."""
    from torch.distributed.device_mesh import DeviceMesh

    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"the mesh spans the world: {n_devices} devices asked, "
                         f"world size {n}")
    mp = default_model_parallel(n) if model_parallel is None else model_parallel
    if mp < 1 or n % mp != 0:
        raise ValueError(f"{n} devices not divisible by model={mp}")
    ranks = torch.arange(n).reshape(n // mp, mp)
    return DeviceMesh(device_type, ranks, mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


class P(tuple):
    """Partition spec: for each tensor dim, the mesh axis it is split over,
    or None (replicated along that dim); ``P()`` is fully replicated.
    Compares equal to JAX's ``PartitionSpec`` of the same entries."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple(self)!r}"


def data_sharding(mesh) -> P:
    """Batch-sharded images and labels (DP over the image stream)."""
    return P(DATA_AXIS)


def replicated(mesh) -> P:
    return P()


def axis_size(mesh, axis: str) -> int:
    if mesh is None:
        return 1
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_rank(mesh, axis: str) -> int:
    return 0 if mesh is None else int(mesh.get_local_rank(axis))


def axis_group(mesh, axis: str):
    return None if mesh is None else mesh.get_group(axis)


def transport(group, device) -> str:
    """``"nccl"``, ``"gloo"`` or ``"gloo-host"`` (module docstring) for
    tensors on ``device`` over ``group`` (None: the world)."""
    backend = dist.get_backend(group)
    if backend == "nccl":
        return "nccl"
    if backend == "gloo":
        return "gloo-host" if torch.device(device).type == "cuda" else "gloo"
    raise ValueError(f"no transport for backend {backend!r}")


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of CUDA ``t`` (the copy waits for the device)."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``t`` over ``group`` (None group: ``t`` itself).  The result
    is the same on every rank of the group."""
    if group is None or dist.get_world_size(group) == 1:
        return t
    out = t.clone()
    dist.all_reduce(out, group=group)
    return out


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's ``t`` concatenated along ``dim`` in group-rank order."""
    if group is None or dist.get_world_size(group) == 1:
        return t
    n = dist.get_world_size(group)
    src = t.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """``t`` of global rank ``src`` on every rank of ``group`` (None: the
    world); the other ranks pass a tensor of the same shape and dtype.  A
    world of one still calls the backend, so NCCL's path runs there too."""
    t = t.contiguous()
    dist.broadcast(t, src=src, group=group)
    return t


class RingLink:
    """One hop of a ring over ``group``: send to the next group rank,
    receive from the previous, both posted at once
    (``dist.batch_isend_irecv``) so the caller computes while they travel.
    Under ``gloo-host`` the chunk is copied to pinned host memory before
    the send and the received chunk back to the card after the wait."""

    def __init__(self, group, device):
        ranks = dist.get_process_group_ranks(group)
        r, m = dist.get_rank(group), len(ranks)
        self.group, self.device = group, torch.device(device)
        self.next, self.prev = ranks[(r + 1) % m], ranks[(r - 1) % m]
        self.staged = transport(group, device) == "gloo-host"

    def start(self, x: torch.Tensor):
        send = _host(x) if self.staged else x.contiguous()
        recv = (torch.empty(send.shape, dtype=send.dtype, pin_memory=True)
                if self.staged else torch.empty_like(send))
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, self.next, self.group),
            dist.P2POp(dist.irecv, recv, self.prev, self.group)])
        return reqs, send, recv

    def finish(self, pending) -> torch.Tensor:
        reqs, _, recv = pending
        for req in reqs:
            req.wait()
        return recv.to(self.device) if self.staged else recv
