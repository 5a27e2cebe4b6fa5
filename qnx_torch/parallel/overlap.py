"""Ring-overlapped tensor-parallel GEMM (torch port of
:mod:`qnx.parallel.overlap`).

The all-gather of K-sharded activations is decomposed into a ring of
point-to-point hops over the mesh's model group, and each hop's transfer
travels while the GEMM runs on the chunk already resident: the collective
("all-gather") matmul, scheduled by hand.

Layout: on each rank, activations (M, K/m), this rank's K-chunk; weights
(K, N/m), this rank's resident output-channel shard; output (M, N/m), the
output-channel sharding of the next packed layer.  The rows are whatever
the caller gives: a data group passes its own slice of the batch (the TP
forwards of :mod:`qnx_torch.parallel.tp_forward` choose it), so DP
composes with the ring without an argument here.
"""
from __future__ import annotations

from typing import Callable

import torch

from qnx_torch.nn.inference import _ieee_f32
from qnx_torch.nn.int8_engine import _dot_i8
from qnx_torch.ops.packing import popcount

from .mesh import MODEL_AXIS, RingLink, axis_group, axis_rank, axis_size


def _default_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 x int8 -> exact int32 (``torch._int_mm`` on the card), or a
    float32 matmul with TF32 off (the JAX package's dot at its f32
    precision)."""
    if a.dtype == torch.int8:
        return _dot_i8(a, b)
    with _ieee_f32():
        return a @ b


def allgather_gemm_overlapped(x: torch.Tensor, w: torch.Tensor, mesh,
                              gemm: Callable | None = None) -> torch.Tensor:
    """out = x_full @ w with the activation all-gather overlapped with
    compute.

    x: (M, K/m), this rank's K-chunk (chunk r of the model group's rank r);
    w: (K, N/m), this rank's resident weight shard.  Returns (M, N/m).

    At every step each rank posts the send of the chunk it holds to rank
    r + 1 and the receive from rank r - 1, multiplies the chunk against the
    matching K-rows of its shard, then waits and swaps; after m steps every
    chunk has visited every rank.  The chunk held at step t came from rank
    r - t, as in the JAX ring."""
    gemm = gemm or _default_gemm
    m = axis_size(mesh, MODEL_AXIS)
    if m == 1:
        return gemm(x, w)
    link = RingLink(axis_group(mesh, MODEL_AXIS), x.device)
    kc = x.shape[1]
    src = axis_rank(mesh, MODEL_AXIS)  # which K-chunk x holds
    acc = None
    for step in range(m):
        pending = link.start(x) if step + 1 < m else None
        part = gemm(x, w[src * kc:(src + 1) * kc])
        acc = part if acc is None else acc + part
        if pending is not None:
            x = link.finish(pending)
        src = (src - 1) % m
    return acc


def allgather_popcount_gemm(xp: torch.Tensor, wp: torch.Tensor, k: int,
                            mesh) -> torch.Tensor:
    """Overlapped TP packed XNOR GEMM in torch ops (the JAX function is jnp,
    not a kernel).

    xp: (M, Kw/m) packed activations, this rank's word chunk; wp: (Kw, N/m)
    packed weights, this rank's shard.  Returns the (M, N/m) int32 dot over
    the k real bits: per-chunk mismatch popcounts summed around the ring,
    folded into k - 2 * mismatch."""

    def chunk_mismatch(a, b):
        return popcount(a[:, :, None] ^ b[None, :, :]).sum(dim=1,
                                                           dtype=torch.int32)

    return k - 2 * allgather_gemm_overlapped(xp, wp, mesh, gemm=chunk_mismatch)
