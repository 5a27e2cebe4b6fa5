"""Tensor-parallel packed forwards with explicitly overlapped collectives
(torch port of :mod:`qnx.parallel.tp_forward`), the serving path's
consumer of :mod:`qnx_torch.parallel.overlap`.

Layout: packed weight planes (Kw, N) are output-channel (N) sharded; a
layer's output bits are packed along N, so the next layer's reduction axis
Kw arrives already K-sharded: one overlapped activation gather per layer
boundary, weights never move.  The N shard must be word-aligned (N/m a
multiple of 32), which :func:`tp_supported` checks.  Each ring chunk is a
launch of kernel B at wide N (:func:`qnx_torch.kernels.xnor_gemm.
xnor_gemm_popcount`), its int32 sums exact, so the TP forward equals the
one-rank forward bit for bit.

What runs replicated on every model rank: the 10-class head (after an
all-gather of its input words), the VGG's conv stage (kernel A's convs),
and the float first layer, whose word shard each rank then keeps.

Each data group runs its integer layers (the convs and the ring) on its
own slice of the batch when the batch splits evenly over 'data'
(:func:`_batch_axis`).  The float boundary layers, the first layer and a
float head, run on the whole batch on every rank: a cuBLAS or cuDNN float
product picks its kernel, and with it the order of its sums, by shape, so
a column shard or a slice of the rows need not round as the one-rank
product does (a float head on 128 rows differed from 256 rows' by 1.7e-6
on the card), and a sign that flips at a BN threshold would break the bit
equality the ring holds.  The JAX package partitions the first layer's
float dot over N instead.  Every rank returns the whole batch's logits.
"""
from __future__ import annotations

import torch

from qnx_torch.kernels.xnor_conv_fused import _threshold_pack
from qnx_torch.nn.inference import (PackedDenseBits, PackedMLP, PackedVGG,
                                    PlaneVGG)

from .mesh import (DATA_AXIS, MODEL_AXIS, all_gather, axis_group, axis_rank,
                   axis_size)
from .overlap import allgather_gemm_overlapped
from .sharding import shard_module

WORD = 32


def _batch_axis(mesh, batch: int):
    """'data' when the batch splits evenly over the data axis (each data
    group runs its own model ring on its slice), else None (every data
    group runs the whole batch rather than fail on an odd one)."""
    dp = axis_size(mesh, DATA_AXIS)
    return DATA_AXIS if dp > 1 and batch % dp == 0 else None


def batch_slice(x: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """This data group's rows of ``x`` along its batch ``dim``
    (:func:`_batch_axis`)."""
    if _batch_axis(mesh, x.shape[dim]) is None:
        return x
    n = x.shape[dim] // axis_size(mesh, DATA_AXIS)
    return x.narrow(dim, axis_rank(mesh, DATA_AXIS) * n, n).contiguous()


def batch_gather(y: torch.Tensor, mesh, batch: int, dim: int = 0) -> torch.Tensor:
    """The whole batch's rows from every data group's slice."""
    if _batch_axis(mesh, batch) is None:
        return y
    return all_gather(y.contiguous(), axis_group(mesh, DATA_AXIS), dim)


def ring_xnor_gemm(xp: torch.Tensor, wp: torch.Tensor, k: int, mesh) -> torch.Tensor:
    """TP packed binary GEMM: the activation all-gather decomposed into the
    ring, each chunk multiplied by the resident weight rows with kernel B.

    xp: (M, Kw/m) packed ±1 activations, this rank's word chunk; wp:
    (Kw, N/m) packed weights, this rank's shard.  Returns the (M, N/m)
    int32 exact ±1 dot over the k real bits.  Per chunk the kernel returns
    32 kw_c - 2 mismatch_c; the chunks sum to 32 Kw - 2 mismatch, so the
    constant k - 32 Kw recovers the dot (pad bits are 0 in both operands,
    hence never mismatch)."""
    from qnx_torch.kernels.xnor_gemm import xnor_gemm_popcount

    def chunk_gemm(a, b):
        return xnor_gemm_popcount(a, b, a.shape[1] * WORD)

    s = allgather_gemm_overlapped(xp.contiguous(), wp, mesh, gemm=chunk_gemm)
    return s + (k - WORD * wp.shape[0])


def _code_bits(s: torch.Tensor, sgn: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """Integer threshold epilogue and repack, bit-identical to the fused
    kernel's: bit = (sgn * s >= tau)."""
    return _threshold_pack(s, sgn, tau)


def _denses(model) -> tuple[str, list] | None:
    if isinstance(model, PackedMLP):
        return "hidden", list(model.hidden)
    if isinstance(model, PackedVGG):
        return "denses", list(model.denses)
    return None


def tp_supported(model, mesh) -> bool:
    """True when every hidden dense layer of ``model`` (``PackedMLP`` or
    ``PackedVGG``) is a binary ``PackedDenseBits`` whose output channels
    split word-aligned over the mesh's model axis (m > 1)."""
    m = axis_size(mesh, MODEL_AXIS)
    found = _denses(model)
    if m <= 1 or found is None:
        return False
    return all(isinstance(l, PackedDenseBits)
               and l.wp.shape[0] % m == 0          # ring K-chunks split evenly
               and l.sgn.shape[0] % (m * WORD) == 0  # word-aligned N shards
               for l in found[1])


def shard_tp_model(model, mesh):
    """This rank's copy of ``model`` for the TP forward: the hidden dense
    layers' ``wp``, ``sgn`` and ``tau`` sliced to its output channels, every
    other layer whole."""
    return shard_module(model, mesh, (f"{_denses(model)[0]}.",))


def _own_words(bits: torch.Tensor, mesh) -> torch.Tensor:
    m, r = axis_size(mesh, MODEL_AXIS), axis_rank(mesh, MODEL_AXIS)
    nw = bits.shape[1] // m
    return bits[:, r * nw:(r + 1) * nw].contiguous()


def _ring_tail(model, bits: torch.Tensor, denses, mesh, batch: int) -> torch.Tensor:
    """This data group's flat (b, Kw) words -> this rank's word chunk ->
    ring layers -> words all-gathered over 'model', then over 'data' ->
    the replicated head on the whole batch."""
    bits = _own_words(bits, mesh)
    for layer in denses:
        s = ring_xnor_gemm(bits, layer.wp, layer.k, mesh)
        bits = _code_bits(s, layer.sgn, layer.tau)
    bits = all_gather(bits, axis_group(mesh, MODEL_AXIS), 1)
    return model.head(batch_gather(bits, mesh, batch))


def tp_mlp_forward(model: PackedMLP, x: torch.Tensor, mesh) -> torch.Tensor:
    """``PackedMLP`` forward of :func:`shard_tp_model`'s copy: first layer,
    hidden layers on the ring, head replicated.  Bit-identical to the
    one-rank ``mlp_forward``; returns the whole batch's logits."""
    b = x.shape[0]
    bits = batch_slice(model.first(x.reshape(b, -1)), mesh)
    return _ring_tail(model, bits, model.hidden, mesh, b)


def tp_vgg_forward(model: PackedVGG, x: torch.Tensor, mesh) -> torch.Tensor:
    """``PackedVGG`` forward of :func:`shard_tp_model`'s copy: the conv
    stage replicated over 'model' (kernel A's convs on every model rank),
    the dense tail, where the weight mass lives, on the ring.
    Bit-identical to ``vgg_forward``; returns the whole batch's logits."""
    b = x.shape[0]
    bits = batch_slice(model.first(x), mesh)
    for layer in model.convs:
        bits = layer(bits)
    bits = bits.reshape(bits.shape[0], -1)
    return _ring_tail(model, bits, model.denses, mesh, b)


def make_tp_forward(model, mesh):
    """``(local model, forward)`` for :class:`qnx_torch.serve.ServeEngine`:
    the ring TP path when :func:`tp_supported`, else None."""
    if not tp_supported(model, mesh):
        return None
    fwd = tp_mlp_forward if isinstance(model, PackedMLP) else tp_vgg_forward
    return shard_tp_model(model, mesh), lambda m, xx: fwd(m, xx, mesh)


def _middle(model, h: torch.Tensor) -> torch.Tensor:
    """The layers between an engine model's first layer and its head: an
    MLP's hidden layers, or a VGG's convs, flatten and dense layers."""
    if hasattr(model, "hidden"):
        for layer in model.hidden:
            h = layer(h)
        return h
    for layer in model.convs:
        h = layer(h)
    h = h.reshape(*h.shape[:-3], -1)  # of each plane in a bit-plane model
    for layer in model.denses:
        h = layer(h)
    return h


def replicated_forward(model, x: torch.Tensor, mesh, forward=None) -> torch.Tensor:
    """The data-parallel replicated path, for a model the ring does not
    take: the model ranks of a data group duplicate the work (as GSPMD
    replicates a custom call it cannot partition).  An engine model
    (``first``, its hidden or conv and dense layers, ``head``) runs its
    first layer and head on the whole batch and the layers between on this
    data group's slice (the planes' batch dim of a bit-plane model is 1);
    a ``forward`` runs whole on the slice.  Returns the whole batch's
    logits."""
    b = x.shape[0]
    if forward is not None or not hasattr(model, "head"):
        forward = forward or (lambda m, xx: m(xx))
        return batch_gather(forward(model, batch_slice(x, mesh)), mesh, b)
    h = model.first(x if hasattr(model, "convs") else x.reshape(b, -1))
    dim = 1 if isinstance(model, PlaneVGG) else 0
    h = _middle(model, batch_slice(h, mesh, dim))
    return model.head(batch_gather(h, mesh, b, dim))
