"""Sharding rules: variable name -> :class:`~qnx_torch.parallel.mesh.P`, for
training and serving (torch port of :mod:`qnx.parallel.sharding`).

Training (fake-quant): every quantized kernel is output-channel-sharded
over the 'model' axis; per-channel vectors (BN parameters and statistics,
biases) follow their channel axis; the batch is sharded over 'data'.  The
port keeps flax's names and layouts (``kernel`` HWIO or (in, out),
``bias``, ``scale``, ``mean``, ``var``), so the rules read as JAX's.

Serving (packed): (Kw, N) weight planes shard on N, (H, W, N) ``corr`` on
N, conv weights HWIO on O, per-channel vectors on 0; scalars and axes the
model degree does not divide (the 10-class heads) replicate.  The port's
own K-major copies follow their N axis: the heads' ``wt`` (planes, N, Kw)
on 1, ``I8Conv.wk`` (N, 9 Cp) on 0.

:func:`shard_module` gives a rank the local slices of a module's tensors;
:func:`gather` rebuilds a full tensor from them.
"""
from __future__ import annotations

import copy

import torch
from torch import nn

from .mesh import MODEL_AXIS, P, all_gather, axis_group, axis_rank, axis_size

#: the port's K-major weight copies: buffer name -> its N axis
_N_AXIS = {"wt": 1, "wk": 0}


def _divisible(shape, axis: int, m: int) -> bool:
    return len(shape) > axis and shape[axis] % m == 0 and shape[axis] >= m


def _on(axis: int, ndim: int) -> P:
    return P(*([None] * axis), MODEL_AXIS, *([None] * (ndim - axis - 1)))


def _spec_for_path(path: tuple, leaf, mesh) -> P:
    """The training rule for the leaf at ``path`` (its names, outermost
    first)."""
    m = axis_size(mesh, MODEL_AXIS)
    last = path[-1] if path else ""
    shape = tuple(getattr(leaf, "shape", ()))
    ndim = len(shape)
    if last == "kernel":
        if ndim == 2 and _divisible(shape, 1, m):  # dense (K, N)
            return P(None, MODEL_AXIS)
        if ndim == 4 and _divisible(shape, 3, m):  # conv HWIO
            return P(None, None, None, MODEL_AXIS)
    if ndim == 1 and last in ("bias", "scale", "mean", "var") and _divisible(
            shape, 0, m):
        return P(MODEL_AXIS)
    return P()


def _map_tree(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def train_state_shardings(mesh, variables: dict) -> dict:
    """The spec of every leaf of a variables tree (``{"params", "quant",
    "batch_stats"}``, numpy or tensors): kernels and their channel vectors
    model-sharded, axes the degree does not divide (the head) and scalars
    (``quant``'s ``H``, ``lr_mult``) replicated."""
    return _map_tree(lambda path, leaf: _spec_for_path(path, leaf, mesh),
                     variables)


def _packed_spec(name: str, shape, m: int) -> P:
    ndim = len(shape)
    leaf = name.rsplit(".", 1)[-1]
    if leaf in _N_AXIS:
        axis = _N_AXIS[leaf]
        return _on(axis, ndim) if _divisible(shape, axis, m) else P()
    if ndim == 4 and _divisible(shape, 3, m):  # conv HWIO weights
        return P(None, None, None, MODEL_AXIS)
    if ndim == 3 and _divisible(shape, 2, m):  # (H, W, N) pad corr
        return P(None, None, MODEL_AXIS)
    if ndim == 2 and _divisible(shape, 1, m):  # (Kw|K|L-1, N) planes
        return P(None, MODEL_AXIS)
    if ndim == 1 and _divisible(shape, 0, m):  # per-channel vectors
        return P(MODEL_AXIS)
    return P()


def packed_model_shardings(mesh, model: nn.Module) -> dict:
    """``{buffer name: spec}`` of a packed inference module (every buffer,
    by its qualified name)."""
    m = axis_size(mesh, MODEL_AXIS)
    return {name: _packed_spec(name, tuple(b.shape), m)
            for name, b in model.named_buffers()}


def local_slice(t: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (a copy, strides kept)."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            n = t.shape[dim] // axis_size(mesh, axis)
            t = t.narrow(dim, axis_rank(mesh, axis) * n, n)
    return t.clone()


def gather(t: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The full tensor from every rank's block under ``spec``."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            t = all_gather(t, axis_group(mesh, axis), dim)
    return t


def shard_module(model: nn.Module, mesh, prefixes=("",)) -> nn.Module:
    """A copy of ``model`` whose buffers under the qualified-name
    ``prefixes`` are this rank's slices (:func:`packed_model_shardings`);
    the other buffers stay whole."""
    specs = packed_model_shardings(mesh, model)
    local = copy.deepcopy(model)
    for name, spec in specs.items():
        if spec == P() or not name.startswith(tuple(prefixes)):
            continue
        owner, _, leaf = name.rpartition(".")
        mod = local.get_submodule(owner)
        setattr(mod, leaf, local_slice(getattr(mod, leaf), spec, mesh))
    return local
