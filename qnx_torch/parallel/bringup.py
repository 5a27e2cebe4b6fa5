"""Multi-process bring-up workloads (torch port of :mod:`qnx.parallel.bringup`).

``bringup_workloads(mesh)`` runs the two distribution paths over whatever
mesh it is given and reduces each to scalars that every rank holds alike:

* **the DP+TP train step** of a tiny ``QuantMLP`` (MNIST, dim 16 tp, two
  hidden layers, batch 4 dp, H 1), with GSPMD's semantics, which are the
  one-device step's: the loss and accuracy over the global batch; the
  training BatchNorm's statistics over the global batch (the local sums of
  x and x^2 all-reduced over 'data', then flax's fast variance); every
  kernel's output channels and their BN vectors sharded over 'model', the
  activations all-gathered at each layer boundary; the gradients
  all-reduced over 'data'; Adam and the ±H clip on each rank's shard.
  ``bn="local"`` keeps each rank's own batch statistics instead (DDP
  without SyncBN), which is not that semantics;
* **the TP int8 forward** of a tiny VGG (width 4 tp, dense 16 tp): the
  ``_int_mm`` dense layers, which XLA partitions in JAX, run on their
  channel shard and are all-gathered over 'model'; kernel E's convs run
  whole on every model rank, as GSPMD replicates the Pallas call; each
  data group takes its slice of the batch.  The float first layer and the
  float head run whole, on the whole batch, on every rank: a cuDNN conv or
  a cuBLAS product on a channel or batch shard may take another algorithm
  and round otherwise than the one-rank run, and the logits are held equal
  to that run's bit for bit (the integer layers are exact on any shard).

The collectives are written by hand (:mod:`qnx_torch.parallel.mesh`), as
Megatron's column-parallel layers pair them: :class:`_DataSum` sums over
'data' and sums its gradient the same way; :class:`_ToModel` is the
identity on a sharded layer's replicated input and sums its gradient over
'model' (each rank's output columns give part of it);
:class:`_ModelGather` concatenates the channel shards and hands each rank
its own slice of the gradient, which is whole and equal on every model
rank after :class:`_ToModel` or a replicated layer (``torch.distributed.
nn``'s all-gather sums the ranks' gradients instead, m times the step's
in front of the replicated head).

The variables default to the port's ``init_model`` draws (seeds 0 and 1);
``variables`` / ``vgg_variables`` take a variables tree (numpy, flax names
and layouts), so a run can start from the JAX package's draws.
"""
from __future__ import annotations

import numpy as np
import torch

from .mesh import (DATA_AXIS, MODEL_AXIS, P, all_gather, all_reduce,
                   axis_group, axis_rank, axis_size)
from .sharding import gather, local_slice, shard_module, train_state_shardings
from .tp_forward import batch_gather, batch_slice


def _leaves(tree):
    """The leaves of a nested dict in ``jax.tree.leaves`` order (keys
    sorted at every level)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def _checksum(tree) -> torch.Tensor:
    """Deterministic weighted sum over all leaves -> float32 scalar.
    Weights vary per leaf and per element, ``sqrt(arange(1, n + 1) + i)``
    for leaf i, so sign flips and permutations cannot cancel."""
    total = None
    for i, leaf in enumerate(_leaves(tree)):
        leaf = torch.as_tensor(leaf).to(torch.float32).reshape(-1)
        w = torch.sqrt(torch.arange(1, leaf.shape[0] + 1, dtype=torch.float32,
                                    device=leaf.device) + float(i))
        s = torch.sum(leaf * w)
        total = s if total is None else total + s
    return total


def checksum_weight(tree) -> float:
    """The sum of :func:`_checksum`'s weights over ``tree``'s shapes: a
    checksum moves by at most this times the largest change of an
    element."""
    return float(sum(np.sqrt(np.arange(1, np.asarray(leaf).size + 1) + i).sum()
                     for i, leaf in enumerate(_leaves(tree))))


class _DataSum(torch.autograd.Function):
    """Sum over the mesh's 'data' group; the gradient is summed the same
    way (each data rank's loss depends on every rank's statistics)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce(x, axis_group(mesh, DATA_AXIS))

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), axis_group(ctx.mesh, DATA_AXIS)), None


class _ToModel(torch.autograd.Function):
    """The identity on the replicated input of a channel-sharded layer; the
    gradient, which each rank has for its own output channels only, is
    summed over 'model'."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), axis_group(ctx.mesh, MODEL_AXIS)), None


class _ModelGather(torch.autograd.Function):
    """The channel shards concatenated over 'model' (last dim); the
    gradient is this rank's slice of the replicated gradient."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.n = mesh, x.shape[-1]
        return all_gather(x, axis_group(mesh, MODEL_AXIS), x.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        r = axis_rank(ctx.mesh, MODEL_AXIS)
        return g[..., r * ctx.n:(r + 1) * ctx.n].contiguous(), None


def _bn_train(bn, y: torch.Tensor, mesh, global_stats: bool) -> torch.Tensor:
    """flax's training BatchNorm on ``y``'s channel shard, the statistics
    over the global batch (or this rank's with ``global_stats`` False)."""
    if not global_stats:
        return bn(y, train=True)
    n = y.shape[0] * axis_size(mesh, DATA_AXIS)
    s = _DataSum.apply(torch.stack([y.sum(0), y.square().sum(0)]), mesh) / n
    mean = s[0]
    var = torch.clamp(s[1] - mean.square(), min=0.0)
    with torch.no_grad():
        m = bn.momentum
        bn.mean.copy_(m * bn.mean + (1 - m) * mean)
        bn.var.copy_(m * bn.var + (1 - m) * var)
    mul = torch.rsqrt(var + bn.epsilon) * bn.scale
    return (y - mean) * mul + bn.bias


def shard_train_module(module, mesh) -> dict:
    """Replace, in place, every parameter and BN statistic of ``module``
    that :func:`train_state_shardings` shards with this rank's slice;
    returns ``{(collection, layer, leaf): spec}`` of every leaf."""
    from qnx_torch.models.factory import tensor_tree

    tree = tensor_tree(module)
    specs = train_state_shardings(mesh, tree)
    flat = {}
    for c in ("params", "batch_stats"):
        for name, leaves in tree[c].items():
            layer = module.get_submodule(name)
            for k, t in leaves.items():
                spec = flat[c, name, k] = specs[c][name][k]
                if spec == P():
                    continue
                part = local_slice(t.detach(), spec, mesh)
                setattr(layer, k, torch.nn.Parameter(part) if c == "params" else part)
    return flat


def _tp_mlp_logits(module, x, mesh, specs: dict, global_stats: bool):
    """The sharded ``QuantMLP`` training forward (no dropout, no stochastic
    binarization: the bring-up's config has neither)."""
    cf = module.cf
    x = x.reshape(x.shape[0], -1)
    for i in range(cf.num_hidden + 1):
        name, bn = ((f"dense_{i}", f"bn_{i}") if i < cf.num_hidden
                    else ("dense_out", "bn_out"))
        # 10 classes shard where the model degree divides them, as in JAX
        sharded = specs["params", name, "kernel"] != P()
        if sharded:
            x = _ToModel.apply(x, mesh)
        y = _bn_train(getattr(module, bn), getattr(module, name)(x, None), mesh,
                      global_stats)
        if i < cf.num_hidden:
            y = module.act(y)
        x = _ModelGather.apply(y, mesh) if sharded else y
    return x


def train_step_dp_tp(state, images, labels, mesh, specs: dict,
                     global_stats: bool = True) -> dict:
    """One DP+TP step of :func:`shard_train_module`'s module in ``state``
    on this rank's slice of the batch; returns the global loss and
    accuracy (the same on every rank)."""
    from qnx_torch.train import loop as TL

    module, cf = state.module, state.module.cf
    dp = axis_size(mesh, DATA_AXIS)
    n = images.shape[0] * dp  # the global batch
    logits = _tp_mlp_logits(module, images, mesh, specs, global_stats)
    t = 2.0 * torch.nn.functional.one_hot(labels.long(), cf.classes).to(logits.dtype) - 1.0
    if cf.loss != "squared_hinge":
        raise ValueError("the bring-up step takes the squared hinge loss")
    local = torch.sum(torch.square(torch.relu(1.0 - logits * t))) / (n * cf.classes)
    grads = TL.param_grads(module, local)
    group = axis_group(mesh, DATA_AXIS)
    grads = {name: {k: all_reduce(g, group) for k, g in leaves.items()}
             for name, leaves in grads.items()}
    TL.apply_gradients(state, grads)
    correct = (logits.detach().argmax(-1) == labels).sum().to(torch.float32)
    return {"loss": all_reduce(local.detach(), group),
            "accuracy": all_reduce(correct, group) / n}


def gathered_params(module, mesh, specs: dict) -> dict:
    """The module's parameters, each whole (gathered over 'model')."""
    from qnx_torch.models.factory import tensor_tree

    return {name: {k: gather(t.detach(), specs["params", name, k], mesh)
                   for k, t in leaves.items()}
            for name, leaves in tensor_tree(module)["params"].items()}


def shard_int8(model, mesh):
    """This rank's copy of an int8 VGG for :func:`tp_int8_forward`: the
    dense layers on their channel shard."""
    return shard_module(model, mesh, ("denses.",))


def tp_int8_forward(model, x: torch.Tensor, mesh) -> torch.Tensor:
    """The int8 VGG forward of :func:`shard_int8`'s copy: the float first
    layer on the whole batch, then this data group's rows; kernel E's convs
    whole; each dense layer's channel shard, gathered over 'model'; the
    float head on the whole batch (module docstring: the float layers run
    at the one-rank run's shapes, so they round as it does).  Returns the
    whole batch's logits."""
    group = axis_group(mesh, MODEL_AXIS)
    codes = batch_slice(model.first(x), mesh)
    for layer in model.convs:
        codes = layer(codes)
    codes = codes.reshape(codes.shape[0], -1)
    for layer in model.denses:
        codes = all_gather(layer(codes), group, 1)
    return model.head(batch_gather(codes, mesh, x.shape[0]))


def bringup_configs(dp: int, tp: int):
    """The bring-up's two configs at mesh (dp, tp): the MLP trained and the
    VGG served."""
    from qnx_torch.utils.config import Config

    cf = Config(dataset="MNIST", architecture="mlp", network_type="full-bnn",
                dim=16 * tp, num_hidden=2, batch_size=4 * dp, H=1.0)
    cf_v = Config(dataset="synthetic-cifar", architecture="vgg",
                  width=4 * tp, dense_units=16 * tp, network_type="full-bnn",
                  H=1.0, first_layer_float=True, last_layer_float=True)
    return cf, cf_v


def bringup_inputs(dp: int):
    """The images and labels of both workloads, from
    ``np.random.default_rng(7)`` as the JAX bring-up draws them."""
    rng = np.random.default_rng(7)
    images = rng.uniform(-1, 1, (4 * dp, 28, 28, 1)).astype(np.float32)
    labels = rng.integers(0, 10, 4 * dp).astype(np.int32)
    imgs = rng.uniform(-1, 1, (4 * dp, 32, 32, 3)).astype(np.float32)
    return images, labels, imgs


def bringup_workloads(mesh, device="cuda", variables=None, vgg_variables=None,
                      bn: str = "global", shape=None) -> dict:
    """One DP+TP train step and one TP int8 forward over ``mesh``; returns
    the scalars {loss, accuracy, params_checksum, logits_checksum}, equal
    on every rank, with the workloads' mesh shape.  ``shape`` (dp, tp) runs
    another mesh shape's workloads, as one process (``mesh`` None) does to
    give the reference of a multi-rank run."""
    from qnx_torch.convert.pack_model import pack_int8
    from qnx_torch.models.factory import build_model, init_model, load_variables
    from qnx_torch.train import loop as TL

    if bn not in ("global", "local"):
        raise ValueError(f"bn must be 'global' or 'local', got {bn!r}")
    device = torch.device(device)
    dp, tp = shape or (axis_size(mesh, DATA_AXIS), axis_size(mesh, MODEL_AXIS))
    cf, cf_v = bringup_configs(dp, tp)
    images, labels, imgs = bringup_inputs(dp)

    # --- DP+TP fake-quant training step ----------------------------------
    if variables is None:
        variables = init_model(cf, 0, "cpu")[1]
    module = load_variables(build_model(cf), variables).to(device)
    specs = shard_train_module(module, mesh)
    schedule = TL.exp_decay_schedule(cf, 10)
    state = TL.TrainState(
        module=module, step=0, loss_fn=TL.make_loss(cf), schedule=schedule,
        optimizer=torch.optim.Adam(module.parameters(), lr=schedule(0),
                                   betas=(TL.ADAM_B1, TL.ADAM_B2), eps=TL.ADAM_EPS,
                                   fused=True))
    rows = batch_slice(torch.arange(cf.batch_size), mesh).numpy()
    metrics = train_step_dp_tp(
        state, torch.from_numpy(images[rows]).to(device),
        torch.from_numpy(labels[rows]).to(device), mesh, specs, bn == "global")
    params_sum = _checksum(gathered_params(module, mesh, specs))

    # --- TP int8 serving forward -----------------------------------------
    if vgg_variables is None:
        vgg_variables = init_model(cf_v, 1, "cpu")[1]
    model = shard_int8(pack_int8(vgg_variables, cf_v, device=device), mesh)
    with torch.inference_mode():
        logits = tp_int8_forward(model, torch.from_numpy(imgs).to(device), mesh)
        logits_sum = _checksum(logits)

    return {
        "mesh": [dp, tp],
        "loss": float(metrics["loss"]),
        "accuracy": float(metrics["accuracy"]),
        "params_checksum": float(params_sum),
        "logits_checksum": float(logits_sum),
    }
