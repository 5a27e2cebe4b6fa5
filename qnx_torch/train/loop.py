"""Training loop (torch port of :mod:`qnx.train.loop`): optax's Adam
(``torch.optim.Adam``, the same update to float32 rounding), epoch-wise exponential LR decay, squared hinge loss, the
per-kernel LR multiplier and the post-update Clip constraint.

The reference's ``Train.py``: ``model.compile(Adam(lr),
loss=squared_hinge)`` and ``model.fit`` with a ``LearningRateScheduler``
(BinaryNet's 1e-3 -> 1e-6) and the ``Clip`` weight constraint after every
update.  A step (:func:`train_step`) keeps the JAX step's order: gradients
times ``lr_mult``, then Adam, then the clip of the quantized layers'
latent kernels only.

Randomness comes from explicit ``torch.Generator`` s derived from
``cf.seed`` and the epoch index (:func:`epoch_generator`): the shuffle on
the CPU, dropout and stochastic binarization on the data's device.  A
resumed run re-derives the generators of the epochs it trains, so an
interrupted-and-resumed run equals an uninterrupted one bit for bit on the
CPU.  The trajectory does not equal JAX's: the generators differ.
"""
from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from qnx_torch.convert.pack_model import _check_device
from qnx_torch.models.factory import tensor_tree, init_model
from qnx_torch.utils.config import Config

#: optax.adam's defaults
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8

# the streams of epoch_generator
SHUFFLE, NOISE = 0, 1


# ---------------------------------------------------------------------------
# losses: squared hinge on ±1 one-hot targets (BinaryNet), or crossentropy
# ---------------------------------------------------------------------------

def squared_hinge(logits: torch.Tensor, targets_pm1: torch.Tensor) -> torch.Tensor:
    """Mean over batch and classes of max(0, 1 - y*t)^2, targets in ±1."""
    return torch.mean(torch.square(torch.relu(1.0 - logits * targets_pm1)))


def make_loss(cf: Config) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    if cf.loss == "squared_hinge":
        def fn(logits, labels):
            t = 2.0 * F.one_hot(labels.long(), cf.classes).to(logits.dtype) - 1.0
            return squared_hinge(logits, t)
        return fn
    if cf.loss == "crossentropy":
        def fn(logits, labels):
            return F.cross_entropy(logits, labels.long())
        return fn
    raise ValueError(f"unknown loss {cf.loss!r}")


def exp_decay_schedule(cf: Config, steps_per_epoch: int) -> Callable[[int], float]:
    """BinaryNet LR schedule: lr_start -> lr_end, exponential per epoch."""
    n = max(cf.epochs - 1, 1)
    decay = (cf.lr_end / cf.lr_start) ** (1.0 / n)

    def schedule(step: int) -> float:
        epoch = int(step) // steps_per_epoch
        return cf.lr_start * decay ** min(epoch, cf.epochs)

    return schedule


# ---------------------------------------------------------------------------
# quant-kernel tree utilities (Clip constraint + kernel_lr_multiplier)
# ---------------------------------------------------------------------------

def clip_constraint(params: dict, quant: dict) -> dict:
    """Latent-weight Clip, in place: w <- clip(w, -H, H) on the quantized
    layers' kernels only; returns ``params``."""
    with torch.no_grad():
        for name, meta in quant.items():
            params[name]["kernel"].clamp_(-meta["H"], meta["H"])
    return params


def scale_kernel_grads(grads: dict, quant: dict) -> dict:
    """Per-kernel LR multiplier: a new tree, the quantized layers' kernel
    gradients times ``lr_mult`` (1/H for Glorot H, arXiv:1511.00363).
    Adam normalises it away but for ``eps``; the JAX loop applies it here
    all the same."""
    return {name: {k: g * quant[name]["lr_mult"] if name in quant and k == "kernel"
                   else g for k, g in leaves.items()}
            for name, leaves in grads.items()}


# ---------------------------------------------------------------------------
# train state / steps
# ---------------------------------------------------------------------------

@dataclass
class TrainState:
    """The module (parameters, ``quant`` and ``batch_stats`` buffers), its
    Adam optimizer and the step counter; ``schedule`` is kept so resume
    logic and tests can see which epoch total the decay came from."""

    module: nn.Module
    optimizer: torch.optim.Adam
    step: int
    loss_fn: Callable
    schedule: Callable

    @property
    def params(self) -> dict:
        return tensor_tree(self.module)["params"]

    @property
    def quant(self) -> dict:
        return tensor_tree(self.module)["quant"]

    @property
    def batch_stats(self) -> dict:
        return tensor_tree(self.module)["batch_stats"]


def create_train_state(cf: Config, seed: int, steps_per_epoch: int,
                       device="cuda") -> TrainState:
    """A fresh state: ``init_model(cf, seed)`` on ``device``, optax's Adam
    (``torch.optim.Adam`` with its defaults, fused), step 0."""
    module, _ = init_model(cf, seed, device)
    schedule = exp_decay_schedule(cf, steps_per_epoch)
    optimizer = torch.optim.Adam(module.parameters(), lr=schedule(0),
                                 betas=(ADAM_B1, ADAM_B2), eps=ADAM_EPS, fused=True)
    return TrainState(module=module, optimizer=optimizer, step=0,
                      loss_fn=make_loss(cf), schedule=schedule)


def param_grads(module: nn.Module, loss: torch.Tensor) -> dict:
    """The gradients of ``loss`` in ``module``'s parameters, as a tree of
    the parameters' shape."""
    params = tensor_tree(module)["params"]
    flat = [t for leaves in params.values() for t in leaves.values()]
    it = iter(torch.autograd.grad(loss, flat))
    return {n: {k: next(it) for k in leaves} for n, leaves in params.items()}


def apply_gradients(state: TrainState, grads: dict) -> None:
    """The optimizer half of a step, in place: ``grads`` times ``lr_mult``,
    Adam at ``schedule(step)``, Clip; the step counter moves on.  ``grads``
    is left as it was."""
    tree = tensor_tree(state.module)
    params, quant = tree["params"], tree["quant"]
    for name, leaves in scale_kernel_grads(grads, quant).items():
        for k, g in leaves.items():  # the fused step reads grads as dense
            params[name][k].grad = g.contiguous()
    state.optimizer.param_groups[0]["lr"] = state.schedule(state.step)
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    clip_constraint(params, quant)
    state.step += 1


def train_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
               generator: torch.Generator | None = None):
    """One step: forward with training-mode BN (the running statistics move
    in place), STE backward, then :func:`apply_gradients`.  ``generator``
    (on the data's device) feeds dropout, required when
    ``cf.dropout_rate > 0``, and stochastic binarization.  Returns
    ``(state, {"loss", "accuracy"})``, 0-d tensors."""
    logits = state.module(images, train=True, generator=generator)
    loss = state.loss_fn(logits, labels)
    apply_gradients(state, param_grads(state.module, loss))
    acc = torch.mean((logits.detach().argmax(-1) == labels).float())
    return state, {"loss": loss.detach(), "accuracy": acc}


def eval_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor) -> dict:
    with torch.no_grad():
        logits = state.module(images, train=False)
        return {"loss": state.loss_fn(logits, labels),
                "accuracy": torch.mean((logits.argmax(-1) == labels).float()),
                "count": int(labels.shape[0])}


def evaluate(state: TrainState, x: torch.Tensor, y: torch.Tensor,
             batch_size: int = 1000) -> dict:
    """Batched eval; the overall accuracy and loss."""
    n = x.shape[0]
    tot, correct, loss_sum = 0, 0.0, 0.0
    for i in range(0, n, batch_size):
        m = eval_step(state, x[i:i + batch_size], y[i:i + batch_size])
        c = m["count"]
        tot += c
        correct += float(m["accuracy"]) * c
        loss_sum += float(m["loss"]) * c
    return {"accuracy": correct / tot, "loss": loss_sum / tot}


def epoch_generator(seed: int, epoch: int, stream: int, device="cpu") -> torch.Generator:
    """The generator of ``stream`` (:data:`SHUFFLE` or :data:`NOISE`) in
    ``epoch``, seeded from ``(seed, epoch, stream)`` by numpy's
    ``SeedSequence``."""
    s = np.random.SeedSequence([seed, epoch, stream]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(s))


def data_fingerprint(x_train, y_train) -> dict:
    """Cheap JSON-able fingerprint of the training data, stored in the
    checkpoint sidecar so resume can refuse to continue on different data
    (the loaders fall back to synthetic twins by design, so 'same config'
    does NOT imply 'same data').

    v2: alongside the v1 sums (kept so v1 checkpoints still compare on
    shared keys), hash a deterministic strided sample of x and y — a
    same-size reshuffle or augmentation change now changes the fingerprint
    even when the prefix sums happen to agree."""
    x = np.asarray(x_train)
    y = np.asarray(y_train)
    k = min(len(x), 256)
    stride = max(1, len(x) // 256)
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(x[::stride], dtype=np.float32).tobytes())
    h.update(np.ascontiguousarray(y[::stride]).astype(np.int64).tobytes())
    return {
        "v": 2,
        "n": int(len(x)),
        "x_sum": round(float(np.sum(x[:k], dtype=np.float64)), 6),
        "y_sum": int(np.sum(np.asarray(y[:k], np.int64))),
        "sha": h.hexdigest()[:16],
    }


def fit(cf: Config, data, log_every: int = 0, ckpt_dir: str | None = None,
        resume: bool = False, ckpt_every: int = 1, stop_after: int | None = None,
        drop_remainder: bool = False, device="cuda"):
    """model.fit: train cf.epochs over ``data = ((x_train, y_train),
    (x_test, y_test))`` (numpy, images in [-1, 1]) on ``device`` and report
    the test accuracy after each epoch.

    The data is staged on the device once.  As Keras ``fit``, the final
    partial batch of each epoch is trained on (one more ``train_step`` at
    the remainder's size, BN statistics over the partial batch);
    ``drop_remainder=True`` trains whole batches only.

    With ``ckpt_dir``, the full train state is saved every ``ckpt_every``
    epochs and after the last (``ckpt_dir/train_state``); ``resume=True``
    restores it (variables, Adam moments, step, completed epochs) and goes
    on from the next epoch, whose generators are derived as an
    uninterrupted run derives them.  ``stop_after=k`` stops after k
    completed epochs in all (the interruption hook).

    Returns ``(state, history)``; each epoch's entry has the last step's
    ``loss`` and ``accuracy`` and every step's loss (``losses``) under
    ``train``, and the test metrics under ``test``."""
    from qnx_torch.train.checkpoint import restore_train_state, save_train_state

    device = _check_device(device)
    (x_train, y_train), (x_test, y_test) = data
    n = x_train.shape[0]
    steps_per_epoch = n // cf.batch_size
    rem = n - steps_per_epoch * cf.batch_size
    if drop_remainder and steps_per_epoch > 0:
        rem = 0
    # optimizer steps per epoch (drives the per-epoch LR decay schedule)
    opt_steps = max(steps_per_epoch + (1 if rem else 0), 1)

    ckpt_path = os.path.join(os.path.abspath(ckpt_dir), "train_state") \
        if ckpt_dir else None
    data_fp = data_fingerprint(x_train, y_train) if ckpt_path else None
    start_epoch = 0
    if resume:
        if not (ckpt_path and os.path.exists(ckpt_path)):
            raise FileNotFoundError(
                f"resume requested but no checkpoint at {ckpt_path}")
        # epochs may differ: extending a run is the normal resume flow;
        # restore_train_state checks every other field and the data, and
        # builds the schedule from THIS cf's epoch total
        state, _, start_epoch = restore_train_state(
            ckpt_path, opt_steps, cf=cf, data_fp=data_fp, device=device)
    else:
        state = create_train_state(cf, cf.seed, opt_steps, device)
    if stop_after is not None and start_epoch >= stop_after:
        return state, []  # the checkpoint already covers the requested prefix

    x_train, y_train = _to(x_train, device), _to(y_train, device)
    x_test, y_test = _to(x_test, device), _to(y_test, device)
    history = []
    for epoch in range(start_epoch, cf.epochs):
        perm = torch.randperm(n, generator=epoch_generator(cf.seed, epoch, SHUFFLE))
        perm = perm.to(device)
        noise = epoch_generator(cf.seed, epoch, NOISE, device)
        losses = []
        batches = [perm[i * cf.batch_size:(i + 1) * cf.batch_size]
                   for i in range(steps_per_epoch)]
        if rem:  # the tail: the indices the whole batches never consumed
            batches.append(perm[steps_per_epoch * cf.batch_size:])
        for idx in batches:
            state, metrics = train_step(state, x_train[idx], y_train[idx], noise)
            losses.append(metrics["loss"])
        losses = torch.stack(losses).tolist()
        train = {"loss": losses[-1], "accuracy": float(metrics["accuracy"]),
                 "losses": losses}
        test = evaluate(state, x_test, y_test, cf.batch_size)
        history.append({"epoch": epoch, "train": train, "test": test})
        if log_every and (epoch % log_every == 0 or epoch == cf.epochs - 1):
            print(f"epoch {epoch}: train_loss={train['loss']:.4f} "
                  f"test_acc={test['accuracy']:.4f}", flush=True)
        stopping = stop_after is not None and epoch + 1 >= stop_after
        if ckpt_path and ((epoch + 1) % max(ckpt_every, 1) == 0
                          or epoch + 1 == cf.epochs or stopping):
            save_train_state(ckpt_path, state, cf, epoch + 1, data_fp=data_fp,
                             opt_steps=opt_steps)
        if stopping:
            break
    return state, history


def _to(a, device) -> torch.Tensor:
    """numpy -> tensor on ``device``, float32 or int64 labels."""
    a = np.asarray(a)
    t = torch.from_numpy(np.ascontiguousarray(
        a.astype(np.float32) if a.dtype.kind == "f" else a.astype(np.int64)))
    return t.to(device)
