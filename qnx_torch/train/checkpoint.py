"""Checkpoint / resume (torch port of :mod:`qnx.train.checkpoint`).

``save_checkpoint`` / ``load_checkpoint`` persist the variables tree
(params, quant metadata, BN statistics) and the config, enough to convert
the model to any inference engine; ``save_train_state`` /
``restore_train_state`` persist the whole training state for an exact
resume.  Each checkpoint is two files: the payload at ``path``, a
``torch.save`` of tensors and plain containers that
``torch.load(..., weights_only=True)`` reads, and the JSON sidecar
``<path>.config.json``, with the JAX package's keys.  Both are written to
a temporary file first and renamed into place, so a crash never leaves a
truncated file under the final name.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from qnx_torch.utils.config import Config


def _replace_atomic(path: str, write) -> None:
    """``write(tmp)``, then rename ``tmp`` over ``path``."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def _write_sidecar_atomic(path: str, obj) -> None:
    def write(tmp):
        with open(tmp, "w") as f:
            json.dump(obj, f, indent=1)
            f.flush()
            os.fsync(f.fileno())

    _replace_atomic(path, write)


def _save_payload(path: str, payload: dict) -> None:
    def write(tmp):
        with open(tmp, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())

    _replace_atomic(path, write)


def _tensors(tree):
    """A tree of numpy arrays or tensors as CPU tensors (owning copies)."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    return torch.from_numpy(np.array(tree))


def _arrays(tree):
    if isinstance(tree, dict):
        return {k: _arrays(v) for k, v in tree.items()}
    return tree.numpy()


def save_checkpoint(path: str, variables: dict, cf: Config) -> str:
    """Write a variables tree and the config sidecar; returns the final
    path."""
    path = os.path.abspath(path)
    _save_payload(path, {"variables": _tensors(variables)})
    _write_sidecar_atomic(path + ".config.json", dataclasses.asdict(cf))
    return path


def load_checkpoint(path: str):
    """``(variables, cf)``: the numpy variables tree, as the converters take
    it, and the config."""
    path = os.path.abspath(path)
    with open(path + ".config.json") as f:
        cf = Config(**json.load(f))
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return _arrays(payload["variables"]), cf


def save_train_state(path: str, state, cf: Config, epochs_done: int,
                     data_fp: dict | None = None,
                     opt_steps: int | None = None) -> str:
    """Persist the whole training state for an exact resume: the variables
    (params, quant, batch_stats), the optimizer's ``state_dict`` (Adam's
    count and moments), the step counter and the number of completed epochs.  The generators are
    not stored: ``fit`` derives each epoch's from ``cf.seed``.

    ``opt_steps`` (optimizer steps per epoch, after ``drop_remainder``) is
    recorded so restore can (a) cross-check the payload's step counter
    against ``epochs_done``, catching a crash that left a newer payload
    beside a stale sidecar, and (b) refuse a resume whose batching changed
    (``drop_remainder`` flipped), which would shift the LR schedule and the
    batches."""
    from qnx_torch.models.factory import export_variables

    path = os.path.abspath(path)
    _save_payload(path, {
        "variables": _tensors(export_variables(state.module)),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
    })
    _write_sidecar_atomic(path + ".config.json",
                          {"config": dataclasses.asdict(cf),
                           "epochs_done": int(epochs_done),
                           "data_fp": data_fp,
                           "opt_steps": None if opt_steps is None
                           else int(opt_steps)})
    return path


def restore_train_state(path: str, steps_per_epoch: int, cf: Config | None = None,
                        data_fp: dict | None = None, device="cuda"):
    """Load a :func:`save_train_state` checkpoint onto ``device``; returns
    ``(state, saved_cf, epochs_done)``.

    ``cf`` is the config of the resuming run: it must equal the saved one
    in every field but ``epochs`` (extending a run is the normal resume),
    and it, not the saved one, builds the LR schedule, so the decay follows
    the new epoch total as re-running Keras fit with more epochs would.
    ``cf=None`` takes the saved config.  ``data_fp``
    (:func:`qnx_torch.train.loop.data_fingerprint`) refuses a resume on
    different data, compared on the keys both fingerprints have (a v1
    fingerprint has no ``sha``)."""
    from qnx_torch.models.factory import load_variables
    from qnx_torch.train.loop import create_train_state

    path = os.path.abspath(path)
    with open(path + ".config.json") as f:
        sidecar = json.load(f)
    if "config" not in sidecar:  # a weights-only save_checkpoint sidecar
        raise ValueError(
            f"{path} is a weights-only checkpoint (no train state); "
            "resume requires one written by save_train_state / fit(ckpt_dir=)")
    cf_saved = Config(**sidecar["config"])
    if cf is None:
        cf = cf_saved
    elif cf_saved.replace(epochs=cf.epochs) != cf:
        raise ValueError(
            "checkpoint config differs from the requested config:\n"
            f"  saved:     {cf_saved}\n  requested: {cf}")
    saved_fp = sidecar.get("data_fp")
    if data_fp is not None and saved_fp is not None:
        keys = (set(saved_fp) & set(data_fp)) - {"v"}
        if any(saved_fp[k] != data_fp[k] for k in keys):
            raise ValueError(
                "checkpoint was trained on DIFFERENT data than this run "
                f"(saved fingerprint {saved_fp}, current {data_fp}) — "
                "resuming would silently mix datasets (e.g. a synthetic "
                "fallback after real files went missing). Fix the data "
                "path or start fresh.")
    saved_opt_steps = sidecar.get("opt_steps")
    if saved_opt_steps is not None and saved_opt_steps != steps_per_epoch:
        raise ValueError(
            f"checkpoint was trained at {saved_opt_steps} optimizer steps "
            f"per epoch but this run derives {steps_per_epoch} — same "
            "config but different batching (drop_remainder flipped, or "
            "different data size) would silently shift the LR schedule "
            "and the replayed batches")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    epochs_done = int(sidecar["epochs_done"])
    if saved_opt_steps is not None and payload["step"] != epochs_done * saved_opt_steps:
        # fit checkpoints only at epoch boundaries: a mismatch means the
        # sidecar is stale relative to the payload (a crash between the
        # two writes), and resuming would re-train consumed epochs
        raise ValueError(
            f"checkpoint is internally inconsistent: payload step "
            f"{payload['step']} != epochs_done {epochs_done} * "
            f"opt_steps {saved_opt_steps} — the sidecar is stale "
            "relative to the payload (likely a crash between the "
            "two writes); delete the checkpoint and restart from the "
            "last good one")
    state = create_train_state(cf, cf.seed, steps_per_epoch, device)
    load_variables(state.module, payload["variables"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state, cf_saved, epochs_done
