"""One rank of an N-rank qnx_torch bring-up (the port of the JAX package's
``experiments/multiproc_worker.py``).

    python -m qnx_torch.experiments.multiproc_worker INIT RANK WORLD \\
        [--mp M] [--device cuda|cpu] [--backend gloo|nccl] \\
        [--variables V.npz] [--bn global|local]

Joins the world at ``INIT`` (``file://PATH`` or ``tcp://HOST:PORT``),
builds the (data, model) mesh over every rank, runs
:func:`qnx_torch.parallel.bringup.bringup_workloads` (a DP+TP train step
and a TP int8 forward) and prints one line, ``BRINGUP {json}``, with the
scalars, the rank, the world size, the backend and the transport.  Every
rank prints the same scalars.  ``--variables`` starts both workloads from
the variables trees saved by :func:`save_variables` (for example the JAX
package's draws) instead of the port's own.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def save_variables(path: str, **trees) -> None:
    """Save variables trees (numpy leaves) by name, e.g. ``variables=...,
    vgg_variables=...``, as one ``.npz``."""
    np.savez(path, **{f"{name}/{k}": v for name, tree in trees.items()
                      for k, v in _flatten(tree)})


def load_variables(path: str) -> dict:
    """``{name: variables tree}`` of :func:`save_variables`'s file."""
    out: dict = {}
    with np.load(path) as f:
        for key in f.files:
            node = out
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = f[key]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m qnx_torch.experiments.multiproc_worker")
    p.add_argument("init")
    p.add_argument("rank", type=int)
    p.add_argument("world", type=int)
    p.add_argument("--mp", type=int, default=None,
                   help="model-parallel degree (default: default_model_parallel)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    p.add_argument("--variables", default=None)
    p.add_argument("--bn", choices=("global", "local"), default="global")
    args = p.parse_args(argv)

    import torch

    from qnx_torch.parallel.launch import run_rank

    if args.device == "cpu":
        torch.set_num_threads(1)
    payload = {"bn": args.bn}
    if args.variables:
        payload.update(load_variables(args.variables))
    result = run_rank(args.init, args.rank, args.world, args.mp, args.device,
                      args.backend, "bringup", payload)
    print("BRINGUP " + json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
