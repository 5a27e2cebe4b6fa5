"""qnx_torch CLI, the port of :mod:`qnx.__main__`:

    python -m qnx_torch train   --config cifar10-bnn ... [--device cuda|cpu]
    python -m qnx_torch eval    --ckpt runs/latest/ckpt \\
        [--engine int8|packed|fake] [--dataset NAME] [--device cuda|cpu]
    python -m qnx_torch convert --ckpt runs/latest/ckpt \\
        --engine int8|packed --out model.pt [--device cuda|cpu]
    python -m qnx_torch convert --h5 weights.h5 --config cifar10-bnn \\
        --engine int8|packed --out model.pt [--device cuda|cpu]
    python -m qnx_torch serve   --model model.pt [--batch-size 256] \\
        [--requests 2048] [--input-shape 32,32,3] [--device cuda|cpu]
    python -m qnx_torch bench [headline] [--full] [--batch N] [--width W] \\
        [--iters N] [--repeats N] [--device cuda|cpu]
    python -m qnx_torch bench roofline [--device cuda|cpu]
    python -m qnx_torch bench suite    [--device cuda|cpu]
    python -m qnx_torch bench scaling  [--device cuda|cpu] [--backend gloo|nccl]

Every command runs on the CUDA card unless ``--device cpu`` is given, and
raises when the card is asked for and missing.  ``train`` is
``python -m qnx_torch.train`` (fake-quant training; the checkpoint
``OUT/ckpt`` is what ``eval`` and ``convert --ckpt`` read).  ``bench
scaling`` starts its worlds of ranks as processes of their own
(:mod:`qnx_torch.parallel.launch`).  ``bench`` with no subcommand, with
``headline`` or with flags alone is the headline bench
(:mod:`qnx_torch.bench.headline`, the port of ``bench.py``): one JSON
record on its first stdout line, the int8 engine against the strict-f32
float twin.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

#: What ``convert`` writes: a ``torch.save`` of a dict with these keys and
#: the packed module under ``"model"``.
ARTIFACT_FORMAT = "qnx_torch.packed_model"
ARTIFACT_VERSION = 1

_DEVICES = ("cuda", "cpu")


def _cmd_train(argv):
    from qnx_torch.train.__main__ import main

    return main(argv)


def _pack_for_engine(variables, cf, engine, device="cuda"):
    """Lower trained variables into the requested engine artifact on
    ``device``.

    ``packed`` resolves per config: MLP -> bit-packed popcount MLP; VGG with
    abits=1 -> packed popcount VGG; VGG with abits>1 (e.g. cifar10-tnn) ->
    the bit-plane engine."""
    from qnx_torch.convert.pack_model import (pack_int8, pack_mlp, pack_vgg,
                                              pack_vgg_bitplane)

    if engine == "int8":
        return pack_int8(variables, cf, device=device)
    if cf.architecture == "mlp":
        return pack_mlp(variables, cf, device=device)
    if cf.abits > 1:
        return pack_vgg_bitplane(variables, cf, device=device)
    return pack_vgg(variables, cf, device=device)


def _engine_forward(model):
    """``forward(model, x)`` for :class:`~qnx_torch.serve.ServeEngine`: the
    module's own forward under ``torch.inference_mode()``, for the packed,
    bit-plane and int8 engines' models (the relu network types' int8
    models are ``I8MLP`` / ``I8VGG`` too)."""
    import torch

    from qnx_torch.nn import int8_engine
    from qnx_torch.nn.inference import PackedMLP, PackedVGG, PlaneVGG

    if not isinstance(model, (PackedMLP, PackedVGG, PlaneVGG,
                              int8_engine.I8MLP, int8_engine.I8VGG)):
        raise SystemExit(f"unknown model artifact type: {type(model)}")

    def forward(m, x):
        with torch.inference_mode():
            return m(x)

    return forward


def save_artifact(path: str, model, cf, engine: str) -> None:
    """Write a packed model as ``convert`` does."""
    import torch

    torch.save({"format": ARTIFACT_FORMAT, "version": ARTIFACT_VERSION,
                "engine": engine, "config": dataclasses.asdict(cf),
                "model": model}, path)


def load_artifact(path: str, device="cuda") -> dict:
    """Read an artifact of ``convert`` with its tensors on ``device``.

    An artifact is trusted code: it is a pickle of the packed module, read
    with ``weights_only=False``, which can run anything the file holds, as
    the JAX CLI's pickle can.  Load only artifacts you wrote."""
    import torch

    art = torch.load(path, map_location=device, weights_only=False)
    if not isinstance(art, dict) or art.get("format") != ARTIFACT_FORMAT:
        raise SystemExit(f"{path}: not a {ARTIFACT_FORMAT} artifact")
    if art.get("version") != ARTIFACT_VERSION:
        raise SystemExit(f"{path}: artifact version {art.get('version')}, "
                         f"this build reads {ARTIFACT_VERSION}")
    return art


def _cmd_convert(argv):
    p = argparse.ArgumentParser(prog="qnx_torch convert", description=(
        "Reference Keras HDF5 checkpoint -> packed inference artifact "
        "(h5py reader, re-quantize latent weights, fold BN, bit-pack)"))
    p.add_argument("--h5", required=False, help="Keras .h5 weight file")
    p.add_argument("--ckpt", required=False,
                   help="weights checkpoint of train (OUT/ckpt); its "
                        "sidecar gives the config")
    p.add_argument("--config", required=False,
                   help="preset name (see qnx_torch.utils.config.CONFIGS); "
                        "required with --h5")
    p.add_argument("--engine", choices=["int8", "packed"], default="int8")
    p.add_argument("--out", required=True)
    p.add_argument("--device", choices=_DEVICES, default="cuda")
    args = p.parse_args(argv)

    from qnx_torch.convert.pack_model import _check_device
    from qnx_torch.utils.config import CONFIGS

    if bool(args.h5) == bool(args.ckpt):
        p.error("one of --h5 / --ckpt is required")
    if args.h5 and not args.config:
        p.error("--h5 needs --config")
    device = _check_device(args.device)
    if args.h5:
        from qnx_torch.convert.keras_h5 import variables_from_keras_h5

        cf = CONFIGS[args.config]
        variables = variables_from_keras_h5(args.h5, cf)
    else:
        from qnx_torch.train.checkpoint import load_checkpoint

        variables, cf = load_checkpoint(args.ckpt)
    model = _pack_for_engine(variables, cf, args.engine, device)
    save_artifact(args.out, model, cf, args.engine)
    print(f"wrote {args.engine} artifact: {args.out}")
    return 0


def _cmd_eval(argv):
    p = argparse.ArgumentParser(prog="qnx_torch eval", description=(
        "test accuracy of a training checkpoint: the fake-quant model, or "
        "the int8 or packed engine's model converted from it"))
    p.add_argument("--ckpt", required=True)
    p.add_argument("--engine", choices=["fake", "int8", "packed"],
                   default="int8")
    p.add_argument("--dataset", default=None, help="override cf.dataset")
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--device", choices=_DEVICES, default="cuda")
    args = p.parse_args(argv)

    import torch

    from qnx_torch.convert.pack_model import _check_device
    from qnx_torch.data.datasets import load_dataset
    from qnx_torch.train.checkpoint import load_checkpoint

    device = _check_device(args.device)
    variables, cf = load_checkpoint(args.ckpt)
    if args.dataset:
        cf = cf.replace(dataset=args.dataset)
    ds = load_dataset(cf.dataset)
    x, y = ds.x_test, ds.y_test

    if args.engine == "fake":
        from qnx_torch.models.factory import build_model, load_variables

        model = load_variables(build_model(cf), variables).to(device)
        fwd = lambda m, xb: m(xb, train=False)
    else:
        model = _pack_for_engine(variables, cf, args.engine, device)
        fwd = _engine_forward(model)
    correct = 0
    with torch.inference_mode():
        for i in range(0, len(x), args.batch_size):
            xb = torch.from_numpy(x[i:i + args.batch_size]).to(device)
            pred = fwd(model, xb).argmax(-1).cpu().numpy()
            correct += int((pred == y[i:i + args.batch_size]).sum())
    acc = correct / len(x)
    print(f"{cf.dataset} test accuracy [{args.engine}]: {acc:.4f} "
          f"({correct}/{len(x)})")
    return 0


def _cmd_serve(argv):
    p = argparse.ArgumentParser(prog="qnx_torch serve", description=(
        "continuous-batching serving demo: feeds random requests through "
        "the engine and prints throughput/latency stats and the kernel "
        "launches made while serving"))
    p.add_argument("--model", required=True, help="artifact from convert")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--requests", type=int, default=2048)
    p.add_argument("--input-shape", default="32,32,3")
    p.add_argument("--device", choices=_DEVICES, default="cuda")
    args = p.parse_args(argv)

    import json

    import numpy as np

    from qnx_torch.convert.pack_model import _check_device
    from qnx_torch.kernels import launch_counters
    from qnx_torch.serve.engine import ServeEngine

    model = load_artifact(args.model, _check_device(args.device))["model"]
    shape = tuple(int(s) for s in args.input_shape.split(","))
    rng = np.random.RandomState(0)
    reqs = rng.randint(0, 256, (args.requests, *shape), np.uint8)
    counters = launch_counters()
    for w in counters.values():
        w.launches = 0
    with ServeEngine(model, batch_size=args.batch_size,
                     forward=_engine_forward(model)) as eng:
        eng.predict(reqs)
        stats = eng.stats()
    stats["launches"] = {name: w.launches for name, w in counters.items()
                         if w.launches}
    print(json.dumps(stats, indent=1))
    return 0


def _cmd_bench(argv):
    which = argv[0] if argv else "headline"
    if which not in ("roofline", "suite", "scaling"):
        from qnx_torch.bench.headline import parse_and_run

        parse_and_run(argv[1:] if which == "headline" else argv)
        return 0
    p = argparse.ArgumentParser(prog=f"qnx_torch bench {which}")
    p.add_argument("--device", choices=_DEVICES, default="cuda")
    if which == "scaling":
        p.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    args = p.parse_args(argv[1:])
    if which == "roofline":
        from qnx_torch.bench.roofline import main

        main(device=args.device)
    elif which == "suite":
        from qnx_torch.bench.microbench import resolve_device
        from qnx_torch.bench.suite import main

        resolve_device(args.device)
        main(device=args.device)
    else:
        from qnx_torch.bench.microbench import resolve_device
        from qnx_torch.bench.scaling import main

        resolve_device(args.device)
        main(device=args.device, backend=args.backend)
    return 0


COMMANDS = {
    "train": _cmd_train,
    "convert": _cmd_convert,
    "eval": _cmd_eval,
    "serve": _cmd_serve,
    "bench": _cmd_bench,
}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd not in COMMANDS:
        print(__doc__)
        raise SystemExit(f"unknown command: {cmd}")
    return COMMANDS[cmd](rest)


if __name__ == "__main__":
    raise SystemExit(main())
