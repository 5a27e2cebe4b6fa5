"""qnx_torch CLI, the port of :mod:`qnx.__main__`:

    python -m qnx_torch convert --h5 weights.h5 --config cifar10-bnn \\
        --engine int8|packed --out model.pt [--device cuda|cpu]
    python -m qnx_torch serve   --model model.pt [--batch-size 256] \\
        [--requests 2048] [--input-shape 32,32,3] [--device cuda|cpu]
    python -m qnx_torch bench roofline [--device cuda|cpu]

Every command runs on the CUDA card unless ``--device cpu`` is given, and
raises when the card is asked for and missing.  ``train``, ``eval`` and
``convert --ckpt`` load a training checkpoint and come with fake-quant
training (ROADMAP.md §1 item 12); ``bench suite``, ``bench scaling`` and
the headline bench wait for items 15 and 6.
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
                   help="training checkpoint dir (not ported yet)")
    p.add_argument("--config", required=True,
                   help="preset name (see qnx_torch.utils.config.CONFIGS)")
    p.add_argument("--engine", choices=["int8", "packed"], default="int8")
    p.add_argument("--out", required=True)
    p.add_argument("--device", choices=_DEVICES, default="cuda")
    args = p.parse_args(argv)

    from qnx_torch.utils.config import CONFIGS

    cf = CONFIGS[args.config]
    if args.ckpt:
        raise SystemExit("convert --ckpt loads a training checkpoint, which "
                         "comes with fake-quant training (ROADMAP.md §1 item "
                         "12); use --h5")
    if not args.h5:
        p.error("--h5 is required")
    from qnx_torch.convert.keras_h5 import variables_from_keras_h5
    from qnx_torch.convert.pack_model import _check_device

    device = _check_device(args.device)
    variables = variables_from_keras_h5(args.h5, cf)
    model = _pack_for_engine(variables, cf, args.engine, device)
    save_artifact(args.out, model, cf, args.engine)
    print(f"wrote {args.engine} artifact: {args.out}")
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
    if which != "roofline":
        raise SystemExit(
            f"bench {which}: not ported yet (the suite and scaling are "
            f"ROADMAP.md §1 item 15, the headline bench item 6); "
            f"bench roofline is")
    p = argparse.ArgumentParser(prog="qnx_torch bench roofline")
    p.add_argument("--device", choices=_DEVICES, default="cuda")
    args = p.parse_args(argv[1:])
    from qnx_torch.bench.roofline import main

    main(device=args.device)
    return 0


COMMANDS = {
    "convert": _cmd_convert,
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
        raise SystemExit(f"unknown command: {cmd}" + (
            " (train and eval come with fake-quant training, ROADMAP.md §1 "
            "item 12)" if cmd in ("train", "eval") else ""))
    return COMMANDS[cmd](rest)


if __name__ == "__main__":
    raise SystemExit(main())
