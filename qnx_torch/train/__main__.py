"""Training CLI (torch port of :mod:`qnx.train.__main__`), the reference's
``python Train.py``:

    python -m qnx_torch.train --config mnist-bnn [--device cuda|cpu]
    python -m qnx_torch train --dataset CIFAR-10 --architecture vgg \\
        --network-type full-bnn --epochs 50 --batch-size 100

Trains the fake-quant model on the card (``--device cpu`` for the CPU),
reports the test accuracy per epoch, writes the training checkpoint
``OUT/train_state``, the weights checkpoint ``OUT/ckpt`` and a JSONL
metrics log ``OUT/metrics.jsonl``, and with ``--convert`` an inference
artifact ``OUT/model.ENGINE.pt`` through the same route as ``python -m
qnx_torch convert --ckpt``, which ``serve`` loads.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time


def build_argparser() -> argparse.ArgumentParser:
    from qnx_torch.utils.config import CONFIGS, NETWORK_TYPES

    p = argparse.ArgumentParser(prog="qnx_torch.train", description=__doc__)
    p.add_argument("--config", choices=sorted(CONFIGS), default=None,
                   help="preset config (BASELINE.json entries)")
    p.add_argument("--dataset", default=None)
    p.add_argument("--architecture", choices=["mlp", "vgg"], default=None)
    p.add_argument("--network-type", choices=NETWORK_TYPES, default=None)
    for name in ("wbits", "abits", "dim", "num-hidden", "width",
                 "dense-units", "epochs", "batch-size", "seed"):
        p.add_argument(f"--{name}", type=int, default=None)
    for name in ("lr-start", "lr-end", "dropout-rate"):
        p.add_argument(f"--{name}", type=float, default=None)
    for name in ("stochastic", "first-layer-float", "last-layer-float",
                 "use-bias"):
        p.add_argument(f"--{name}", action="store_const", const=True,
                       default=None)
    p.add_argument("--loss", choices=["squared_hinge", "crossentropy"],
                   default=None)
    p.add_argument("--activation", default=None,
                   choices=["binary_tanh", "binary_sigmoid", "quantized_relu",
                            "quantized_tanh", "relu"],
                   help="override the network_type-derived activation")
    p.add_argument("--h", default=None, help="weight scale H: float or 'Glorot'")
    p.add_argument("--out", default="runs/latest",
                   help="output dir (checkpoints + metrics)")
    p.add_argument("--ckpt-every", type=int, default=1,
                   help="checkpoint the train state every N epochs "
                        "(always after the final epoch)")
    p.add_argument("--resume", action="store_true",
                   help="resume from --out's train-state checkpoint (exact: "
                        "restores Adam moments and step, and re-derives the "
                        "epochs' generators)")
    p.add_argument("--convert", choices=["none", "packed", "int8"],
                   default="none", help="also emit an inference artifact")
    p.add_argument("--log-every", type=int, default=1)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def config_from_args(args):
    from qnx_torch.utils.config import CONFIGS, Config

    cf = CONFIGS[args.config] if args.config else Config()
    overrides = {}
    for field in dataclasses.fields(cf):
        arg = getattr(args, field.name.replace("-", "_"), None)
        if arg is not None and field.name not in ("H",):
            overrides[field.name] = arg
    if args.h is not None:
        overrides["H"] = args.h if args.h == "Glorot" else float(args.h)
    return cf.replace(**overrides)


def main(argv=None):
    args = build_argparser().parse_args(argv)
    cf = config_from_args(args)

    from qnx_torch.convert.pack_model import _check_device
    from qnx_torch.data.datasets import load_dataset
    from qnx_torch.models.factory import export_variables
    from qnx_torch.train.checkpoint import save_checkpoint
    from qnx_torch.train.loop import fit
    from qnx_torch.utils.metrics import MetricsLogger

    device = _check_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    logger = MetricsLogger(os.path.join(args.out, "metrics.jsonl"))
    try:
        ds = load_dataset(cf.dataset)
        print(f"config: {cf}")
        print(f"dataset: {ds.meta} train={ds.x_train.shape} test={ds.x_test.shape}")
        logger.log(event="start", config=dataclasses.asdict(cf), data=ds.meta,
                   resume=args.resume, device=str(device))

        t0 = time.time()
        state, history = fit(cf, ds.as_tuples(), log_every=args.log_every,
                             ckpt_dir=args.out, resume=args.resume,
                             ckpt_every=args.ckpt_every, device=device)
        elapsed = time.time() - t0
        if not history:  # --resume of a run that already has cf.epochs
            print(f"nothing to do: checkpoint already has {cf.epochs} "
                  f"epochs trained; raise --epochs to extend the run")
            logger.log(event="done", seconds=elapsed, note="already-complete")
        else:
            final = history[-1]["test"]
            print(f"done in {elapsed:.1f}s: test accuracy {final['accuracy']:.4f}")
            for h in history:
                logger.log(event="epoch", epoch=h["epoch"],
                           test_accuracy=h["test"]["accuracy"],
                           test_loss=h["test"]["loss"],
                           train_losses=h["train"]["losses"])
            logger.log(event="done", seconds=elapsed, step=state.step, **final)
    finally:
        logger.close()

    variables = export_variables(state.module)
    ckpt_path = save_checkpoint(os.path.join(args.out, "ckpt"), variables, cf)
    print(f"checkpoint: {ckpt_path}")

    if args.convert != "none":
        from qnx_torch.__main__ import _pack_for_engine, save_artifact

        model = _pack_for_engine(variables, cf, args.convert, device)
        out = os.path.join(args.out, f"model.{args.convert}.pt")
        save_artifact(out, model, cf, args.convert)
        print(f"inference artifact: {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
