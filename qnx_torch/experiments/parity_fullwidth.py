"""Full-width parity run on one card (torch port of
``experiments/parity_fullwidth.py``).

Runs the shipped CIFAR-10 config shapes (width-128 VGG, 8192 -> 1024 dense)
end to end:

  short fake-quant training (synthetic CIFAR twin, the port's train_step)
    -> golden argmax of the fake-quant model in eval mode
    -> pack_vgg (kernel A; full-bnn) or pack_vgg_bitplane (kernel D;
       full-tnn)                                     argmax parity
    -> pack_int8 (kernel E and torch._int_mm)        argmax parity
    -> write_legacy_h5 -> variables_from_keras_h5 -> the engines again
       (the reference-format checkpoint round trip at full size)

Prints one JSON line per engine and weight source with the argmax match
fraction (each must be 1.0), and ``# PARITY OK`` or ``# PARITY FAILED`` on
stderr; exits 1 unless every match is 1.0.  Where h5py does not import, the
round trip is not run: no ``legacy-h5`` line is printed, and one stderr
line says so.

    python -m qnx_torch.experiments.parity_fullwidth [--batch 256] \\
        [--steps 8] [--network-type full-bnn|full-tnn] [--width W] \\
        [--dense-units U] [--device cuda|cpu]

Runs on the card by default; ``--device cpu`` is for the tests.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from qnx_torch.bench.microbench import device_label, resolve_device
from qnx_torch.utils.config import CIFAR10_BNN, CIFAR10_TNN

STEP_BATCH = 64  # the training steps' batch, as the JAX script's


def _legacy_layers(variables):
    """Serialize full-width VGG variables in the reference's legacy h5
    shape (model order: compute layer then its BN)."""
    p, s = variables["params"], variables["batch_stats"]
    compute = [f"conv_{i}" for i in range(6)] + ["dense_0", "dense_1",
                                                 "dense_out"]
    bns = [f"bn_conv_{i}" for i in range(6)] + ["bn_dense_0", "bn_dense_1",
                                                "bn_out"]
    out = []
    for cn, bn in zip(compute, bns):
        ws = [(f"{cn}/kernel:0", np.asarray(p[cn]["kernel"]))]
        if "bias" in p[cn]:
            ws.append((f"{cn}/bias:0", np.asarray(p[cn]["bias"])))
        out.append((cn, ws))
        out.append((bn, [(f"{bn}/gamma:0", np.asarray(p[bn]["scale"])),
                         (f"{bn}/beta:0", np.asarray(p[bn]["bias"])),
                         (f"{bn}/moving_mean:0", np.asarray(s[bn]["mean"])),
                         (f"{bn}/moving_variance:0", np.asarray(s[bn]["var"]))]))
    return out


def _legacy_h5_round_trip(variables, cf):
    """The variables written in the reference's legacy layout and read
    back, or None where h5py does not import."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        return None
    from qnx_torch.convert.keras_h5 import variables_from_keras_h5, write_legacy_h5

    with tempfile.TemporaryDirectory(prefix="qnx_torch_parity_") as tmp:
        path = os.path.join(tmp, "fullwidth.h5")
        write_legacy_h5(path, _legacy_layers(variables))
        return variables_from_keras_h5(path, cf)


def main(argv=None):
    from qnx_torch.convert.pack_model import pack_int8, pack_vgg, pack_vgg_bitplane
    from qnx_torch.data.datasets import synthetic
    from qnx_torch.models.factory import export_variables
    from qnx_torch.nn.inference import vgg_forward
    from qnx_torch.nn.int8_engine import i8_forward
    from qnx_torch.train.loop import NOISE, create_train_state, epoch_generator, train_step

    ap = argparse.ArgumentParser(prog="qnx_torch.experiments.parity_fullwidth")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--network-type", default="full-bnn",
                    choices=["full-bnn", "full-tnn"])
    ap.add_argument("--width", type=int, default=None,
                    help="override VGG width (CPU smoke runs)")
    ap.add_argument("--dense-units", type=int, default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    card = device_label(device)
    cf = (CIFAR10_BNN if args.network_type == "full-bnn" else CIFAR10_TNN)
    cf = cf.replace(dataset="synthetic-cifar", batch_size=STEP_BATCH)
    if args.width:
        cf = cf.replace(width=args.width)
    if args.dense_units:
        cf = cf.replace(dense_units=args.dense_units)
    print(f"# device={card} config width={cf.width} dense={cf.dense_units} "
          f"type={cf.network_type}", file=sys.stderr)

    ds = synthetic((32, 32, 3), n_train=STEP_BATCH * args.steps, n_test=args.batch)
    state = create_train_state(cf, 0, steps_per_epoch=args.steps, device=device)
    xtr = torch.from_numpy(ds.x_train).to(device)
    ytr = torch.from_numpy(ds.y_train).long().to(device)
    noise = epoch_generator(cf.seed, 0, NOISE, device)
    for i in range(args.steps):
        batch = slice(i * STEP_BATCH, (i + 1) * STEP_BATCH)
        state, m = train_step(state, xtr[batch], ytr[batch], noise)
    print(f"# trained {args.steps} steps, last loss={float(m['loss']):.4f}",
          file=sys.stderr)

    variables = export_variables(state.module)
    x = torch.from_numpy(ds.x_test).to(device)
    with torch.no_grad():
        gold = state.module(x, train=False).argmax(-1).cpu().numpy()

    engines = {}
    if cf.network_type == "full-bnn":
        engines["popcount(pack_vgg)"] = lambda v: vgg_forward(
            pack_vgg(v, cf, device=device), x)
    else:
        engines["bitplane(pack_vgg_bitplane)"] = lambda v: vgg_forward(
            pack_vgg_bitplane(v, cf, device=device), x)
    engines["int8(pack_int8)"] = lambda v: i8_forward(
        pack_int8(v, cf, device=device), x)

    sources = {"native": variables}
    variables_h5 = _legacy_h5_round_trip(variables, cf)
    if variables_h5 is None:
        print("# legacy-h5: h5py is not installed, so the reference-format "
              "round trip was not run", file=sys.stderr)
    else:
        sources["legacy-h5"] = variables_h5

    ok = True
    for name, fn in engines.items():
        for src, v in sources.items():
            pred = fn(v).argmax(-1).cpu().numpy()
            match = float(np.mean(pred == gold))
            ok &= match == 1.0
            print(json.dumps({
                "artifact": "fullwidth-parity", "engine": name,
                "weights_source": src, "network_type": cf.network_type,
                "width": cf.width, "batch": args.batch,
                "argmax_match_vs_fakequant": match, "device": card}), flush=True)
    print(f"# PARITY {'OK' if ok else 'FAILED'} at width={cf.width} "
          f"batch={args.batch} on {card}", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
