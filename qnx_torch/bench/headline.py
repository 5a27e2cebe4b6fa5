"""The headline bench on one card (torch port of the repo-root ``bench.py``):
CIFAR-10 VGG BNN inference through the int8 engine, the engine of record,
against the same architecture's strict-f32 float twin.

    python -m qnx_torch bench [headline] [--full] [--batch N] [--width W] \\
        [--iters N] [--repeats N] [--device cuda|cpu]

The model is ``CIFAR10_BNN`` at ``--width`` with random variables from
``init_variables(cf, 0)``, the float twin's from ``init_variables(cf_float,
0)``; the images are uniform in [-1, 1) from a generator seeded 1.  The
default run times two targets in one interleaved group
(:func:`qnx_torch.bench.microbench.time_fns_marginal_interleaved`): ``int8``
(``pack_int8``: kernel E on the five hidden convs, ``torch._int_mm`` on the
dense layers) and ``f32-strict`` (``float_forward`` with TF32 off for cuBLAS
and cuDNN, the counterpart of ``jax.default_matmul_precision("highest")``).
``--full`` adds the TF32-allowed twin ``tf32`` (the counterpart of XLA's
default precision) and ``popcount`` (``pack_vgg``: kernel A's convs and dense
layers) to the same group, so every ratio is same-pass.

The first line of stdout is one JSON record, flushed before anything else
is printed, with ``bench.py``'s keys (``metric``, ``value``, ``unit``,
``vs_baseline``, ``ms_per_batch``, ``ms_median``, ``spread``,
``baseline_f32_ips``, ``baseline_spread``, ``repeats``, and ``unreliable``
only where a marginal estimate was clamped); ``metric`` names the card and
its power limit.  Detail goes to stderr.  Runs on the card by default;
``device="cpu"`` is for the tests (no CPU number is a device time).
"""
from __future__ import annotations

import argparse
import json
import sys

from qnx_torch.bench import suite
from qnx_torch.bench.microbench import device_label, resolve_device
from qnx_torch.utils.config import CIFAR10_BNN


#: the timed targets, ``bench.py:82-85``; ``--full`` adds its ``:81-91``
TIMED = ("f32-strict", "int8")
FULL = (*TIMED, "tf32", "popcount")
#: the record's keys in its order, ``bench.py:97-109``; ``unreliable``
#: (``:110-111``) joins them only where set
RECORD_KEYS = ("metric", "value", "unit", "vs_baseline", "ms_per_batch",
               "ms_median", "spread", "baseline_f32_ips", "baseline_spread",
               "repeats")


def inputs(batch=1024, width=128, device="cuda") -> tuple:
    """``(cf, variables, images)`` of the headline: ``CIFAR10_BNN`` at
    ``width``, its variables from seed 0 and a batch of images from
    ``suite._images``."""
    from qnx_torch.models.factory import init_variables

    cf = CIFAR10_BNN.replace(width=width)
    return cf, init_variables(cf, 0), suite._images((batch, *cf.input_shape), device)


def headline_targets(variables: dict, cf, images, full=False, vars_f=None) -> dict:
    """``{name: (fn, args)}`` of the headline's targets on ``images``'s
    device (:data:`TIMED`, or :data:`FULL` with ``full``), through
    :func:`qnx_torch.bench.suite.targets`; ``vars_f`` the float twin's
    variables, by default from seed 0."""
    return suite.targets(variables, cf, images, FULL if full else TIMED, vars_f)


def _report(name, r, batch, ips_f32):
    t = r["t"]
    print(f"# {name}: {t*1e3:.2f} ms/batch (median {r['median']*1e3:.2f} ms, "
          f"spread {r['spread']*100:.0f}%) -> {batch/t:,.0f} img/s"
          + (f", {batch/t/ips_f32:.2f}x f32" if ips_f32 else ""),
          file=sys.stderr)


def main(batch=1024, width=128, iters=32, repeats=5, full=False, device="cuda"):
    """Time the headline's targets and print its record; returns ``(img/s of
    int8, its ratio to the strict-f32 twin)``."""
    device = resolve_device(device)
    card = device_label(device)
    cf, variables, images = inputs(batch, width, device)
    head = suite._timed(headline_targets(variables, cf, images, full), iters,
                        repeats, device)
    t_f32, t_i8 = head["f32-strict"]["t"], head["int8"]["t"]
    ips_f32, ips = batch / t_f32, batch / t_i8
    record = dict(zip(RECORD_KEYS, (
        "images/s/card CIFAR-10 VGG BNN (int8 engine: kernel E, torch._int_mm) "
        f"vs float32 strict (TF32 off) torch baseline on {card}",
        round(ips, 1),
        "images/s",
        round(ips / ips_f32, 3),
        round(t_i8 * 1e3, 3),
        round(head["int8"]["median"] * 1e3, 3),
        round(head["int8"]["spread"], 3),
        round(ips_f32, 1),
        round(head["f32-strict"]["spread"], 3),
        repeats,
    )))
    if head["int8"]["unreliable"] or head["f32-strict"]["unreliable"]:
        record["unreliable"] = True  # a clamped non-positive marginal estimate
    print(json.dumps(record), flush=True)
    _report("int8", head["int8"], batch, ips_f32)
    _report("float32 strict (TF32 off) baseline", head["f32-strict"], batch, None)
    if full:
        for name in ("tf32", "popcount"):
            _report(f"[detail] {name}", head[name], batch, ips_f32)
        print(f"# [detail] int8 vs TF32 baseline: "
              f"{head['tf32']['t'] / head['int8']['t']:.2f}x", file=sys.stderr)
    return ips, ips / ips_f32


def parse_and_run(argv=None):
    """Entry of ``python -m qnx_torch bench [headline]``: every flag reaches
    :func:`main`."""
    p = argparse.ArgumentParser(prog="qnx_torch bench headline",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--full", action="store_true",
                   help="also time the popcount engine and the TF32 twin")
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--iters", type=int, default=32)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = p.parse_args(argv)
    return main(batch=a.batch, width=a.width, iters=a.iters, repeats=a.repeats,
                full=a.full, device=a.device)


if __name__ == "__main__":
    parse_and_run()
