"""Per-config benchmark suite on one card (torch port of
:mod:`qnx.bench.suite`): the MNIST MLP BNN/TNN, the CIFAR VGG BNN/TNN and
the continuous-batching serving path, each engine against its own float
twins.

Each config's engines and its two float twins are timed in ONE interleaved
group (:func:`qnx_torch.bench.microbench.time_fns_marginal_interleaved`),
so every ratio is same-pass; rows carry ``spread`` so numbers are quoted as
bands, and the card's name and power limit.  The twins are the float
forward with TF32 off (``f32-strict``, the counterpart of the JAX suite's
``f32-highest``) and with TF32 allowed for cuBLAS and cuDNN (``tf32``, the
counterpart of XLA's default precision).  Variables are
``init_variables(cf, 0)`` (:mod:`qnx_torch.models.factory`), images
uniform in [-1, 1) from a seeded generator.

    python -m qnx_torch bench suite [--device cuda|cpu]

Runs on the card by default; ``device="cpu"`` is for the tests (no CPU
number is a device time).
"""
from __future__ import annotations

import contextlib
import json
import sys
import time

import numpy as np
import torch

from qnx_torch.bench.microbench import (device_label, resolve_device,
                                        time_fns_marginal_interleaved)
from qnx_torch.utils.config import CIFAR10_BNN, CIFAR10_TNN, MNIST_BNN, MNIST_TNN


@contextlib.contextmanager
def tf32_allowed():
    """TF32 on for cuBLAS and cuDNN inside, the caller's flags restored."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def _images(shape, device) -> torch.Tensor:
    g = torch.Generator().manual_seed(1)
    return (torch.rand(shape, generator=g) * 2 - 1).to(device)


def float_twins(cf, images, vars_f=None):
    """The two float twins of ``cf``'s architecture as interleavable
    targets, the precision set inside each call; ``vars_f`` are the float
    variables, by default ``init_variables(cf_float, 0)``."""
    from qnx_torch.bench.float_baseline import (float_forward, float_variables,
                                                strict_f32)
    from qnx_torch.models.factory import init_variables

    cf_f = cf.replace(network_type="float")
    v = float_variables(init_variables(cf_f, 0) if vars_f is None else vars_f,
                        images.device)

    def f32_strict(x, v):
        with strict_f32():
            return float_forward(v, cf_f, x)

    def tf32(x, v):
        with tf32_allowed():
            return float_forward(v, cf_f, x)

    return {"f32-strict": (f32_strict, (images, v)), "tf32": (tf32, (images, v))}


def targets(variables: dict, cf, images, names, vars_f=None) -> dict:
    """``{name: (fn, args)}`` on ``images``'s device, in the order of
    ``names``: the float twins ``f32-strict`` and ``tf32``
    (:func:`float_twins`) and the engines ``int8`` (``pack_int8``),
    ``popcount`` (``pack_vgg``, or ``pack_mlp`` for an MLP) and
    ``bitplane`` (``pack_vgg_bitplane``), each called as a module;
    ``fn(*args)`` returns the logits."""
    from qnx_torch.convert.pack_model import (pack_int8, pack_mlp, pack_vgg,
                                              pack_vgg_bitplane)

    packers = {"int8": pack_int8,
               "popcount": pack_mlp if cf.architecture == "mlp" else pack_vgg,
               "bitplane": pack_vgg_bitplane}
    twins = (float_twins(cf, images, vars_f)
             if {"f32-strict", "tf32"} & set(names) else {})
    return {name: twins[name] if name in twins else
            (lambda x, m: m(x),
             (images, packers[name](variables, cf, device=images.device)))
            for name in names}


def _rows(res, name, batch, engines, card: str):
    t_f32 = res["f32-strict"]["t"]
    t_tf32 = res["tf32"]["t"]
    rows = []
    for eng in engines:
        r = res[eng]
        row = {
            "config": f"{name} {eng}",
            "batch": batch,
            "ms_per_batch": r["t"] * 1e3,
            "ms_median": r["median"] * 1e3,
            "spread": r["spread"],
            "images_per_s": batch / r["t"],
            "vs_f32_strict": t_f32 / r["t"],
            "vs_tf32": t_tf32 / r["t"],
            "device": card,
        }
        if r.get("unreliable"):
            row["unreliable"] = True
        rows.append(row)
    return rows


def _timed(targets, iters, repeats, device):
    with torch.inference_mode():
        return time_fns_marginal_interleaved(targets, iters=iters,
                                             repeats=repeats, device=device)


def bench_mlp(cf, name, batch=4096, iters=32, repeats=5, device="cuda"):
    return bench(cf, name, ("int8", "popcount"), batch, iters, repeats, device)


def bench_vgg(cf, name, batch=1024, bitplane=False, iters=32, repeats=5,
              device="cuda"):
    engines = ("int8", "bitplane" if bitplane else "popcount")
    return bench(cf, name, engines, batch, iters, repeats, device)


def bench(cf, name, engines, batch, iters, repeats, device):
    """``engines`` and ``cf``'s two float twins in one interleaved group at
    ``batch``: a row an engine."""
    from qnx_torch.models.factory import init_variables

    device = resolve_device(device)
    images = _images((batch, *cf.input_shape), device)
    res = _timed(targets(init_variables(cf, 0), cf, images,
                         ("f32-strict", "tf32", *engines)),
                 iters, repeats, device)
    return _rows(res, name, batch, engines, device_label(device))


def h2d_mbps(blob: np.ndarray, device, repeats: int = 5) -> dict:
    """MB/s of a host-to-device copy of ``blob``, from pageable and from
    pinned host memory (CUDA events around ``repeats`` copies); None on the
    CPU, which has no such copy."""
    device = resolve_device(device)
    if device.type != "cuda":
        return {"pageable": None, "pinned": None}
    out = {}
    src = torch.from_numpy(blob)
    dst = torch.empty_like(src, device=device)
    for kind, host in (("pageable", src), ("pinned", src.pin_memory())):
        dst.copy_(host)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(repeats):
            dst.copy_(host, non_blocking=kind == "pinned")
        end.record()
        end.synchronize()
        out[kind] = blob.nbytes * repeats / (start.elapsed_time(end) / 1e3) / 1e6
    return out


def bench_serving(cf=CIFAR10_BNN, batch=1024, requests=8192, device="cuda"):
    """Request-level continuous batching (uint8 ingest, futures, padding)
    of the int8 engine: reported apart from the raw engine rate because it
    includes the host's request plane and the host-to-device copy, whose
    rate is measured on the uint8 batch (``h2d_mbps_*``)."""
    from qnx_torch.convert.pack_model import pack_int8
    from qnx_torch.models.factory import init_variables
    from qnx_torch.serve.engine import ServeEngine, normalize_u8

    device = resolve_device(device)
    model = pack_int8(init_variables(cf, 0), cf, device=device)
    reqs = np.random.RandomState(0).randint(0, 256, (requests, *cf.input_shape),
                                            np.uint8)
    with torch.inference_mode():  # warm: the kernels' first launch
        model(normalize_u8(torch.from_numpy(reqs[:batch]).to(device)))
    t0 = time.perf_counter()
    with ServeEngine(model, batch_size=batch, max_queue=None) as eng:
        eng.predict(reqs)
        stats = eng.stats()
    wall = time.perf_counter() - t0
    h2d = h2d_mbps(reqs[:batch], device)
    return {
        "config": f"{cf.dataset.lower()}-{cf.network_type} serve (int8, "
                  "request-level, uint8 ingest)",
        "requests": requests,
        "batch": batch,
        "throughput_ips": stats["throughput_ips"],
        "wall_throughput_ips": stats["wall_throughput_ips"],
        "latency_ms_p50": stats["latency_ms_p50"],
        "latency_ms_p99": stats["latency_ms_p99"],
        "pad_fraction": stats["pad_fraction"],
        "seconds": wall,
        "h2d_mbps_pageable": h2d["pageable"],
        "h2d_mbps_pinned": h2d["pinned"],
        "device": device_label(device),
    }


def main(argv=None, device="cuda"):
    rows = []
    rows += bench_vgg(CIFAR10_BNN, "cifar10-bnn", device=device)
    rows += bench_vgg(CIFAR10_TNN, "cifar10-tnn", bitplane=True, device=device)
    rows += bench_mlp(MNIST_BNN, "mnist-bnn", device=device)
    rows += bench_mlp(MNIST_TNN, "mnist-tnn", device=device)
    rows.append(bench_serving(device=device))
    for r in rows:
        print(json.dumps(r))
        sys.stdout.flush()
    return rows


if __name__ == "__main__":
    main()
