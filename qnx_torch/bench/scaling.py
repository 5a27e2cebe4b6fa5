"""Scaling of the int8 VGG engine over cards (torch port of
:mod:`qnx.bench.scaling`), in two honestly labelled tiers:

1. ``modeled``: analytic models of the serving design on H100s, on the
   card's own constants (:data:`INT8_MACS`, :data:`ENGINE_EFF`,
   :data:`NVLINK_BYTES`, :data:`PCIE_BYTES`):
   * DP (batch sharding) at inference has no collectives between cards;
     each runs the whole model on its slice, bounded only by feeding its
     uint8 images over its own PCIe link;
   * TP (output-channel sharding) pays one activation all-gather per layer
     boundary, overlapped with the GEMM by the ring schedule of
     :mod:`qnx_torch.parallel.overlap`: per-layer compute at the engine's
     measured share of the int8 peak against the ring's hops over NVLink,
     with and without overlap;
2. ``measured``: :func:`measure_mesh` runs the bring-up's TP int8 forward
   (:func:`qnx_torch.parallel.bringup.tp_int8_forward`) on 1, 2 and 4
   ranks, asserts every world's logits equal the one-rank run's, and
   reports each world's ms a forward labelled by device, backend and
   transport.  Ranks that share one card measure that card and its host,
   not a multi-card system.

    python -m qnx_torch bench scaling [--device cuda|cpu] [--backend gloo|nccl]
"""
from __future__ import annotations

import json
import sys

import numpy as np

from qnx_torch.bench.roofline import H100_PEAKS

#: dense int8 tensor-core MAC/s of one H100 SXM (NVIDIA's data sheet)
INT8_MACS = H100_PEAKS["int8_macs"]
#: the engine's share of that peak: kernel E's five VGG convs in 0.614 ms
#: at batch 256 against their int8 bound of 0.156 ms (chip_smoke.py, PERF.md
#: §6, NVIDIA H100 80GB HBM3, 700.00 W)
ENGINE_EFF = 0.156 / 0.614
#: NVLink 4 of an H100 SXM: 900 GB/s a card, both directions together
#: (NVIDIA's data sheet), so 450 GB/s each way
NVLINK_BYTES = 450e9
#: PCIe Gen5 x16: 128 GB/s, both directions together (NVIDIA's H100 SXM
#: data sheet), so 64 GB/s host to card
PCIE_BYTES = 64e9


def vgg_layers(width: int = 128):
    """(h, w, cin, cout) per quantized conv layer of the CIFAR VGG."""
    w1, w2, w3 = width, 2 * width, 4 * width
    return [
        (32, 32, w1, w1),
        (16, 16, w1, w2), (16, 16, w2, w2),
        (8, 8, w2, w3), (8, 8, w3, w3),
    ]


def _t_compute(macs: float) -> float:
    return macs / (INT8_MACS * ENGINE_EFF)


def tp_efficiency_model(tp: int, batch: int = 1024, width: int = 128,
                        overlap: bool = True) -> dict:
    """Analytic TP scaling of the int8 VGG engine over an NVLink ring.

    Output-channel sharding: each layer computes its N/tp channels locally
    from the whole activation tensor; the int8 codes it produces
    (B*h*w*N/tp bytes) are all-gathered before the next layer, tp - 1 hops
    of a 1/tp share each; with the collective-matmul schedule each hop
    hides behind 1/tp of the layer's GEMM."""
    t_comp_total = t_exposed_total = t_ag_total = 0.0
    for (h, w, cin, cout) in vgg_layers(width):
        t_comp = _t_compute(batch * h * w * 9 * cin * cout / tp)
        act_bytes = batch * h * w * cout
        t_hop = (act_bytes / tp) / NVLINK_BYTES
        t_ag = (tp - 1) * t_hop
        if overlap:
            t_exposed = max(0.0, t_hop - t_comp / tp) * (tp - 1)
        else:
            t_exposed = t_ag
        t_comp_total += t_comp
        t_ag_total += t_ag
        t_exposed_total += t_exposed
    t1 = _t_compute(sum(batch * h * w * 9 * cin * cout
                        for (h, w, cin, cout) in vgg_layers(width)))
    t_tp = t_comp_total + t_exposed_total
    return {
        "tier": "modeled",
        "tp": tp,
        "t_1card_ms": t1 * 1e3,
        "t_tp_ms": t_tp * 1e3,
        "t_allgather_ms": t_ag_total * 1e3,
        "t_exposed_ms": t_exposed_total * 1e3,
        "efficiency": t1 / (tp * t_tp),
        "overlap": overlap,
    }


def dp_efficiency_model(n_cards: int, batch_per_card: int = 1024,
                        width: int = 128) -> dict:
    """DP serving: no collectives between cards; the bound is feeding each
    card its uint8 images (32*32*3 bytes each) over its own PCIe link."""
    t_comp = _t_compute(batch_per_card * sum(
        h * w * 9 * cin * cout for (h, w, cin, cout) in vgg_layers(width)))
    t_feed = batch_per_card * 32 * 32 * 3 / PCIE_BYTES
    return {
        "tier": "modeled",
        "n_cards": n_cards,
        "t_compute_ms": t_comp * 1e3,
        "t_feed_ms": t_feed * 1e3,
        "efficiency": min(1.0, t_comp / max(t_comp, t_feed)),
        "note": "no collectives at inference; the bound is host ingress",
    }


def measure_mesh(width: int = 32, batch: int = 64, worlds=(1, 2, 4),
                 device: str = "cuda", backend: str = "gloo",
                 iters: int = 5) -> list[dict]:
    """The bring-up's TP int8 forward on each world size (mesh
    ``make_mesh(n)``, default model degree), every rank a process; raises
    unless each world's logits equal the one-rank run's bit for bit."""
    from qnx_torch.bench.microbench import device_label
    from qnx_torch.models.factory import init_variables
    from qnx_torch.parallel.launch import run_world
    from qnx_torch.parallel.mesh import default_model_parallel
    from qnx_torch.utils.config import Config

    cf = Config(dataset="synthetic-cifar", architecture="vgg", width=width,
                dense_units=4 * width, network_type="full-bnn", H=1.0,
                first_layer_float=True, last_layer_float=True)
    x = np.random.RandomState(0).uniform(-1, 1, (batch, 32, 32, 3)).astype(np.float32)
    payload = {"variables": init_variables(cf, 0), "cf": cf, "x": x,
               "time_iters": iters}
    label = device_label(device)
    ref, rows = None, []
    for n in worlds:
        res = run_world("int8_forward", payload, n, default_model_parallel(n),
                        device=device, backend=backend)
        logits = res[0]["logits"].numpy()
        ref = logits if ref is None else ref
        exact = bool(np.array_equal(ref, logits)) and all(
            np.array_equal(logits, r["logits"].numpy()) for r in res)
        if not exact:
            raise AssertionError(f"{n} ranks: logits differ from the one-rank run's")
        rows.append({
            "tier": "measured",
            "ranks": n,
            "mesh": res[0]["mesh"],
            "exact_vs_1rank": exact,
            "device_ms": res[0]["device_ms"],
            "host_ms": res[0]["host_ms"],
            "device": label,
            "backend": res[0]["backend"],
            "transport": res[0]["transport"],
            "devices": sorted({r["device"] for r in res}),
        })
    return rows


def main(argv=None, device: str = "cuda", backend: str = "gloo",
         worlds=(1, 2, 4)):
    report = {
        "dp_model": [dp_efficiency_model(n) for n in (1, 8, 16, 64)],
        "tp_model": [tp_efficiency_model(tp) for tp in (1, 2, 4, 8)]
        + [tp_efficiency_model(8, overlap=False)],
        "mesh": measure_mesh(device=device, backend=backend, worlds=worlds),
    }
    for section, rows in report.items():
        print(f"## {section}", file=sys.stderr)
        for r in rows:
            print(json.dumps(r), file=sys.stderr)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
