"""The least time one H100 could take for a model's work: the yardstick of
the benchmark's roofline and MFU shares.

A layer's least time is the larger of its compute and its bytes.  Compute
is held to the fastest unit of the card that computes the product exactly,
so a later change of the kernel that implements a layer cannot move the
bound: float32 products (TF32 off) at 2 FLOP a MAC on the CUDA cores,
binary and ternary products on the single-bit tensor cores, at the number
of single-bit MACs a MAC the layer needs (``layer_work``'s ``b1_per_mac``).
Bytes are each input read once and each output written once at their
quantized widths, plus the weights once a call, at the HBM rate.
"""
from __future__ import annotations

PEAKS = {
    # NVIDIA H100 SXM data sheet, dense, at the 700 W power limit: float32
    # on the CUDA cores 67 TFLOP/s, HBM3 3.35 TB/s
    "f32_flops": 67e12,
    "hbm_bytes": 3.35e12,
    # single-bit MACs (wgmma m64n128k256 .b1.b1.and.popc) a second of the
    # whole card, measured on an NVIDIA H100 80GB HBM3 at 700 W on tiles in
    # shared memory: 7.95x the s8 wgmma's rate in the same run
    "b1_macs": 7.9076e15,
}


def compute_s(row: dict, batch: int) -> float:
    if row["unit"] == "f32":
        return 2.0 * row["macs"] * batch / PEAKS["f32_flops"]
    if row["unit"] == "b1":
        return row["b1_per_mac"] * row["macs"] * batch / PEAKS["b1_macs"]
    raise ValueError(f"unknown unit {row['unit']!r}")


def bytes_s(row: dict, batch: int) -> float:
    return (row["io_bytes"] * batch + row["weight_bytes"]) / PEAKS["hbm_bytes"]


def least_s(rows: list[dict], batch: int, stage: str | None = None) -> float:
    """Least seconds of one call at ``batch`` images, of the layers of
    ``stage`` (all layers when None), each layer the larger of its compute
    and its bytes."""
    return sum(max(compute_s(r, batch), bytes_s(r, batch)) for r in rows
               if stage is None or r["stage"] == stage)
