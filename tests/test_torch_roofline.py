"""qnx_torch's roofline report (:mod:`qnx_torch.bench.roofline`): the
``KernelResult`` arithmetic, compute- and memory-bound, with the popc
column, and ``measure_kernels`` on the CPU route at tiny shapes (structure
only: CPU times are no roofline), the fused dense rows included."""
import numpy as np
import pytest
import torch

from qnx_torch.bench.roofline import H100_PEAKS, KernelResult, main, measure_kernels

torch.set_num_threads(2)

TINY = dict(batch=2, iters=2, repeats=1, gemm_k=64, gemm_n=64,
            conv_shapes=[(8, 32, 32, True, "tiny")],
            dense_shapes=[(96, 40, "tiny dense")], dense_batch=3, device="cpu")


def test_kernel_result_roofline_math():
    # 1 ms measured, 0.5 ms at the int8 rate: compute-bound, fraction 0.5
    r = KernelResult("k", 1e-3, int(0.5e-3 * H100_PEAKS["int8_macs"]), 1000,
                     "int8_macs")
    assert r.bound == "compute"
    row = r.row()
    assert row["sol_fraction"] == pytest.approx(0.5, rel=1e-6)
    assert row["popc_ceiling_ms"] is None and row["popc_fraction"] is None
    # memory-bound
    r = KernelResult("k", 1e-3, 1000, int(0.5e-3 * H100_PEAKS["hbm_bytes"]),
                     "int8_macs")
    assert r.bound == "memory"
    assert r.row()["sol_fraction"] == pytest.approx(0.5, rel=1e-6)
    # the popc column: one popc per 32 MACs, 0.25 ms at the popc ceiling
    macs = int(0.25e-3 * H100_PEAKS["popc_ops"] * 32)
    r = KernelResult("k", 1e-3, macs, 0, "int8_macs", popc_per_mac=1 / 32)
    assert r.row()["popc_fraction"] == pytest.approx(0.25, rel=1e-6)
    assert r.row()["sol_fraction"] == pytest.approx(
        macs / H100_PEAKS["int8_macs"] / 1e-3, rel=1e-6)


def test_measure_kernels_smoke_tiny():
    rows = measure_kernels(**TINY)
    names = [r.name for r in rows]
    for part in ("torch._int_mm", "popcount GEMM B", "ternary two-plane GEMM C",
                 "[E fused]", "xnor conv fused [A]", "ternary conv fused [A']",
                 "calibration"):
        assert any(part in n for n in names), part
    assert len(rows) == 4 + 4 + 4 + 1
    assert all(np.isfinite(r.t_measured_s) for r in rows)
    assert all(np.isfinite(r.speed_of_light) and r.bytes_moved > 0 for r in rows)
    conv_a = next(r for r in rows if "[A]" in r.name)
    # A's, A''s and E's convs run on the int8 tensor cores, B, C and G (one
    # accumulator set: B's schedule) on the single-bit ones (C two AND
    # products a MAC): no popc ceiling
    for part in ("[A]", "[A']", "[E fused]", "GEMM B", "GEMM C", "GEMM G"):
        assert next(r for r in rows if part in r.name).t_popc is None, part
    b, c, g = (next(r for r in rows if part in r.name)
               for part in ("GEMM B", "GEMM C", "GEMM G"))
    assert (b.peak_key, b.ops_per_mac) == ("b1_macs", 1)
    assert (c.peak_key, c.ops_per_mac) == ("b1_macs", 2)
    assert (g.peak_key, g.ops_per_mac) == ("b1_macs", 1) and g.popc_per_mac == 0
    assert b.macs == c.macs == g.macs == 2 * 64 * 64
    # packed input + words + corr + sgn + tau + packed pooled output
    assert conv_a.bytes_moved == 4 * (2 * 8 * 8 * 1 + 9 * 32 + 8 * 8 * 32 + 2 * 32
                                      + 2 * 4 * 4 * 1)


def test_main_prints_the_table(capsys):
    rows = main(**TINY)
    out = capsys.readouterr()
    assert "not a device measurement" in out.out
    assert len(out.err.strip().splitlines()) == len(rows)


def test_measure_kernels_dense_rows():
    """The fused dense kernels of A, A' and D beside ``torch._int_mm`` at
    the dense shape: on the int8 tensor cores, so no popc ceiling; their
    MACs and bytes (packed inputs, thresholds, packed output words)."""
    rows = measure_kernels(**TINY)
    dense = [r for r in rows if "tiny dense" in r.name]
    assert [r.name.split(" 3x")[0] for r in dense] == [
        "int8 GEMM torch._int_mm tiny dense", "xnor dense fused [A] tiny dense",
        "ternary dense fused [A'] tiny dense",
        "plane dense fused [D] P=2 tiny dense"]
    assert all(r.macs == 3 * 96 * 40 and r.t_popc is None for r in dense)
    kw, nw = 3, 2  # 96 bits in 3 words, 40 channels in 2 words
    a = dense[1]
    assert a.bytes_moved == 4 * (3 * kw + kw * 40 + 2 * 40 + 3 * nw)
    d = dense[3]
    assert d.bytes_moved == 4 * (2 * 3 * kw + 2 * kw * 40 + 40 + 3 * 40 + 2 * 3 * nw)
