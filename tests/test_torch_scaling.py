"""The port's scaling report on the CPU: the models on the card's own
constants (no TPU figure), and ``measure_mesh`` exact across 1 and 2
ranks (processes over gloo)."""
import json

import numpy as np
import pytest

import qnx.bench.scaling as jax_scaling
import qnx_torch.bench.scaling as S
from qnx_torch.bench.roofline import H100_PEAKS


def test_vgg_layers_equal_jax():
    for width in (16, 128):
        assert S.vgg_layers(width) == jax_scaling.vgg_layers(width)
    total = sum(h * w * 9 * cin * cout for (h, w, cin, cout) in S.vgg_layers(128))
    assert abs(total - 603e6) / 603e6 < 0.01


def test_models_carry_no_tpu_constant():
    tpu = {jax_scaling.ICI_LINK_BYTES, jax_scaling.DCN_HOST_BYTES,
           jax_scaling.INT8_MACS, jax_scaling.MEASURED_ENGINE_EFF}
    ours = {S.NVLINK_BYTES, S.PCIE_BYTES, S.INT8_MACS, S.ENGINE_EFF}
    assert not tpu & ours
    assert S.INT8_MACS == H100_PEAKS["int8_macs"]
    rows = [S.dp_efficiency_model(8), S.tp_efficiency_model(2),
            S.tp_efficiency_model(8, overlap=False)]
    assert all(r["tier"] == "modeled" for r in rows)
    for r in rows:
        assert "tpu" not in json.dumps(r).lower()


def test_dp_model_no_collectives():
    for n in (1, 8, 64):
        r = S.dp_efficiency_model(n)
        assert r["efficiency"] == 1.0  # compute > feed at batch 1024
        assert r["t_feed_ms"] < r["t_compute_ms"]


def test_tp_model_monotone_and_overlap_helps():
    effs = [S.tp_efficiency_model(tp)["efficiency"] for tp in (1, 2, 4, 8)]
    assert effs[0] == pytest.approx(1.0)
    assert all(a >= b for a, b in zip(effs, effs[1:]))
    with_ov = S.tp_efficiency_model(8, overlap=True)
    without = S.tp_efficiency_model(8, overlap=False)
    assert with_ov["t_exposed_ms"] <= without["t_exposed_ms"]


def test_measure_mesh_exact_at_one_and_two_ranks():
    rows = S.measure_mesh(width=8, batch=8, worlds=(1, 2), device="cpu", iters=1)
    assert [r["ranks"] for r in rows] == [1, 2]
    assert [r["mesh"] for r in rows] == [[1, 1], [2, 1]]
    assert all(r["exact_vs_1rank"] and r["tier"] == "measured" for r in rows)
    assert all(r["backend"] == "gloo" and r["transport"] == "gloo" for r in rows)
    assert all(r["device"].startswith("cpu") and r["host_ms"] > 0 for r in rows)


def test_cli_bench_scaling_on_the_cpu(capsys):
    from qnx_torch.__main__ import main

    orig = S.measure_mesh
    try:
        S.measure_mesh = lambda **kw: orig(width=8, batch=8, iters=1,
                                           **{**kw, "worlds": (2,)})
        assert main(["bench", "scaling", "--device", "cpu"]) == 0
    finally:
        S.measure_mesh = orig
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(report) == {"dp_model", "tp_model", "mesh"}
    assert [r["ranks"] for r in report["mesh"]] == [2]
    assert np.isfinite([r["efficiency"] for r in report["tp_model"]]).all()
