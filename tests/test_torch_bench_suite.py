"""The port's per-config bench suite on the CPU: the rows' structure with
the timer stubbed (as tests/test_bench_suite.py stubs the JAX suite's),
and the serving row from a small real run.  Real numbers come from the
card (chip_smoke.py)."""
import json

import pytest
import torch

import qnx_torch.bench.suite as suite
from qnx_torch.utils.config import CIFAR10_BNN, CIFAR10_TNN, MNIST_BNN, MNIST_TNN

torch.set_num_threads(2)

ROW_KEYS = {"config", "batch", "ms_per_batch", "ms_median", "spread",
            "images_per_s", "vs_f32_strict", "vs_tf32", "device"}


def _stub_timer(monkeypatch, seen: list):
    def fake_interleaved(targets, **kw):
        seen.append(sorted(targets))
        for fn, args in targets.values():  # every target runs
            fn(*args)
        return {name: {"t": 1e-3 * (2 if name == "f32-strict" else 1),
                       "median": 1e-3, "samples": [1e-3], "spread": 0.0,
                       "unreliable": False}
                for name in targets}

    monkeypatch.setattr(suite, "time_fns_marginal_interleaved", fake_interleaved)


@pytest.mark.parametrize("cf,name", [(MNIST_BNN, "mnist-bnn"), (MNIST_TNN, "mnist-tnn")])
def test_bench_mlp_rows(monkeypatch, cf, name):
    seen = []
    _stub_timer(monkeypatch, seen)
    rows = suite.bench_mlp(cf.replace(dim=64, num_hidden=2), name, batch=8,
                           device="cpu")
    assert seen == [["f32-strict", "int8", "popcount", "tf32"]]
    assert [r["config"] for r in rows] == [f"{name} int8", f"{name} popcount"]
    for r in rows:
        assert set(r) == ROW_KEYS
        assert r["images_per_s"] == pytest.approx(8000.0)
        assert r["vs_f32_strict"] == pytest.approx(2.0)
        assert r["vs_tf32"] == pytest.approx(1.0)
        assert r["device"].startswith("cpu")


def test_bench_vgg_rows_bnn_and_bitplane(monkeypatch):
    seen = []
    _stub_timer(monkeypatch, seen)
    rows = suite.bench_vgg(CIFAR10_BNN.replace(width=16, dense_units=32),
                           "cifar10-bnn", batch=4, device="cpu")
    assert rows[1]["config"] == "cifar10-bnn popcount"
    rows = suite.bench_vgg(CIFAR10_TNN.replace(width=16, dense_units=32),
                           "cifar10-tnn", batch=4, bitplane=True, device="cpu")
    assert rows[1]["config"] == "cifar10-tnn bitplane"
    assert all(set(r) == ROW_KEYS for r in rows)


def test_bench_serving_stats():
    r = suite.bench_serving(CIFAR10_BNN.replace(width=16, dense_units=32),
                            batch=8, requests=20, device="cpu")
    assert r["requests"] == 20 and r["batch"] == 8
    assert r["throughput_ips"] > 0 and r["wall_throughput_ips"] > 0
    assert r["latency_ms_p99"] >= r["latency_ms_p50"] > 0
    assert r["pad_fraction"] == pytest.approx(4 / 24)
    assert r["h2d_mbps_pageable"] is None and r["h2d_mbps_pinned"] is None
    assert "relay" not in json.dumps(r)


def test_tf32_allowed_restores_the_flags():
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with suite.tf32_allowed():
            assert torch.backends.cuda.matmul.allow_tf32
            assert torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def test_cli_bench_suite_dispatches(monkeypatch):
    from qnx_torch.__main__ import main

    calls = []
    monkeypatch.setattr(suite, "main", lambda argv=None, device="cuda": calls.append(device))
    assert main(["bench", "suite", "--device", "cpu"]) == 0
    assert calls == ["cpu"]
    with pytest.raises(RuntimeError, match="CUDA"):  # the headline wants the card
        main(["bench", "headline"])
