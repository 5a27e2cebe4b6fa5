"""qnx_torch's timing harness (:mod:`qnx_torch.bench.microbench`): the
schema of ``time_fns_marginal_interleaved`` on the CPU route, and its
summary arithmetic against the JAX harness's under the same scripted sample
times (the min-long - min-short estimate, the median fallback, the clamp
with ``unreliable``).  CPU times are no device measurement."""
import types

import numpy as np
import pytest
import torch

import qnx.bench.microbench as jax_mb
from qnx_torch.bench import microbench as mb

torch.set_num_threads(2)

# per-round (long, short) seconds of two targets, iters = 8
SCRIPTS = {
    "estimate": [[(0.80, 0.10), (0.90, 0.12)], [(0.75, 0.11), (0.95, 0.15)],
                 [(0.78, 0.09), (0.85, 0.13)]],
    # min long - min short <= 0 but the median of the paired differences > 0
    "median_fallback": [[(0.30, 0.35), (0.90, 0.12)], [(0.50, 0.40), (0.95, 0.15)],
                        [(0.60, 0.45), (0.85, 0.13)]],
    # every paired difference <= 0: both clamped
    "clamp": [[(0.10, 0.20), (0.90, 0.12)], [(0.11, 0.30), (0.95, 0.15)],
              [(0.12, 0.25), (0.85, 0.13)]],
}


def _clock(rounds):
    """A scripted ``time`` module: perf_counter() returns start and end
    values whose differences are, in call order, round by round and target
    by target, the long then the short chain's seconds."""
    ticks = []
    for per_target in rounds:
        for long, short in per_target:
            ticks += [0.0, long, 0.0, short]
    it = iter(ticks)
    return types.SimpleNamespace(perf_counter=lambda: next(it))


def _targets():
    w = torch.randn(64, 64)
    x = torch.randn(32, 64)
    return {"a": (lambda x, w: torch.tanh(x @ w), (x, w)),
            "b": (lambda x, w: torch.abs(x @ w), (x, w))}


def test_interleaved_marginal_timer_structure():
    out = mb.time_fns_marginal_interleaved(_targets(), iters=8, repeats=3,
                                           device="cpu")
    for name in ("a", "b"):
        r = out[name]
        assert set(r) == {"t", "median", "samples", "spread", "unreliable"}
        assert len(r["samples"]) == 3
        assert r["samples"] == sorted(r["samples"])
        assert np.isfinite(r["t"]) and np.isfinite(r["median"])
        assert r["t"] > 0 and r["median"] > 0


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_summary_arithmetic_matches_the_jax_harness(script, monkeypatch):
    rounds = SCRIPTS[script]
    monkeypatch.setattr(jax_mb, "time", _clock(rounds))
    monkeypatch.setattr(jax_mb, "_sync", lambda x: None)
    monkeypatch.setattr(jax_mb, "_marginal_loop", lambda fn: (lambda n, *a: 0.0))
    want = jax_mb.time_fns_marginal_interleaved(
        {"a": (None, ()), "b": (None, ())}, iters=8, repeats=3)
    monkeypatch.setattr(mb, "time", _clock(rounds))
    got = mb.time_fns_marginal_interleaved(
        {"a": (lambda: None, ()), "b": (lambda: None, ())}, iters=8, repeats=3,
        device="cpu")
    assert got == want
    for i, name in enumerate("ab"):
        long = [r[i][0] for r in rounds]
        short = [r[i][1] for r in rounds]
        assert mb.summarize(long, short, 8) == want[name]
    a = got["a"]
    if script == "estimate":
        assert not a["unreliable"]
        assert a["t"] == pytest.approx((0.75 - 0.09) / 7)
    elif script == "median_fallback":
        assert a["unreliable"] and a["t"] == a["median"] > 0
    else:
        assert a["unreliable"] and a["t"] == a["median"] == 1e-9


def test_marginal_and_wall_timers_on_the_cpu_route():
    x = torch.randn(64, 64)
    assert np.isfinite(mb.time_fn_marginal(torch.tanh, x, iters=4, repeats=2,
                                           device="cpu"))
    assert np.isfinite(mb.time_fn_marginal(torch.tanh, x, device="cpu", target_s=0.01))
    assert mb.time_fn(torch.tanh, x, iters=3, device="cpu") > 0
    t = mb.chain_time(lambda a, b: a @ b, x, x, mix=lambda a, c: a + c * 0,
                      acc0=torch.zeros(()), iters=4, repeats=2)
    assert np.isfinite(t)
    assert mb.gemm_tmacs(1000, 1000, 1000, 1e-3) == pytest.approx(1.0)


def test_devices():
    assert mb.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="no timing route"):
        mb.resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            mb.resolve_device("cuda")
        with pytest.raises(RuntimeError, match="no CUDA card"):
            mb.time_fn_marginal(torch.tanh, torch.ones(2))
    assert "not a device measurement" in mb.device_label("cpu")
    with pytest.raises(ValueError, match="iters"):
        mb.time_fns_marginal_interleaved(_targets(), iters=1, device="cpu")
    assert mb.l2_warm(torch.empty(1024, 1024, dtype=torch.int32))
    assert not mb.l2_warm(torch.empty(8192, 2048, dtype=torch.int32))
