"""The serving engine's own measurement, on the CPU: the four stage counters
that partition the dispatcher's cycle, the collector's pauses through
``gc.callbacks``, the ``qnx.serve.*`` and ``qnx.gc.gen*`` ranges that exist
only while a profiler records, and latency once a request."""
import gc
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from qnx_torch.serve.engine import ServeEngine, normalize_u8
from qnx_torch.utils import profiling

STAGES = ("drain_ns", "enqueue_ns", "wait_ns", "resolve_ns")
# the stats() keys the engine had before it timed its stages
STATS_KEYS = {"batches", "images", "pad_fraction", "throughput_ips",
              "wall_throughput_ips", "latency_ms_p50", "latency_ms_p99",
              "latency_samples", "forward_path"}


class Toy(torch.nn.Module):
    """Images -> 10 logits, with a buffer for the engine's device."""

    def __init__(self):
        super().__init__()
        self.register_buffer("w", torch.arange(1.0, 11.0))

    def forward(self, x):
        return x.flatten(1)[:, :10] * self.w


def _u8(n, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, 4, 4, 1), np.uint8)


def _want(images):
    return Toy()(normalize_u8(torch.from_numpy(images))).numpy()


def _serve(engine, chunks):
    """Queue ``chunks`` before the start, so the batches are fixed; serve
    them; return the logits in order."""
    futs = [f for c in chunks for f in engine.submit_many(c)]
    with engine:
        return np.stack([f.result(timeout=60) for f in futs])


def _slow(seconds):
    def forward(m, x):
        time.sleep(seconds)
        return m(x)
    return forward


def test_stage_counters_add_up_to_the_dispatchers_time():
    engine = ServeEngine(Toy(), batch_size=4, max_wait_ms=1.0,
                         forward=_slow(0.02))
    futs = [f for n in (3, 6, 5, 2) for f in engine.submit_many(_u8(n, n))]
    t0 = time.perf_counter()
    engine.start()
    try:
        for f in futs:
            f.result(timeout=60)
        elapsed = engine._stats.last_answer - t0
        c = engine.counters()
    finally:
        engine.stop()
    assert c["batches"] == 4
    assert all(c[s] > 0 for s in STAGES)
    assert sum(c[s] for s in STAGES) / 1e9 == pytest.approx(elapsed, rel=0.05)
    assert c["enqueue_ns"] >= 4 * 0.02e9  # the forward's sleep is enqueued
    # total_batch_ms is dispatch to the logits on the host: from the start of
    # a batch's enqueue to the end of its wait, which with two batches in
    # flight holds the next batch's drain and enqueue
    spans = {s: [(a, b) for k, a, b in engine._stats.timeline if k == s]
             for s in ("enqueue_ns", "wait_ns")}
    assert len(spans["enqueue_ns"]) == len(spans["wait_ns"]) == 4
    assert c["total_batch_ms"] == pytest.approx(sum(
        w[1] - e[0] for e, w in zip(spans["enqueue_ns"], spans["wait_ns"])) / 1e6)
    assert c["total_batch_ms"] > (c["enqueue_ns"] + c["wait_ns"]) / 1e6
    c = engine.counters()  # stopped: the last drain is closed
    stage_ms = engine.stats()["stage_ms"]
    assert stage_ms == pytest.approx({s[:-3]: c[s] / 4 / 1e6 for s in STAGES})


def test_the_running_stage_counts_up_to_the_reading():
    """Between two readings the stages add up to the time between them,
    whatever the dispatcher is doing: here, draining an empty queue."""
    engine = ServeEngine(Toy(), batch_size=4, max_wait_ms=1.0)
    with engine:
        engine.predict(_u8(5, 0))
        t1, a = time.perf_counter_ns(), engine.counters()
        time.sleep(0.25)
        t2, b = time.perf_counter_ns(), engine.counters()
        assert b["drain_ns"] - a["drain_ns"] == pytest.approx(t2 - t1, rel=0.05)
        assert all(b[s] == a[s] for s in STAGES if s != "drain_ns")
    assert engine.counters()["drain_ns"] >= b["drain_ns"]


def test_counters_keep_the_stats_fields():
    engine = ServeEngine(Toy(), batch_size=4, max_wait_ms=1.0)
    _serve(engine, [_u8(3, 0), _u8(6, 1)])
    c, s = engine.counters(), engine._stats
    for key in ("batches", "images", "padded", "total_batch_ms", "gc_frozen",
                "overlapped"):
        assert c[key] == getattr(s, key)
    assert (c["batches"], c["images"], c["padded"]) == (3, 9, 3)
    # queued before the start: the second batch launched while the first was
    # in flight; the third, a carry lingering on the empty queue, after the
    # second, whose logits were on the host, was answered
    assert c["overlapped"] == 1
    assert set(c) == set(s.COUNTERS)


def test_collections_are_counted_while_the_engine_runs():
    engine = ServeEngine(Toy(), batch_size=4, max_wait_ms=1.0)
    engine.start()
    try:
        assert engine._stats.on_gc in gc.callbacks
        before = engine.counters()
        gc.collect()
        after = engine.counters()
    finally:
        engine.stop()
    assert after["gc_collections_2"] == before["gc_collections_2"] + 1
    assert after["gc_ns"] > before["gc_ns"]
    assert engine._stats.on_gc not in gc.callbacks
    gc.collect()  # no longer counted
    assert engine.counters()["gc_collections_2"] == after["gc_collections_2"]
    g = engine.stats()["gc"]
    assert g["collections"][2] == after["gc_collections_2"]
    assert g["pause_ms"] == pytest.approx(after["gc_ns"] / 1e6)


def _events(path):
    with open(os.path.join(path, profiling.TRACE_FILE)) as f:
        return [e for e in json.load(f)["traceEvents"]
                if str(e.get("name", "")).startswith("qnx.")]


def test_ranges_while_a_profiler_records(tmp_path):
    """Under ``profiling.trace``, which records every thread, the
    dispatcher's drains and resolves are ranges on its thread, and so is a
    collection that runs there."""
    def forward(m, x):
        if forward.calls == 1:
            gc.collect()
        forward.calls += 1
        return m(x)
    forward.calls = 0

    engine = ServeEngine(Toy(), batch_size=4, max_wait_ms=1.0, forward=forward)
    chunks = [_u8(3, 0), _u8(6, 1), _u8(2, 2)]
    with profiling.trace(str(tmp_path)):
        got = _serve(engine, chunks)
    np.testing.assert_array_equal(got, _want(np.concatenate(chunks)))
    events = _events(str(tmp_path))
    by_name = {n: [e for e in events if e["name"] == n]
               for n in ("qnx.serve.drain", "qnx.serve.resolve", "qnx.gc.gen2")}
    assert len(by_name["qnx.serve.resolve"]) == 3
    assert len(by_name["qnx.serve.drain"]) >= 3
    assert by_name["qnx.gc.gen2"]
    dispatcher = {e["tid"] for e in by_name["qnx.serve.resolve"]}
    assert len(dispatcher) == 1
    assert {e["tid"] for e in by_name["qnx.serve.drain"]} == dispatcher
    assert dispatcher & {e["tid"] for e in by_name["qnx.gc.gen2"]}


def test_range_args_on_a_profiler_started_by_the_dispatcher():
    """A profiler that records the dispatcher's thread with shapes, started
    and stopped inside the forward (as the benchmark's tracer does), holds
    the ranges of the batches it saw with their batch and request ids; a
    chunk split over batches keeps its request's id."""
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU], record_shapes=True)

    def forward(m, x):
        if forward.calls == 0:
            prof.start()
        if forward.calls == 2:
            gc.collect()
        if forward.calls == 3:
            prof.stop()
        forward.calls += 1
        return m(x)
    forward.calls = 0

    engine = ServeEngine(Toy(), batch_size=4, max_wait_ms=1.0, forward=forward)
    # batches: [r0 3, r1 1] [r1 4] [r1 1, r2 2, r3 1] [r3 3, pad 1]
    chunks = [_u8(3, 0), _u8(6, 1), _u8(2, 2), _u8(4, 3)]
    got = _serve(engine, chunks)
    np.testing.assert_array_equal(got, _want(np.concatenate(chunks)))
    events = list(prof.profiler.kineto_results.events())
    args = {n: sorted(tuple(e.kwinputs()[k] for k in keys)
                      for e in events if e.name() == n)
            for n, keys in (("qnx.serve.resolve", ("batch", "first_request",
                                                   "last_request")),
                            ("qnx.serve.drain", ("batch", "first_request")))}
    assert args["qnx.serve.resolve"] == [(0, 0, 1), (1, 1, 1), (2, 1, 3)]
    assert args["qnx.serve.drain"] == [(1, 1), (2, 1), (3, 3)]
    assert "qnx.gc.gen2" in [e.name() for e in events]
    assert engine.counters()["requests"] == 4


def test_no_range_without_a_profiler(monkeypatch):
    opened = []  # a gc callback's exception is only reported, so keep count

    def refuse(*args, **kwargs):
        opened.append(args)
        raise AssertionError("a range was opened with no profiler recording")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", refuse)

    def forward(m, x):
        gc.collect()  # the collector's callback opens nothing either
        return m(x)

    chunks = [_u8(3, 0), _u8(6, 1)]
    engine = ServeEngine(Toy(), batch_size=4, max_wait_ms=1.0, forward=forward)
    got = _serve(engine, chunks)
    np.testing.assert_array_equal(got, _want(np.concatenate(chunks)))
    assert engine.counters()["gc_collections_2"] >= 3
    assert opened == []


def test_a_split_request_records_one_latency():
    engine = ServeEngine(Toy(), batch_size=4, max_wait_ms=1.0)
    chunks = [_u8(3, 0), _u8(6, 1), _u8(2, 2)]  # the 6 spans three batches
    got = _serve(engine, chunks)
    np.testing.assert_array_equal(got, _want(np.concatenate(chunks)))
    stats = engine.stats()
    assert stats["batches"] == 3
    assert stats["latency_samples"] == engine.counters()["requests"] == 3
    assert len(engine._stats.latencies_ms) == 3
    assert stats["latency_ms_p99"] >= stats["latency_ms_p50"] > 0


def test_latency_samples_count_requests_from_many_clients():
    engine = ServeEngine(Toy(), batch_size=8, max_wait_ms=1.0)
    sizes = [1 + (i * 5) % 13 for i in range(40)]

    def client(k):
        for n in sizes[k::4]:
            futs = engine.submit_many(_u8(n, n))
            futs[-1].result(timeout=60)

    with engine:
        threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    c = engine.counters()
    assert c["requests"] == engine.stats()["latency_samples"] == len(sizes)
    assert c["images"] == sum(sizes)


def test_stats_keep_their_keys():
    engine = ServeEngine(Toy(), batch_size=4, max_wait_ms=1.0)
    _serve(engine, [_u8(5, 0)])
    stats = engine.stats()
    assert STATS_KEYS <= set(stats)
    # the carry of one image lingered on the empty queue: the first batch,
    # its logits on the host, was answered before the second launched
    assert stats["overlapped"] == engine.counters()["overlapped"] == 0
    assert set(stats["stage_ms"]) == {"drain", "enqueue", "wait", "resolve"}
    assert set(stats["gc"]) == {"collections", "pause_ms", "frozen"}
    json.dumps(stats)  # the serve command prints them


def test_between_gives_the_time_between_two_clock_readings():
    """The timeline's stages, clipped to two ``perf_counter`` readings
    taken without a call to the engine, add up to the time between them,
    and a stage that ran whole between them to what its counter grew by."""
    engine = ServeEngine(Toy(), batch_size=4, max_wait_ms=1.0,
                         forward=_slow(0.02))
    with engine:
        engine.predict(_u8(2, 0))
        since, a = time.perf_counter(), engine.counters()
        engine.predict(_u8(4, 1))
        b, until = engine.counters(), time.perf_counter()
        got = engine.between(since, until)
        gc.collect()
        assert engine.between(since, until) == got  # nothing after ``until``
    assert sum(got[s] for s in STAGES) == round(until * 1e9) - round(since * 1e9)
    assert got["enqueue_ns"] >= 0.02e9
    for s in ("enqueue_ns", "wait_ns"):  # neither runs at either reading
        assert got[s] == b[s] - a[s]
    whole = engine.between(0.0, time.perf_counter())
    assert {k: whole[k] for k in (*STAGES, "gc_ns")} == {
        k: engine.counters()[k] for k in (*STAGES, "gc_ns")}


def test_between_gives_none_once_the_timeline_has_dropped_since(monkeypatch):
    from qnx_torch.serve import engine as serve

    monkeypatch.setattr(serve, "TIMELINE", 8)
    engine = ServeEngine(Toy(), batch_size=4, max_wait_ms=1.0)
    since = time.perf_counter()
    _serve(engine, [_u8(4, k) for k in range(4)])  # 16 stages and more
    assert len(engine._stats.timeline) == 8
    assert engine.between(since, time.perf_counter()) is None
    recent = engine._stats.timeline[0][1] / 1e9 + 1e-6
    assert engine.between(recent, time.perf_counter()) is not None


def test_last_started_is_the_engine_started_last():
    from qnx_torch.serve.engine import last_started

    first, second = (ServeEngine(Toy(), batch_size=4) for _ in range(2))
    with first:
        assert last_started() is first
        with second:
            assert last_started() is second
    assert last_started() is second
    del second
    gc.collect()
    assert last_started() is None
