"""The benchmark's readers of the serving engine's own stages and pauses
(``qbench/metrics/{drain,enqueue,logits_wait,resolve,gc_pause}_ms.py``,
through ``qbench.engine_stages``), fed hand-built ``qbench.run.Context``
objects and engines with hand-made timelines, and a served window read as
``qbench.run.run_cell`` reads it."""
import time

import numpy as np
import pytest
import torch

from qbench import engine_stages, registry
from qbench.run import Context, engine_counters
from qnx_torch.serve import engine as serve
from qnx_torch.serve.engine import ServeEngine

CELL = "cifar10-tnn-bitplane.backlog"
# reader -> the engine's counter it reads
READERS = {"drain_ms": "drain_ns", "enqueue_ms": "enqueue_ns",
           "logits_wait_ms": "wait_ns", "resolve_ms": "resolve_ns",
           "gc_pause_ms": "gc_ns"}
NAMES = sorted(READERS)
OLD_KEYS = ("batches", "images", "padded", "total_batch_ms", "clock")


class _Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("w", torch.ones(10))

    def forward(self, x):
        return x.flatten(1)[:, :10] * self.w


def _counters(clock, batches, batch_ms=0.0):
    """What ``engine_counters`` reads at one clock."""
    return {"batches": batches, "images": 1024 * batches, "padded": 0,
            "total_batch_ms": batch_ms, "clock": clock}


def _engine(monkeypatch, *records):
    """The process's last started engine, with a timeline of ``(counter,
    since s, until s)`` records."""
    engine = ServeEngine(_Toy(), batch_size=4)
    engine._stats.timeline.extend((k, round(a * 1e9), round(b * 1e9))
                                  for k, a, b in records)
    monkeypatch.setattr(serve, "last_started", lambda: engine)
    return engine


def _read(name, ctx):
    return registry.reader(name).read(ctx)


@pytest.mark.parametrize("name", NAMES)
def test_reader_gives_ms_a_batch(name, monkeypatch):
    _engine(monkeypatch, *((k, 0.0, 12.0) for k in READERS.values()))
    ctx = Context(counters=[_counters(1.0, 10), _counters(11.0, 210)],
                  slice_counters=None)
    assert _read(name, ctx) == pytest.approx(10e3 / 200)  # 50 ms


@pytest.mark.parametrize("name", NAMES)
def test_reader_reads_its_own_counter(name, monkeypatch):
    _engine(monkeypatch, (READERS[name], 0.0, 2.5))
    ctx = Context(counters=[_counters(0.0, 0), _counters(10.0, 100)],
                  slice_counters=None)
    assert _read(name, ctx) == pytest.approx(25.0)
    assert all(_read(other, ctx) == 0.0 for other in NAMES if other != name)


@pytest.mark.parametrize("name", NAMES)
def test_reader_clips_the_timeline_to_the_window(name, monkeypatch):
    key = READERS[name]
    _engine(monkeypatch, (key, 0.5, 1.5), (key, 2.0, 2.25),
            (key, 10.5, 11.5), (key, 11.5, 13.0))
    ctx = Context(counters=[_counters(1.0, 0), _counters(11.0, 100)],
                  slice_counters=None)
    assert _read(name, ctx) == pytest.approx((0.5 + 0.25 + 0.5) * 1e3 / 100)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("case", ["no counters", "no batches", "no engine",
                                  "a timeline that no longer reaches back"])
def test_reader_gives_none(name, case, monkeypatch):
    ctx = Context(counters=[_counters(1.0, 0), _counters(11.0, 100)],
                  slice_counters=None)
    if case == "no counters":
        _engine(monkeypatch, (READERS[name], 0.0, 12.0))
        ctx.counters = None
    elif case == "no batches":
        _engine(monkeypatch, (READERS[name], 0.0, 12.0))
        ctx.counters = [_counters(1.0, 7), _counters(11.0, 7)]
    elif case == "no engine":
        monkeypatch.setattr(serve, "_last_started", None)
    else:
        monkeypatch.setattr(serve, "TIMELINE", 2)
        _engine(monkeypatch, (READERS[name], 4.0, 5.0), (READERS[name], 5.0, 6.0))
    assert _read(name, ctx) is None
    if case != "no counters" and case != "no batches":
        assert _read("engine_gap_ms", ctx) == pytest.approx(100.0)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("older", ["no last_started", "no between"])
def test_reader_gives_none_for_an_engine_without_stage_counters(name, older,
                                                                monkeypatch):
    """What the program gave before it kept a timeline: the reader finds
    nothing, raises nothing, and ``engine_gap_ms`` still reads."""
    if older == "no last_started":
        monkeypatch.delattr(serve, "last_started")
    else:
        class Older:
            """The engine before it kept a timeline: ``ServeStats`` alone."""
            _stats = ServeEngine(_Toy(), batch_size=4)._stats
        monkeypatch.setattr(serve, "last_started", Older)
    ctx = Context(counters=[_counters(0.0, 0), _counters(10.0, 100, 6000.0)],
                  slice_counters=None)
    assert _read(name, ctx) is None
    assert _read("engine_gap_ms", ctx) == pytest.approx(40.0)


@pytest.mark.parametrize("name", NAMES)
def test_reader_leaves_the_profiled_slice_out(name, monkeypatch):
    """As ``engine_gap_ms`` does: the window less the slice's stretch."""
    _engine(monkeypatch, (READERS[name], 0.0, 10.0))
    ctx = Context(counters=[_counters(0.0, 0, 0.0), _counters(10.0, 100, 6000.0)],
                  slice_counters=[_counters(3.0, 30, 1800.0),
                                  _counters(5.0, 40, 3000.0)])
    # 90 batches and 8 s outside the slice
    assert _read(name, ctx) == pytest.approx(8e3 / 90)
    assert _read("engine_gap_ms", ctx) == pytest.approx((8.0 - 4.8) / 90 * 1e3)
    # a slice that ran past the window's close: the window before it
    ctx.slice_counters = [_counters(3.0, 30, 1800.0), _counters(11.0, 101)]
    assert _read(name, ctx) == pytest.approx(3e3 / 30)
    ctx.slice_counters = [_counters(12.0, 101), _counters(13.0, 102)]
    assert _read(name, ctx) is None


def test_engine_counters_of_the_engine():
    engine = ServeEngine(_Toy(), batch_size=4, max_wait_ms=1.0)
    with engine:
        engine.predict(np.zeros((6, 4, 4, 1), np.uint8))
    got, s = engine_counters(engine), engine._stats
    assert set(got) == set(OLD_KEYS)
    assert {k: got[k] for k in OLD_KEYS[:-1]} == {
        "batches": s.batches, "images": s.images, "padded": s.padded,
        "total_batch_ms": s.total_batch_ms}


def test_readers_of_a_served_window():
    """Read as ``run_cell`` reads: ``engine_counters`` at the window's ends,
    the readers after the engine stopped.  The four stages add up to the
    window's seconds a batch, and drain and resolve, less what the
    dispatcher did while a batch was in flight between its enqueue and its
    wait (the next batch's drain and enqueue), to ``engine_gap_ms``."""
    def forward(m, x):
        time.sleep(0.01)
        return m(x)

    engine = ServeEngine(_Toy(), batch_size=4, max_wait_ms=1.0, forward=forward)
    images = np.zeros((4, 4, 4, 1), np.uint8)
    with engine:
        engine.predict(images)
        counters = [engine_counters(engine)]
        futs = [f for _ in range(12) for f in engine.submit_many(images[:3])]
        for f in futs:
            f.result(timeout=60)
        counters.append(engine_counters(engine))
    assert engine_stages.engine() is engine
    ctx = Context(counters=counters, slice_counters=None)
    got = {name: _read(name, ctx) for name in NAMES}
    (a, b), batches = counters, counters[1]["batches"] - counters[0]["batches"]
    assert batches == 9
    stages = got["drain_ms"] + got["enqueue_ms"] + got["logits_wait_ms"] + got["resolve_ms"]
    assert stages == pytest.approx((b["clock"] - a["clock"]) / batches * 1e3, rel=1e-6)
    assert got["enqueue_ms"] >= 10.0
    assert got["gc_pause_ms"] >= 0.0
    # no batch was between dispatch and answers at either end; each batch's
    # time from dispatch to answers holds its enqueue, its wait, and the
    # stages between them, which the overlapped batches make long
    lo = round(a["clock"] * 1e9)
    spans = {s: [(x, y) for k, x, y in engine._stats.timeline if k == s and x >= lo]
             for s in ("enqueue_ns", "wait_ns")}
    assert len(spans["enqueue_ns"]) == len(spans["wait_ns"]) == batches
    between = sum(w[0] - e[1] for e, w in zip(spans["enqueue_ns"], spans["wait_ns"]))
    assert engine.counters()["overlapped"] > 0 and between > 0
    gap = got["drain_ms"] + got["resolve_ms"] - between / batches / 1e6
    assert gap == pytest.approx(_read("engine_gap_ms", ctx), rel=1e-6, abs=1e-6)


def test_engine_counters_of_an_engine_without_counters():
    class Older:
        """The engine before it counted its stages: ``ServeStats`` alone."""
        def __init__(self, stats):
            self._stats = stats

    engine = ServeEngine(_Toy(), batch_size=4)
    engine._stats.batches, engine._stats.total_batch_ms = 3, 12.5
    got = engine_counters(Older(engine._stats))
    assert set(got) == set(OLD_KEYS)
    assert (got["batches"], got["total_batch_ms"]) == (3, 12.5)


@pytest.mark.parametrize("name", NAMES)
def test_new_per_layer_entry_has_its_reader(name):
    bench = registry.load_benchmark()
    entry = {m["name"]: m for m in bench["per_layer"]}[name]
    assert entry == {"name": name, "unit": "ms", "better": "lower",
                     "source": "program_span",
                     "layer": "serving process" if name == "gc_pause_ms"
                     else "serving engine",
                     "moves": "serve_ips",
                     "workloads": [CELL, "imagenet-bireal18.backlog"]}
    assert callable(registry.reader(name).read)
    assert name in {m["name"] for m in registry.cell(CELL)["per_layer"]}
