"""The serving engine's hold on the cyclic collector, on the CPU: while
engines serve, what outlived their set-up is frozen (``gc.freeze()``), once
at the first start and once more after each engine's first batch, and the
last ``stop()`` undoes it; a freeze the caller made is left alone.  Serving's
own objects are still freed: a cycle by the collector, a future by its
reference count, frozen or not.  The answers stay the model's, bit for
bit."""
import gc
import time
import weakref

import numpy as np
import pytest
import torch

from qnx_torch.convert.pack_model import pack_vgg_bitplane
from qnx_torch.models.factory import init_variables
from qnx_torch.serve import engine as serve
from qnx_torch.serve.engine import ServeEngine, normalize_u8
from qnx_torch.utils.config import Config

torch.set_num_threads(2)

# the benchmark's bit-plane path at small widths: ternary weights, four
# levels on two planes, the float first conv and head
TNN_CF = Config(dataset="synthetic-cifar", architecture="vgg", width=8,
                dense_units=64, network_type="full-tnn", wbits=2, abits=3,
                H=1.0, first_layer_float=True, last_layer_float=True)


class Toy(torch.nn.Module):
    """Images -> 10 logits, with a buffer for the engine's device."""

    def __init__(self):
        super().__init__()
        self.register_buffer("w", torch.arange(1.0, 11.0))

    def forward(self, x):
        return x.flatten(1)[:, :10] * self.w


class Node:
    """A weakly referable object to build cycles of."""


def _u8(n, seed, shape=(4, 4, 1)):
    return np.random.RandomState(seed).randint(0, 256, (n, *shape), np.uint8)


@pytest.fixture
def freezes(monkeypatch):
    """Each ``gc.freeze()`` and ``gc.unfreeze()`` of the test, as
    ``("freeze", objects moved)`` and ``("unfreeze", objects moved)``:
    frozen objects still die by their reference count, so the freeze
    count alone cannot say what a freeze moved."""
    calls = []

    def record(name, real):
        def call():
            before = gc.get_freeze_count()
            real()
            calls.append((name, abs(gc.get_freeze_count() - before)))
        return call

    for name in ("freeze", "unfreeze"):
        monkeypatch.setattr(gc, name, record(name, getattr(gc, name)))
    assert serve._serving == 0
    yield calls
    assert serve._serving == 0


def test_serving_freezes_and_stop_undoes_it(freezes):
    before = gc.get_freeze_count()
    engine = ServeEngine(Toy(), batch_size=4, max_wait_ms=1.0)
    engine.start()
    try:
        assert gc.get_freeze_count() > before
        assert [n for n, _ in freezes] == ["freeze"]
        # two batches: the first one freezes again, in the dispatcher, while
        # no other thread runs, so the engine's count is exact
        engine.predict(_u8(6, 0))
        assert gc.get_freeze_count() > before
        assert [n for n, _ in freezes] == ["freeze", "freeze"]
        moved = sum(k for _, k in freezes)
        assert engine.counters()["gc_frozen"] == moved > 0
        assert engine.stats()["gc"]["frozen"] == moved
    finally:
        engine.stop()
    assert [n for n, _ in freezes] == ["freeze", "freeze", "unfreeze"]
    # nothing stays frozen, the interpreter's own start-up tuples included
    assert gc.get_freeze_count() == 0
    assert engine.counters()["gc_frozen"] == moved  # a sum, kept


def test_the_freeze_outlasts_all_but_the_last_engine(freezes):
    first = ServeEngine(Toy(), batch_size=4, max_wait_ms=1.0).start()
    second = ServeEngine(Toy(), batch_size=4, max_wait_ms=1.0)
    try:
        second.start()  # neither collects nor freezes at its start
        assert second.counters()["gc_frozen"] == 0
        assert len(freezes) == 1
        second.predict(_u8(2, 1))  # its first batch does
        # ``first``'s dispatcher may free frozen objects while ``second``
        # reads the freeze count around its freeze, so it counts no more
        assert 0 < second.counters()["gc_frozen"] <= freezes[1][1]
        assert serve._serving == 2
        second.stop()
        second.stop()  # a second stop counts nothing twice
        assert serve._serving == 1
        assert gc.get_freeze_count() > 0
        first.predict(_u8(3, 2))
        assert [n for n, _ in freezes] == ["freeze"] * 3
    finally:
        first.stop()
        second.stop()
    assert freezes[-1][0] == "unfreeze"
    assert gc.get_freeze_count() == 0


def test_a_freeze_made_by_the_caller_is_left_alone(freezes):
    gc.freeze()
    try:
        engine = ServeEngine(Toy(), batch_size=4, max_wait_ms=1.0)
        with engine:
            engine.predict(_u8(6, 3))
        assert gc.get_freeze_count() > 0
        assert engine.counters()["gc_frozen"] == 0
        assert [n for n, _ in freezes] == ["freeze"]  # the caller's own
    finally:
        gc.unfreeze()


def test_a_cycle_made_while_serving_is_collected():
    engine = ServeEngine(Toy(), batch_size=4, max_wait_ms=1.0)
    with engine:
        engine.predict(_u8(5, 4))  # past the first batch's freeze
        a, b = Node(), Node()
        a.other, b.other = b, a
        ref = weakref.ref(a)
        del a, b
        gc.collect()
        assert ref() is None


def test_answered_futures_are_freed_by_their_reference_count():
    """The first batch's futures are frozen while in flight, the later
    ones not; a request split over batches leaves a carry.  With the
    collector off, each future goes once the caller drops it: nothing the
    engine keeps of a request forms a cycle."""
    engine = ServeEngine(Toy(), batch_size=4, max_wait_ms=1.0)
    with engine:
        futs = [f for n in (3, 6, 5) for f in engine.submit_many(_u8(n, n))]
        for f in futs:
            f.result(timeout=60)
        refs = [weakref.ref(f) for f in futs]
        assert engine.counters()["gc_frozen"] > 0
        enabled = gc.isenabled()
        gc.disable()
        try:
            del futs, f
            deadline = time.monotonic() + 10
            while any(r() is not None for r in refs) and time.monotonic() < deadline:
                time.sleep(0.01)  # the dispatcher drops its last chunks
            alive = sum(r() is not None for r in refs)
        finally:
            if enabled:
                gc.enable()
    assert alive == 0


def test_answers_are_the_models_forward_bit_for_bit():
    model = pack_vgg_bitplane(init_variables(TNN_CF, seed=5), TNN_CF, device="cpu")
    images = _u8(11, 6, shape=(32, 32, 3))
    with torch.inference_mode():
        want = model(normalize_u8(torch.from_numpy(images))).numpy()
    engine = ServeEngine(model, batch_size=4, max_wait_ms=1.0)
    with engine:
        got = engine.predict(images)  # three batches, frozen after the first
        assert engine.counters()["gc_frozen"] > 0
    np.testing.assert_array_equal(got, want)
