"""The serving engine's two batches in flight: batch k is formed and
launched before batch k-1 is answered.  On the CPU, where the forward is
synchronous, that is an order only: the answers stay one ``predict``'s, bit
for bit, no answer waits on an empty queue, ``stop()`` and a failing forward
leave no future unresolved, ``overlapped`` counts the batches launched with
another in flight, and the stages still divide the dispatcher's time.  On a
card (tests marked ``card``, which skip without one) the page-locked
staging buffers, the copy stream and the logits' copies are held to the
same answers; there, from the repository's root:

    python -m pytest --noconftest tests/test_torch_serve_pipeline.py -q
"""
import statistics
import sys
import threading
import time

import numpy as np
import pytest
import torch

from qnx_torch.convert.pack_model import pack_vgg_bitplane
from qnx_torch.models.factory import init_variables
from qnx_torch.serve import routes
from qnx_torch.serve.engine import ServeEngine, normalize_u8
from qnx_torch.utils.config import Config

torch.set_num_threads(2)

STAGES = ("drain_ns", "enqueue_ns", "wait_ns", "resolve_ns")
# the benchmark's bit-plane path at small widths
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


def _u8(n, seed, shape=(4, 4, 1)):
    return np.random.RandomState(seed).randint(0, 256, (n, *shape), np.uint8)


def _want(model, images):
    with torch.inference_mode():
        return model(normalize_u8(torch.from_numpy(images))).numpy()


def _results(futs, timeout=60):
    return np.stack([f.result(timeout=timeout) for f in futs])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def tnn():
    return pack_vgg_bitplane(init_variables(TNN_CF, seed=7), TNN_CF, device="cpu")


# ---------------- on the CPU ----------------

def test_answers_are_one_predicts_bit_for_bit(tnn):
    """Chunks queued before the start, split over batches that are in
    flight two at a time, answer as one ``predict`` of all the images and
    as the model's own forward."""
    sizes = (3, 6, 5, 1, 7, 2, 4, 9, 3, 8)
    images = _u8(sum(sizes), 1, shape=(32, 32, 3))
    chunks = np.split(images, np.cumsum(sizes)[:-1])
    engine = ServeEngine(tnn, batch_size=4, max_wait_ms=50.0)
    futs = [f for c in chunks for f in engine.submit_many(c)]
    with engine:
        got = _results(futs)
        assert engine.counters()["overlapped"] >= 8
    with ServeEngine(tnn, batch_size=len(images), max_wait_ms=50.0) as one:
        whole = one.predict(images)
        assert one.counters()["batches"] == 1
    np.testing.assert_array_equal(got, whole)
    np.testing.assert_array_equal(got, _want(tnn, images))


def test_a_lone_request_on_an_idle_engine_is_answered_at_once():
    """The dispatcher answers the batch in flight before it blocks on the
    empty queue, well within its 0.1 s wait there."""
    engine = ServeEngine(Toy(), batch_size=4, max_wait_ms=1.0)
    took = []
    with engine:
        engine.predict(_u8(4, 0))
        for k in range(5):
            time.sleep(0.15)  # idle: the dispatcher waits on the queue
            t = time.perf_counter()
            got = engine.submit(_u8(1, k)[0]).result(timeout=10)
            took.append(time.perf_counter() - t)
            np.testing.assert_array_equal(got, _want(Toy(), _u8(1, k))[0])
        assert engine.counters()["overlapped"] == 0
    assert statistics.median(took) < 0.05


def test_stop_with_a_batch_in_flight_resolves_every_future():
    """``stop()`` while batches are in flight: the one launched is answered,
    the queued ones cancelled; no future is left pending."""
    def forward(m, x):
        time.sleep(0.02)
        return m(x)

    images = _u8(200, 2)
    engine = ServeEngine(Toy(), batch_size=4, max_wait_ms=50.0, forward=forward)
    futs = [f for c in np.split(images, 50) for f in engine.submit_many(c)]
    engine.start()
    futs[10].result(timeout=30)  # a few batches in
    engine.stop()
    assert all(f.done() for f in futs)
    answered = [i for i, f in enumerate(futs) if not f.cancelled()]
    assert len(answered) == engine.counters()["images"] >= 12
    launched = [k for k, *_ in engine._stats.timeline if k == "enqueue_ns"]
    waited = [k for k, *_ in engine._stats.timeline if k == "wait_ns"]
    assert len(launched) == len(waited) == engine.counters()["batches"]
    assert answered == list(range(len(answered)))  # in order, nothing skipped
    np.testing.assert_array_equal(_results([futs[i] for i in answered]),
                                  _want(Toy(), images[:len(answered)]))
    assert engine._inflight is None


def test_a_forward_that_raises_fails_its_batch_alone():
    """Batch 2's forward raises: its four futures carry the error, every
    other image is answered, batches before and after it too.  Batch 1,
    in flight, is answered before batch 3 forms, which on a card would
    take its staging slot."""
    def forward(m, x):
        forward.calls += 1
        if forward.calls == 3:
            raise RuntimeError("batch 2 fails")
        return m(x)
    forward.calls = 0

    images = _u8(24, 3)
    sizes = (3, 6, 5, 2, 4, 4)  # consecutive batches of four images
    engine = ServeEngine(Toy(), batch_size=4, max_wait_ms=50.0, forward=forward)
    futs = [f for c in np.split(images, np.cumsum(sizes)[:-1])
            for f in engine.submit_many(c)]
    with engine:
        for f in futs:
            f.exception(timeout=30)
    failed = [i for i, f in enumerate(futs) if f.exception() is not None]
    assert failed == [8, 9, 10, 11]
    assert "batch 2 fails" in str(futs[8].exception())
    ok = [i for i in range(len(futs)) if i not in failed]
    np.testing.assert_array_equal(_results([futs[i] for i in ok]),
                                  _want(Toy(), images[ok]))
    assert engine.counters()["batches"] == 5
    assert engine.counters()["overlapped"] == 3  # batches 1, 4 and 5


def test_overlapped_counts_batches_launched_with_another_in_flight():
    """Full batches queued before the start: all but the first launch with
    one in flight.  Requests one at a time: none does."""
    engine = ServeEngine(Toy(), batch_size=4, max_wait_ms=50.0)
    futs = [f for k in range(6) for f in engine.submit_many(_u8(4, k))]
    with engine:
        _results(futs)
        c = engine.counters()
    assert (c["batches"], c["overlapped"]) == (6, 5)

    engine = ServeEngine(Toy(), batch_size=4, max_wait_ms=1.0)
    with engine:
        for k in range(6):
            engine.predict(_u8(1 + k % 4, k))
        c = engine.counters()
    assert (c["batches"], c["overlapped"]) == (6, 0)


def _closed_loop(engine):
    """A client that sends its next request once its first is answered,
    beside one already queued: requests of 4, then 2, then 2 images at a
    batch of 4.  Returns the futures, the first request's last."""
    first, second = engine.submit_many(_u8(4, 0)), engine.submit_many(_u8(2, 1))
    later = []

    def client():
        first[-1].result(timeout=30)
        later.extend(engine.submit_many(_u8(2, 2)))

    t = threading.Thread(target=client)
    with engine:
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        got = _results(first + second + later)
    np.testing.assert_array_equal(got, _want(Toy(), np.concatenate(
        [_u8(4, 0), _u8(2, 1), _u8(2, 2)])))
    return engine.counters()


def test_a_batch_whose_logits_are_on_the_host_is_answered_while_the_next_lingers():
    """The second batch lingers on the empty queue with the first in flight,
    its logits on the host (a forward on the CPU): the first is answered,
    its client sends again, and the second batch fills, unpadded."""
    c = _closed_loop(ServeEngine(Toy(), batch_size=4, max_wait_ms=200.0))
    assert (c["batches"], c["padded"], c["overlapped"]) == (2, 0, 0)


def test_the_stages_add_up_between_two_readings_under_load():
    """Clients keep requests queued, so batches overlap; between two
    ``counters()`` readings the four stages add up to the time between
    them."""
    def forward(m, x):
        time.sleep(0.005)
        return m(x)

    engine = ServeEngine(Toy(), batch_size=8, max_wait_ms=1.0, forward=forward)
    stop = threading.Event()

    def client(k):
        while not stop.is_set():
            engine.submit_many(_u8(1 + k % 7, k))[-1].result(timeout=30)

    with engine:
        threads = [threading.Thread(target=client, args=(k,)) for k in range(6)]
        for t in threads:
            t.start()
        try:
            time.sleep(0.1)
            t1, a = time.perf_counter_ns(), engine.counters()
            time.sleep(0.3)
            t2, b = time.perf_counter_ns(), engine.counters()
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    assert sum(b[s] - a[s] for s in STAGES) == pytest.approx(t2 - t1, rel=0.05)


def test_many_clients_under_a_short_switch_interval_get_their_own_answers():
    """More client threads than cores and a short switch interval: every
    request is answered with its own images' logits, and the counters
    count each image and request once."""
    engine = ServeEngine(Toy(), batch_size=16, max_wait_ms=1.0)
    sizes = [1 + (7 * i) % 23 for i in range(400)]
    errors = []

    def client(k):
        for i in range(k, len(sizes), 12):
            images = _u8(sizes[i], i)
            got = _results(engine.submit_many(images), timeout=30)
            if not np.array_equal(got, _want(Toy(), images)):
                errors.append(i)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with engine:
            threads = [threading.Thread(target=client, args=(k,)) for k in range(12)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert errors == []
    c = engine.counters()
    assert (c["requests"], c["images"]) == (len(sizes), sum(sizes))


# ---------------- on a card ----------------

def _card_toy(card):
    return Toy().to(card)


def _card_want(images):
    return _want(Toy(), images)


@pytest.mark.card
def test_staging_buffers_are_page_locked_and_two(card, monkeypatch):
    made = []

    def pinned(shape, dtype):
        made.append(real(shape, dtype))
        return made[-1]

    real = routes._pinned
    monkeypatch.setattr(routes, "_pinned", pinned)
    images = _u8(37 * 20, 4, shape=(32, 32, 3))
    sizes = [37] * 20
    engine = ServeEngine(_card_toy(card), batch_size=64, max_wait_ms=50.0)
    futs = [f for c in np.split(images, np.cumsum(sizes)[:-1])
            for f in engine.submit_many(c)]
    with engine:
        got = _results(futs)
        assert engine.counters()["overlapped"] >= 10
    assert len(made) == 2
    assert all(torch.from_numpy(a).is_pinned() for a in made)
    np.testing.assert_array_equal(got, _card_want(images))


@pytest.mark.card
def test_answers_stay_after_many_later_batches(card):
    """The first batches' answers, read after a hundred later batches, are
    still theirs: no result is a view of memory a later batch writes."""
    images = _u8(64 * 100, 5, shape=(32, 32, 3))
    engine = ServeEngine(_card_toy(card), batch_size=64, max_wait_ms=50.0)
    futs = [f for c in np.split(images, 160) for f in engine.submit_many(c)]
    with engine:
        for f in futs:
            f.result(timeout=60)
    first = _results(futs[:256])
    np.testing.assert_array_equal(first, _card_want(images[:256]))
    np.testing.assert_array_equal(_results(futs), _card_want(images))


@pytest.mark.card
def test_a_batch_in_flight_is_answered_early_only_once_its_logits_are_back(card):
    """As on the CPU, with a forward that waits for the device inside (the
    second batch fills from the answered client); with a device still busy
    when the linger ends, the second batch launches padded, overlapped."""
    def synced(m, x):
        out = m(x)
        torch.cuda.synchronize()
        return out

    def busy(m, x):
        torch.cuda._sleep(2_000_000_000)  # ~1 s at the card's clock
        return m(x)

    c = _closed_loop(ServeEngine(_card_toy(card), batch_size=4, max_wait_ms=200.0,
                                 forward=synced))
    assert (c["batches"], c["padded"], c["overlapped"]) == (2, 0, 0)
    c = _closed_loop(ServeEngine(_card_toy(card), batch_size=4, max_wait_ms=50.0,
                                 forward=busy))
    assert (c["batches"], c["padded"]) == (3, 4) and c["overlapped"] >= 1


@pytest.mark.card
def test_a_slow_forward_never_reads_a_refilled_buffer(card):
    """The device sleeps before each forward, so the host runs ahead of it;
    the logits are still the serial engine's, batch by batch."""
    def forward(m, x):
        torch.cuda._sleep(20_000_000)  # ~10 ms at the card's clock
        return m(x)

    model = _card_toy(card)
    images = _u8(64 * 30, 6, shape=(32, 32, 3))
    engine = ServeEngine(model, batch_size=64, max_wait_ms=50.0, forward=forward)
    futs = [f for c in np.split(images, 48) for f in engine.submit_many(c)]
    with engine:
        got = _results(futs)
        assert engine.counters()["overlapped"] >= 25
    with torch.inference_mode():
        serial = np.concatenate([
            model(normalize_u8(torch.from_numpy(b).to(card))).cpu().numpy()
            for b in np.split(images, 30)])
    np.testing.assert_array_equal(got, serial)
