"""The one traffic generator: a mix is a file of parameters (``traffic/
<name>.json``) that this module turns, with the seed, into requests, and
drives through the engine's ``submit_many``.

A request is a chunk of uint8 images, a slice of the image pool at a start
drawn from the seed.  Its size is drawn log-uniform over ``[size_min,
size_max]``; the seed orders a fixed set of sizes, so every seed offers the
same work in another order.  The loop is closed: ``clients`` clients each
keep one request in flight, and a client sends its next request when its
last one is answered.  The engine answers in the order it was given work,
so the oldest request in flight is the next to be answered, and one thread
drives all the clients by waiting on it.  No client work runs on the
engine's dispatcher thread.

Whether a request's answers are checked against the reference is drawn
from the seed too (``check_share``).
"""
from __future__ import annotations

import math
import time
from collections import deque

import numpy as np

ANSWER_TIMEOUT_S = 60.0  # a request answered later than this has failed
SIZE_SET = 8192          # sizes in the fixed set the clients cycle through

# streams of the seed, one for each thing drawn
_SIZES, _STARTS, _CHECKS, _POOL = range(4)


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream])


def size_set(mix: dict, n: int) -> np.ndarray:
    """``n`` request sizes at the midpoint quantiles of the log-uniform
    distribution over the integers ``size_min`` .. ``size_max``."""
    lo, hi = mix["size_min"], mix["size_max"]
    p = (np.arange(n) + 0.5) / n
    sizes = np.floor(np.exp(math.log(lo) + (math.log(hi + 1) - math.log(lo)) * p))
    return np.clip(sizes, lo, hi).astype(np.int64)


def make_pool(mix: dict, shape, seed: int, device) -> np.ndarray:
    """The image pool: ``pool_images`` uint8 images of ``shape``, drawn on
    ``device`` from the seed."""
    import torch

    g = torch.Generator(device=device).manual_seed(int(rng(seed, _POOL).integers(2**62)))
    pool = torch.randint(0, 256, (mix["pool_images"], *shape), generator=g,
                         device=device, dtype=torch.uint8)
    return pool.cpu().numpy()


class Log:
    """The requests of a run, one row each, in arrays: ``size``, ``start``
    (in the pool), ``check`` (held against the reference), ``done`` (inf
    until answered) and ``ok``; and the futures of the checked requests
    that were answered (``answers``).
    Arrays and not an object a request, so that the window adds nothing
    for Python's cyclic collector to walk: its full collections already
    cost the serving engine most of its host time."""

    def __init__(self, mix: dict, pool_size: int, seed: int, n_set: int,
                 capacity: int = 1 << 14):
        self.mix, self.pool_size = mix, pool_size
        self._sizes = rng(seed, _SIZES)
        self._starts = rng(seed, _STARTS)
        self._checks = rng(seed, _CHECKS)
        self._set = size_set(mix, n_set)
        self._order = self._sizes.permutation(n_set)
        self.n = 0
        self.size = np.zeros(capacity, np.int64)
        self.start = np.zeros(capacity, np.int64)
        self.check = np.zeros(capacity, bool)
        self.done = np.full(capacity, math.inf)
        self.ok = np.zeros(capacity, bool)
        self.answers: dict = {}

    def add(self) -> int:
        """Draw the next request of the seed's stream; returns its row."""
        rid = self.n
        if rid == len(self.size):
            for name in ("size", "start", "check", "done", "ok"):
                old = getattr(self, name)
                new = np.full(2 * len(old), math.inf) if name == "done" else \
                    np.zeros(2 * len(old), old.dtype)
                new[:len(old)] = old
                setattr(self, name, new)
        k = rid % len(self._set)
        if k == 0 and rid:
            self._order = self._sizes.permutation(len(self._set))
        size = int(self._set[self._order[k]])
        self.size[rid] = size
        self.start[rid] = self._starts.integers(0, self.pool_size - size + 1)
        self.check[rid] = self._checks.random() < self.mix["check_share"]
        self.n += 1
        return rid

    def images(self, rid: int, pool: np.ndarray) -> np.ndarray:
        return pool[self.start[rid]:self.start[rid] + self.size[rid]]

    def rows(self) -> dict:
        """The used rows of each array."""
        return {name: getattr(self, name)[:self.n] for name in
                ("size", "start", "check", "done", "ok")}


def _wait(log: Log, rid: int, futs: list, deadline: float) -> None:
    """Wait, until ``deadline`` at the latest, for a request's last answer
    and stamp it."""
    try:
        futs[-1].result(timeout=max(0.0, deadline - time.perf_counter()))
        # a request no larger than the batch spans at most two batches, and a
        # batch fails whole: its first and last answers speak for all
        ok = futs[0].exception(timeout=0) is None
    except Exception:  # noqa: BLE001 - a failed request is counted, not raised
        return
    log.done[rid] = time.perf_counter()
    log.ok[rid] = ok
    if log.check[rid] and ok:
        log.answers[rid] = futs


def run_closed(engine, mix: dict, pool: np.ndarray, seed: int, seconds: float,
               on_close=None) -> tuple[Log, float, float]:
    """Drive the closed loop for ``seconds``, call ``on_close()`` when it
    first sees the window closed, then stop sending and wait for the
    requests in flight.  Returns (log, window start, window end)."""
    log = Log(mix, len(pool), seed, SIZE_SET)
    inflight: deque = deque()

    def send():
        rid = log.add()
        inflight.append((rid, engine.submit_many(log.images(rid, pool))))

    t0 = time.perf_counter()
    end = t0 + seconds
    for _ in range(mix["clients"]):
        send()
    while inflight:
        rid, futs = inflight.popleft()
        _wait(log, rid, futs, end + ANSWER_TIMEOUT_S)
        if time.perf_counter() < end:
            send()
        elif on_close is not None:
            on_close()
            on_close = None
    return log, t0, end
