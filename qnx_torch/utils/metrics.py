"""Structured JSONL metrics (torch port of :mod:`qnx.utils.metrics`):
images/s, step time, accuracy, one JSON object per line, greppable and
machine-readable.  The reference has only Keras progress bars.

A copy of the JAX package's numpy-only module, so the port runs without
it; ``tests/test_torch_train_cli.py`` holds the two equal.  ``_jsonable``
takes 0-d tensors as it takes numpy scalars (``.item()``) and n-d tensors
as arrays (``.tolist()``)."""
from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    """Append-only JSONL logger with wall-clock stamps."""

    def __init__(self, path: str | None):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")
        else:
            self._f = None
        self._t0 = time.time()

    def log(self, **fields):
        rec = {"t": round(time.time() - self._t0, 3), **_jsonable(fields)}
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        return rec

    def close(self):
        if self._f:
            self._f.close()


def _jsonable(obj):
    """Best-effort conversion of numpy/torch scalars and nested containers."""
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if hasattr(obj, "item") and getattr(obj, "ndim", 1) == 0:
        return obj.item()
    if hasattr(obj, "tolist"):
        return obj.tolist()
    return obj
