"""Readings of the served model's own counters: ``counters()`` of the model
of the engine the process started last (``qnx_torch.serve.engine.
last_started``), where the model has it."""
from __future__ import annotations


def model_counters() -> dict | None:
    """The served model's counters, or None where it keeps none."""
    from qnx_torch.serve import engine as serve

    eng = serve.last_started()
    counters = getattr(getattr(eng, "model", None), "counters", None)
    return counters() if callable(counters) else None


def per_timed_forward(key: str) -> float | None:
    """Counter ``key`` over the timed forwards, or None where there is none
    or no forward was timed."""
    c = model_counters()
    if not c or not c.get("timed_forwards") or key not in c:
        return None
    return c[key] / c["timed_forwards"]
