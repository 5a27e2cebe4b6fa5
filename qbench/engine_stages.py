"""The serving engine's own stage and pause ns over a run's untraced
stretch, for the readers ``metrics/{drain,enqueue,logits_wait,resolve,
gc_pause}_ms.py``.

The run reads the engine's ``ServeStats`` at the window's ends and at the
profiled slice's edges (``Context.counters``, ``Context.slice_counters``);
the stretches are those that ``Context.untraced`` leaves, between those
readings' clocks.  The ns come from the timeline of the engine the process
started last (``qnx_torch.serve.engine.last_started`` and
``ServeEngine.between``), clipped to the stretches, and are divided by the
batches ``Context.untraced`` counts.  A program without that timeline gives
None, and the metric is left out of the line."""
from __future__ import annotations


def stretches(ctx) -> list[tuple[float, float]] | None:
    """The ``(since, until)`` clocks of the window less the profiled slice,
    as ``Context.untraced`` takes them; None where it gives None."""
    if not ctx.counters:
        return None
    (a, b), cut = ctx.counters, ctx.slice_counters
    if cut is None:
        return [(a["clock"], b["clock"])]
    if not a["clock"] < cut[0]["clock"] <= b["clock"]:
        return None
    if cut[1]["clock"] > b["clock"]:
        return [(a["clock"], cut[0]["clock"])]
    return [(a["clock"], cut[0]["clock"]), (cut[1]["clock"], b["clock"])]


def engine():
    """The engine the process started last, or None (none lives, or the
    program keeps no timeline)."""
    from qnx_torch.serve import engine as serve

    last = getattr(serve, "last_started", None)
    found = last() if last is not None else None
    return found if hasattr(found, "between") else None


def ms_a_batch(ctx, counter: str) -> float | None:
    """Ms a batch of the engine's ``counter`` (``drain_ns``, ``enqueue_ns``,
    ``wait_ns``, ``resolve_ns`` or ``gc_ns``) over the untraced stretch."""
    d, spans = ctx.untraced(), stretches(ctx)
    if not d or not spans or d["batches"] <= 0:
        return None
    eng = engine()
    if eng is None:
        return None
    total = 0
    for since, until in spans:
        got = eng.between(since, until)
        if got is None:
            return None
        total += got[counter]
    return total / d["batches"] / 1e6
