"""Host ms a batch outside the engine's timed batch work: (the seconds
elapsed - the growth of ``ServeStats.total_batch_ms``) over the batches
dispatched, read from the engine's stats at the window's two ends, less
the profiled slice (``Context.untraced``).  ``total_batch_ms`` times each
batch from its dispatch to the logits on the host; the rest is draining
the queue, concatenating and padding, and resolving the futures."""


def read(ctx):
    d = ctx.untraced()
    if not d or d["batches"] <= 0:
        return None
    return (d["clock"] - d["total_batch_ms"] / 1e3) / d["batches"] * 1e3
