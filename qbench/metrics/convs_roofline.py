"""The five hidden convs' least time at the cell's batch (``leasttime``:
binary or ternary products on the single-bit tensor cores, or their bytes)
over their device time a batch in the traced slice, in %."""


def read(ctx):
    ms = ctx.stage_ms.get("convs")
    return 100.0 * ctx.least_s("convs") / (ms / 1e3) if ms else None
