"""Share of the traced slice with no device activity: 1 - busy / slice, in
%; busy is the union of the kernels' and copies' intervals in the
profiler's device events (or, where it gives none, the summed forward
spans of the CUDA events)."""


def read(ctx):
    d = ctx.device
    if not d or d["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
