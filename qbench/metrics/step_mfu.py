"""The least time of the images the engine served (``leasttime`` at the
cell's batch, every layer held to the fastest unit that computes it
exactly) over the seconds they took, in %: the window less the profiled
slice, from the engine's counters (``Context.untraced``).  It is the
served rate held against the card's peak, so it moves with ``serve_ips``
and bounds what any kernel's roofline share can give end to end."""


def read(ctx):
    d = ctx.untraced()
    if not d or d["images"] <= 0 or d["clock"] <= 0:
        return None
    return 100.0 * d["images"] * ctx.least_image_s / d["clock"]
