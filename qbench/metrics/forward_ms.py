"""Device ms a forward over the traced slice: the kernels and copies that
start inside the model's four stage ranges, summed and divided by the
forwards (``trace.py``)."""


def read(ctx):
    return ctx.stage_ms.get("forward")
