"""Device ms a batch of the ``denses`` and ``head`` children together over
the traced slice."""


def read(ctx):
    return ctx.stage_ms.get("dense_head")
