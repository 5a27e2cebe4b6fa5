"""Device ms a batch of the model's ``first`` child (the float first conv,
BatchNorm and the encode into codes or planes) over the traced slice."""


def read(ctx):
    return ctx.stage_ms.get("first")
