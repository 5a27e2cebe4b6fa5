"""Seconds from the process's start to the first timed request: imports,
the card's start-up, the weights, the converter, the kernels' library (a
build in a fresh checkout), the engine and its warm-up at the cell's one
static batch."""


def read(ctx):
    return ctx.setup_s
