"""Host ms a batch of the serving engine's resolve: from the logits on the
host to the last future set and the stats updated; the engine's
``resolve_ns`` over the batches dispatched, in the window less the profiled
slice (``qbench.engine_stages``).  None where the engine keeps no timeline
of its stages."""
from qbench.engine_stages import ms_a_batch


def read(ctx):
    return ms_a_batch(ctx, "resolve_ns")
