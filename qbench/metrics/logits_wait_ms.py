"""Host ms a batch that the serving engine waits for the logits: their copy
to the host, which waits for the device's work; the engine's ``wait_ns``
over the batches dispatched, in the window less the profiled slice
(``qbench.engine_stages``).  None where the engine keeps no timeline of its
stages."""
from qbench.engine_stages import ms_a_batch


def read(ctx):
    return ms_a_batch(ctx, "wait_ns")
