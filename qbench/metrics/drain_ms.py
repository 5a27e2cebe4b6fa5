"""Host ms a batch of the serving engine's drain: from the last batch's
answers to the next host batch (queue waits, linger, concatenation and
padding), the engine's ``drain_ns`` over the batches dispatched, in the
window less the profiled slice (``qbench.engine_stages``).  None where the
engine keeps no timeline of its stages."""
from qbench.engine_stages import ms_a_batch


def read(ctx):
    return ms_a_batch(ctx, "drain_ns")
