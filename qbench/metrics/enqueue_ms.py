"""Host ms a batch of the serving engine's enqueue: the batch's copy to the
device, its normalisation and the forward's launches, until the forward
returns; the engine's ``enqueue_ns`` over the batches dispatched, in the
window less the profiled slice (``qbench.engine_stages``).  None where the
engine keeps no timeline of its stages."""
from qbench.engine_stages import ms_a_batch


def read(ctx):
    return ms_a_batch(ctx, "enqueue_ns")
