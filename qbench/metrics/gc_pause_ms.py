"""Ms a batch that Python's cyclic collector paused the serving process,
on any thread: the engine's ``gc_ns`` (timed through ``gc.callbacks``)
over the batches dispatched, in the window less the profiled slice
(``qbench.engine_stages``).  The pauses overlap the engine's four stages.
None where the engine keeps no timeline of its pauses."""
from qbench.engine_stages import ms_a_batch


def read(ctx):
    return ms_a_batch(ctx, "gc_ns")
