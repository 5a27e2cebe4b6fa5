"""The residual binary convs' least time at the cell's batch (``leasttime``:
the ``convs`` rows of the reference's ``layer_work``, bound by the float32
stream's bytes) over their device time a forward, in %: the kernel
launches alone, timed by the model itself with CUDA event pairs over the
forwards that ran while the profiler recorded (``BiRealResNet.counters()``:
``resconv_ms`` over ``timed_forwards``), from the engine started last.
None where the model keeps no such counters."""
from qbench.model_counters import per_timed_forward


def read(ctx):
    ms = per_timed_forward("resconv_ms")
    return 100.0 * ctx.least_s("convs") / (ms / 1e3) if ms else None
