"""Device ms a forward of the float downsampling shortcuts (avg pool, 1x1
conv, BatchNorm), timed by the model itself with CUDA event pairs over the
forwards that ran while the profiler recorded (``BiRealResNet.counters()``:
``shortcut_ms`` over ``timed_forwards``), from the engine started last.
None where the model keeps no such counters."""
from qbench.model_counters import per_timed_forward


def read(ctx):
    return per_timed_forward("shortcut_ms")
