"""qnx_torch — the PyTorch/CUDA port of :mod:`qnx` for NVIDIA Hopper.

The JAX package :mod:`qnx` is the reference; every module here mirrors its
counterpart's name and public layout (NHWC activations packed along C,
tap-major conv weights, int32 words) so the two can be compared on the same
inputs.  Importing this package imports neither jax nor triton and builds
no kernel: the CUDA kernels are compiled at their first launch
(:mod:`qnx_torch.kernels._build`).
"""
