"""Integer issue-rate probe (torch port of the Pallas kernel of
``experiments/vpu_probe.py``, H): an elementwise chain of ``reps`` 32-bit
integer steps,

    acc = 0; repeat reps times { acc = step(acc, x, y); x = x + 1 }

with the six steps of :data:`MODES` (``vpu_probe.py:27-43``).  The JAX ops
wrap at 32 bits (``mul``, and ``x + 1`` at INT32_MAX), so the plain version,
:func:`int_chain_ref`, computes on the unsigned 32-bit patterns in int64 and
masks after every step; torch's int32 overflow on the CPU is not relied on.
:func:`int_chain` launches the CUDA kernel of ``csrc/int_probe.cu`` for a
CUDA tensor and runs the plain version only for a tensor on the CPU;
``int_chain.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from qnx_torch.ops.packing import popcount
from . import _build

#: the steps, in the order of the CUDA source's ``enum Mode``
MODES = ("xor", "add", "mul", "pc", "pconly", "csa")
#: chain lengths compiled into the CUDA source: one step, the JAX probe's
#: SHORT and LONG (32, 96), and 128 and 384, long enough that every mode's
#: issue outlasts its bytes
REPS = (1, 32, 96, 128, 384)

_MASK = 0xFFFFFFFF


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod 2^32 for unsigned 32-bit patterns in int64, in two 16-bit
    halves of b so no product leaves int64."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def int_chain_ref(x: torch.Tensor, y: torch.Tensor, mode: str,
                  reps: int) -> torch.Tensor:
    """Plain version of :func:`int_chain`, any ``reps`` >= 0."""
    if mode not in MODES:
        raise ValueError(f"int_chain: unknown mode {mode!r}; one of {MODES}")
    x = x.to(torch.int64) & _MASK
    y = y.to(torch.int64) & _MASK
    acc = torch.zeros_like(x)
    for _ in range(reps):
        if mode == "xor":
            acc = acc ^ (x ^ y)
        elif mode == "add":
            acc = (acc + (x ^ y)) & _MASK
        elif mode == "mul":
            acc = (_mul32(acc, x) + y) & _MASK
        elif mode == "pc":
            acc = (acc + popcount(x ^ y).to(torch.int64)) & _MASK
        elif mode == "pconly":
            acc = popcount(acc ^ x).to(torch.int64)
        else:  # csa
            a = x ^ acc
            acc = ((acc ^ a) ^ y) | (acc & a)
        x = (x + 1) & _MASK
    return torch.where(acc >= 2**31, acc - 2**32, acc).to(torch.int32)


def int_chain(x: torch.Tensor, y: torch.Tensor, mode: str, reps: int) -> torch.Tensor:
    """``reps`` chained steps of ``mode`` over int32 ``x`` and ``y`` of one
    shape -> int32 of that shape.  The kernel is compiled for ``reps`` in
    :data:`REPS`."""
    if mode not in MODES:
        raise ValueError(f"int_chain: unknown mode {mode!r}; one of {MODES}")
    if reps not in REPS:
        raise ValueError(f"int_chain: reps={reps} is not compiled in; one of {REPS}")
    if y.shape != x.shape:
        raise ValueError(f"int_chain: x {tuple(x.shape)} and y {tuple(y.shape)} "
                         f"differ in shape")
    if x.numel() >= 2**31:
        raise ValueError("int_chain: more than 2^31 - 1 elements")
    if not _build.check_operands("int_chain", x, y=y):
        return int_chain_ref(x, y, mode, reps)
    out = torch.empty_like(x)
    if out.numel():
        _build.launch("qnx_int_chain", x.device, x, y, out, x.numel(),
                      MODES.index(mode), reps)
        int_chain.launches += 1
    return out


int_chain.launches = 0
