"""Bi-Real Net-18 (Liu et al., ECCV 2018, arXiv:1808.00278) through the packed
XNOR engine: a float32 stream with a real-valued shortcut around every
binary conv.

    first   x = maxpool3x3/2(BN(conv7x7/2(images)))          float, cuDNN
    convs   16 x: x = BN(alpha * conv3x3/s(sign(x), sign(W))) + shortcut(x)
            shortcut(x) = x at stride 1, BN(conv1x1(avgpool2x2/2(x))) at 2
    denses  the global average pool
    head    fc, with a bias                                   float, cuBLAS

Each binary conv is one launch of kernel A with its residual epilogue
(:func:`qnx_torch.kernels.xnor_conv_fused.xnor_conv_residual`), which reads
the stream's sign bits and the residual and writes the next stream and its
sign bits.  The float layers run with TF32 off (``_ieee_f32``).  Activations
are NHWC; the sign of 0 is +1 (``x >= 0``), where ``torch.sign(0)`` is 0.

:class:`BiRealResNet` counts its forwards, images and calls, and while a
torch profiler records it times its parts on the device with CUDA event
pairs (host-clock marks on the CPU), read by :meth:`BiRealResNet.counters`.
NVTX ranges ``qnx.bireal.stem``, ``qnx.bireal.conv<i>`` and
``qnx.bireal.shortcut<i>`` (i the conv's index, 0-15) and
``qnx.bireal.head`` name the parts on the card for ``nsys``; none is a
profiler range, so no device event bears their names.
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch
import torch.nn.functional as F
from torch import nn

from qnx_torch.kernels.xnor_conv_fused import xnor_conv_residual
from qnx_torch.nn.inference import _ieee_f32
from qnx_torch.ops.packing import pack_bits
from qnx_torch.utils import profiling

PARTS = ("stem", "resconv", "shortcut", "pool_head")


class _HostMark:
    """A CPU run's stand-in for a CUDA event: the host clock."""

    def __init__(self):
        self.t = time.perf_counter()

    def synchronize(self) -> None:
        pass

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


class PartClock:
    """The model's counters, and the device ms of its parts over the timed
    forwards: a pair of CUDA events (host marks on the CPU) around each part
    of each timed forward, resolved when :meth:`counters` reads them."""

    def __init__(self):
        self.timing = False  # the running forward is timed
        self.count = dict.fromkeys(("forwards", "images", "timed_forwards",
                                    "resconv_stride1", "resconv_stride2",
                                    "shortcut_calls"), 0)
        self.ms = dict.fromkeys(PARTS, 0.0)
        self._pending: list = []  # (part, start, end) not yet resolved
        self._lock = threading.Lock()

    @staticmethod
    def _mark(cuda: bool):
        if not cuda:
            return _HostMark()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    @contextlib.contextmanager
    def part(self, part: str, nvtx: str, cuda: bool):
        """Time ``part`` inside a timed forward, in the NVTX range ``nvtx``
        on the card."""
        if cuda:
            torch.cuda.nvtx.range_push(nvtx)
        start = self._mark(cuda) if self.timing else None
        try:
            yield
        finally:
            if start is not None:
                end = self._mark(cuda)
                with self._lock:
                    self._pending.append((part, start, end))
            if cuda:
                torch.cuda.nvtx.range_pop()

    def counters(self) -> dict:
        """The counts, and ``<part>_ms`` summed over the timed forwards;
        waits for the device to reach the last timed part."""
        with self._lock:
            pending, self._pending = self._pending, []
        for part, start, end in pending:
            end.synchronize()
            self.ms[part] += start.elapsed_time(end)
        return {**self.count, **{f"{p}_ms": v for p, v in self.ms.items()}}


class BiRealStem(nn.Module):
    """The float stem: conv 7x7/2 pad 3 (TF32 off), the BatchNorm folded to
    ``y * scale + shift``, max pool 3x3/2 pad 1 -> the float32 NHWC stream
    and its sign bits."""

    def __init__(self, w, scale, shift):
        super().__init__()
        self.register_buffer("w", w)          # (C, 3, 7, 7) f32, OIHW
        self.register_buffer("scale", scale)  # (C,) f32
        self.register_buffer("shift", shift)

    def forward(self, images: torch.Tensor):
        with _ieee_f32():
            y = F.conv2d(images.permute(0, 3, 1, 2), self.w, stride=2, padding=3)
        y = y.permute(0, 2, 3, 1) * self.scale
        y = y + self.shift
        x = F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        x = x.contiguous()
        return x, pack_bits(x >= 0)


class DownsampleShortcut(nn.Module):
    """The float shortcut of a stride-2 conv: avg pool 2x2/2, conv 1x1 (TF32
    off), the BatchNorm folded to ``y * scale + shift``; NHWC in and out."""

    def __init__(self, w, scale, shift):
        super().__init__()
        self.register_buffer("w", w)          # (N, C, 1, 1) f32, OIHW
        self.register_buffer("scale", scale)  # (N,) f32
        self.register_buffer("shift", shift)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.avg_pool2d(x.permute(0, 3, 1, 2), 2)
        with _ieee_f32():
            y = F.conv2d(y, self.w)
        y = y.permute(0, 2, 3, 1) * self.scale
        return (y + self.shift).contiguous()


class ResidualBinaryConv(nn.Module):
    """One binary conv of the stream, in one kernel launch: s = the exact
    3x3 conv (pad 1, stride 1 or 2) of the stream's sign bits with sign(W),
    x_new = (s * scale + shift) + residual, and x_new's sign bits
    (``xnor_conv_residual``; ``scale`` holds alpha = mean|W| times the
    BatchNorm's).  The residual is the stream at stride 1 and ``shortcut``
    of it at stride 2, computed before the launch."""

    def __init__(self, wp, corr, scale, shift, k: int, stride: int,
                 shortcut: DownsampleShortcut | None = None, index: int = 0):
        super().__init__()
        self.register_buffer("wp", wp)        # (9*Cw, N) int32
        self.register_buffer("corr", corr)    # (H', W', N) int32
        self.register_buffer("scale", scale)  # (N,) f32
        self.register_buffer("shift", shift)
        self.k = k
        self.stride = stride
        self.shortcut = shortcut
        self.index = index
        self.clock = PartClock()  # the model's, once a BiRealResNet holds it

    def forward(self, x: torch.Tensor, bits: torch.Tensor):
        cuda, clock = x.is_cuda, self.clock
        r = x
        if self.shortcut is not None:
            with clock.part("shortcut", f"qnx.bireal.shortcut{self.index}", cuda):
                r = self.shortcut(x)
            clock.count["shortcut_calls"] += 1
        with clock.part("resconv", f"qnx.bireal.conv{self.index}", cuda):
            out = xnor_conv_residual(bits, self.wp, self.k, self.corr, self.scale,
                                     self.shift, r, self.stride)
        clock.count[f"resconv_stride{self.stride}"] += 1
        return out


class GlobalAvgPool(nn.Module):
    """The global average pool, NHWC -> (B, C).  It is the model's only
    ``denses`` child: the benchmark's ``denses`` stage is this pool."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(1, 2))


class FloatLinearHead(nn.Module):
    """The float head: ``x @ w.T`` (TF32 off) + bias, no BatchNorm."""

    def __init__(self, w, bias):
        super().__init__()
        self.register_buffer("w", w)        # (classes, K) f32
        self.register_buffer("bias", bias)  # (classes,) f32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with _ieee_f32():
            y = x @ self.w.t()
        return y + self.bias


class BiRealResNet(nn.Module):
    """Bi-Real Net: ``first`` (the stem), ``convs`` (the residual binary
    convs), ``denses`` (the global average pool) and ``head`` (the fc).

    :meth:`counters`, always on: ``forwards``, ``images``, the residual
    convs' calls (kernel launches on the card) by stride
    (``resconv_stride1``, ``resconv_stride2``), ``shortcut_calls``; and
    ``stem_ms``, ``resconv_ms`` (the kernel launches alone), ``shortcut_ms``
    and ``pool_head_ms``, device ms summed over the ``timed_forwards``: the
    forwards that ran while a torch profiler recorded, but the model's
    first, whose spans would hold the kernels' first loading on the host."""

    def __init__(self, first: BiRealStem, convs, pool: GlobalAvgPool,
                 head: FloatLinearHead):
        super().__init__()
        self.clock = PartClock()
        self.first = first
        self.convs = nn.ModuleList(convs)
        for conv in self.convs:
            conv.clock = self.clock
        self.denses = nn.ModuleList([pool])
        self.head = head

    def counters(self) -> dict:
        return self.clock.counters()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        clock, cuda = self.clock, images.is_cuda
        clock.timing = clock.count["forwards"] > 0 and profiling.recording()
        clock.count["forwards"] += 1
        clock.count["images"] += images.shape[0]
        clock.count["timed_forwards"] += clock.timing
        with clock.part("stem", "qnx.bireal.stem", cuda):
            x, bits = self.first(images)
        for conv in self.convs:
            x, bits = conv(x, bits)
        with clock.part("pool_head", "qnx.bireal.head", cuda):
            for layer in self.denses:
                x = layer(x)
            return self.head(x)
