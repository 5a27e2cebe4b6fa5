#!/usr/bin/env python3
"""Bring-up check of the qnx_torch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's served paths through the hand-written CUDA kernels in
``qnx_torch/kernels/csrc/``, which it builds from source first:

* the full-width ``cifar10-bnn`` packed VGG (width 128, dense 1024);
* the full-width ``mnist-bnn`` and ``mnist-tnn`` packed MLPs (3 layers of
  4096, 10 classes);
* the int8 engine (``pack_int8``) of ``cifar10-bnn`` (pm1 codes),
  ``cifar10-tnn`` (level codes, abits 2) and ``mnist-bnn``: every hidden
  conv through kernel E, the dense layers through ``torch._int_mm``;
* ``cifar10-tnn`` through the bit-plane engine (``pack_vgg_bitplane``,
  ``PlaneVGG``): one {0,1} plane and one threshold per channel at its abits
  2, and two planes, three thresholds and the integer head at abits 3, every
  plane conv and dense layer through kernel D (on the int8 tensor cores,
  ``expand_mma_conv.cu``, ``expand_mma_dense.cu``) and the head through
  ``popcount_head.cu`` (as the MLPs' heads: a warp a row, the affine fused);
* ``cifar10-tnn`` at abits 1, the ternary packed VGG (``pack_vgg``): every
  hidden conv and dense layer through the ternary branch of kernel A (A';
  the convs on the int8 tensor cores, ``expand_mma_conv.cu``);
* the other activations and the wbits > 1 network types: through the int8
  engine, ``cifar10-bnn`` with binary_sigmoid (``zo`` codes {0, 1}),
  ``cifar10-tnn`` with quantized_tanh (signed ``tanh`` codes {-1, 0, 1})
  and as ``full-qnn`` with 4-bit grid weights (level codes), every hidden
  conv through kernel E; ``cifar10-bnn`` as the relu network type ``qnn``
  with 4-bit weights (``I8WConv``, ``I8WDense``, ``I8WHead``: dequantized
  weights on cuDNN and cuBLAS, TF32 off, no kernel of the repo); and
  ``cifar10-tnn`` with quantized_tanh through the bit-plane engine (two
  planes of unsigned indices, every conv through kernel D with its border
  term ``corr``, the dense layers through D),

each with random weights from seed 0, built on the card by the converters'
default and served by ``qnx_torch.serve.ServeEngine``; and the measurement
path, ``python -m qnx_torch.experiments.{gemm_shootout, xnor_sol_variants,
vpu_probe}`` and ``python -m qnx_torch.bench.roofline``, through the
popcount-GEMM formulations F1-F4 and G, kernels B and C at wide N and the
integer probe H; and the CLI, ``python3 -m qnx_torch serve`` over artifacts
of both engines (``int8`` and ``packed`` ``cifar10-bnn``, ``packed``
``cifar10-tnn``, ``mnist-bnn`` and ``mnist-tnn``), with the native host
runtime (``qnx_torch.native``) that normalises uint8 requests on the host.
Phases:

1. device: the card, torch, CUDA and nvcc versions;
2. build: compile the kernels, with the ptxas register and spill report
   and the SASS counts per K step of the tensor-core kernels' K loops (the
   A, A', D and E convs and the A, A' and D dense layers: IGMMA, POPC,
   LOP3, LDGSTS, ...); each must issue IGMMA and no POPC or IMMA there;
3. kernels: each of the eighteen kernels against its plain PyTorch version
   on the card at its paths' layer shapes (batch 32, and 256 for the MLPs,
   kernel E, A' conv and D), the packed GEMMs at 1024x4096x4096, ragged
   cases and any N (8, 48, 1, 10, 33, 130); the three integer heads' int32
   s and logits (exactly equal) at the MLPs' and the abits-3 VGG's head
   shapes, D's head with 1, 2, 3 and 8 planes, and on the ragged shapes of
   F1-F4 (M = 1, 3, 37, 130, 257; K % 32 != 0; N = 1, 10, 33, 128), nnz off
   the mask's count, msign bits outside the mask; the A, A' and D dense layers
   also at M = 1, 17, 100, 300, Kw % 4 != 0, N = 1, 10, 33, 130 and each
   split of a tile's K the wrappers pick (1, 2, 4 and 8 blocks, all
   required); kernel E in the pm1 encoding
   and the levels encoding with 1, 3 and 20 thresholds (more than the 15
   it stages in shared memory), in the zo encoding and the tanh encoding
   with 2, 6 and 254 thresholds (signed codes down to -127), on grid
   weights of 4 and 8 bits (-128 included), C not a multiple of 16 or 128
   (6, 8, 20, 40, 96); D with 1 to 8 planes and 1 to 255 thresholds, mixed
   threshold directions and int32-extreme thresholds, and with the border
   term at 2, 3 and 8 planes (2, 6 and 254 thresholds); A, A' and D's
   convs with C not a multiple of 128 (40, 96, 160);
   F1-F4 and G at every geometry the shootout sweeps on ragged M and K
   with N = 1, 10, 33, 128, the MNIST head and 1024x4096x4096 (a geometry
   that does not fit is logged as such); H in each mode and compiled
   length with the int32 extremes in both operands: packed words, planes,
   int32 s and int8 codes must be equal;
4. slice: for each path, 600 uint8 requests through the engine; every
   request answered, each layer's words or codes and each integer head's
   int32 s and logits equal to the plain path's, every hidden layer's codes
   or levels taking two values or more (the tanh paths' three at abits 2),
   the logits also to the JAX package's committed golden logits, and each
   kernel's launch count equal to layers x batches (counts set to 0 just
   before each path and read just after); the relu path's logits against
   a float64 run of the same layers and the golden within its own
   tolerance;
5. cli: the native host runtime must build (g++); five full-width
   artifacts made by the CLI's ``_pack_for_engine`` (buffers equal to the
   slices' models) and written by ``convert``'s writer, each served by
   ``python3 -m qnx_torch serve`` (2048 requests, 8 batches of 256) in a
   process of its own, with every request answered and its kernel launches
   equal to layers x batches; the loaded artifact's logits on the golden
   images equal to the in-memory module's; 512 requests through the engine
   with ``device_normalize=False`` (normalised on the host by the native
   runtime), in a batch mixing uint8 and float32 chunks, and pre-normalised,
   each equal to the device's normalisation bit for bit; where h5py is
   installed, ``python3 -m qnx_torch convert --h5`` of the full-width
   ``cifar10-bnn`` into both engines, every buffer equal to a direct
   ``pack_int8`` and ``pack_vgg`` (else a line says it was not run);
6. measure: the measurement path at reduced repeats (8 x 3), counts set to
   0 just before and read just after: the shootout at its four full shapes
   with every candidate equal to kernel B, the accumulator scan, the probe's
   six modes with the SM clock and SASS counts, the roofline table; each of
   F1-F4, G, H and B and C (at wide N) must have launched;
7. times: each kernel against its plain version and against one library
   call (``torch._int_mm`` on the same product, unpacked to int8) at batch
   256 (the packed GEMMs and the formulations at 1024x4096x4096, H at the
   JAX probe's 4096x1024; kernel E on K-major weights made beforehand, as
   ``I8Conv`` holds them, so its row is the kernel alone), each path's
   forward, and the int8 VGG against the strict-f32 float twin at batch
   256 and 1024, with CUDA events, and the relu ``qnn`` VGG against the
   same twin in the same turns; E in each served encoding (pm1, levels,
   zo, tanh, grid weights) and D's conv with the border term and without;
   the dense kernels, the integer heads
   and their library calls also as CUDA graph replays, which leave out the
   host's launch;
8. stages: each stage of the batch-256 VGG, ``mnist-bnn``, int8 VGG and
   bit-plane VGG forwards alone, their peak memory, and the engine's
   throughput over 40 queued batches, of those paths and of the five paths
   of the other activations and network types.

Any failure raises (non-zero exit).  The last lines are a JSON summary of
the kernels, the card's ``name, power.limit``, and the result object.

    python3 chip_smoke.py --ab KINDS DIR [DIR ...]

times kernels in several checkouts of the repo instead, in turns on one
card: for each DIR (a checkout, such as a parent commit unpacked with
``git archive`` into the ignored ``archive_check/``) one process that
imports that checkout's ``qnx_torch``, builds its kernels and times each
kind of KINDS (comma-separated :func:`make_case` kinds: ``conv`` for A's
binary conv, ``ternary_conv`` for the A' conv, ``plane_conv-P-T`` for D (``plane_conv-P-T-corr`` with the border
term), ``i8conv-ENC`` for E in encoding ENC of :data:`I8_ENCODINGS`
(``i8conv-ENC-wB`` on B-bit grid weights), at the five VGG conv shapes; ``dense``,
``ternary_dense`` and ``plane_dense-P-T`` for the A, A' and D dense
layers, at the VGG's two dense shapes and the MLPs' hidden shape; ``head``,
``ternary_head`` and ``plane_head-P`` for the integer heads' modules,
``PackedDenseLogits``, ``TernaryDenseLogits`` and ``PlaneDenseLogits`` with
P planes, their int32 s and their logits, at the MLPs' and the abits-3
VGG's head shapes; ``forward-PATH`` for the whole forward of the path
``mnist_bnn``, ``mnist_tnn`` or ``cifar10_tnn_a3``) at batch 256 on the
same seeded operands (E's K-major weights made beforehand where the
checkout's wrapper takes them), per call and (but for a forward) as CUDA
graph replays.  Run it as parent, change, change, parent.
"""
from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np

ROOT = Path(__file__).resolve().parent
DATA = ROOT / "tests" / "data"

CHECK_BATCH = 32
TIME_BATCH = 256
SERVE_BATCH = 256
ENGINE_BATCHES = 40  # full batches queued for the engine's throughput
CHUNKS = (8, 100, 300, 92, 100)  # 600 requests: one chunk splits, tail pads
# logits: the engine and the plain path run the same float head on equal
# bits; against JAX only the f32 summation order of the first conv or matmul
# and of the VGG's float head differ (measured on CPU: 1.9e-6 of a max
# |logit| of 3.9)
LOGIT_RTOL = 1e-5
LOGIT_ATOL_REL = 1e-4  # times max |logit|
# the relu network types' logits: float all the way down (six convs on
# cuDNN, three GEMMs on cuBLAS, TF32 off), each relu feeding the next layer,
# against XLA:CPU's summation orders (the golden) and a float64 run of the
# same layers (the plain path).  Measured on an H100 at 700 W (PERF.md §6):
# 4.9e-7 from the float64 run and 6.0e-7 from the golden on a max |logit|
# of 1.67, 3.6e-7 of it; the atol allows 80 times that for cuDNN's choice
# of another algorithm, and stays 30 times below what TF32 (1e-3) gives
RELU_LOGIT_RTOL = 1e-5
RELU_LOGIT_ATOL_REL = 3e-5  # times max |logit|
I32_MIN, I32_MAX = -2**31, 2**31 - 1

# (H, W, C_in, N, pool) of conv_1..conv_5 and (K, N) of dense_0, dense_1
CONV_SHAPES = [(32, 32, 128, 128, True), (16, 16, 128, 256, False),
               (16, 16, 256, 256, True), (8, 8, 256, 512, False),
               (8, 8, 512, 512, True)]
DENSE_SHAPES = [(8192, 1024), (1024, 1024)]
# (K, N) of the MLPs' two hidden layers and of their heads, and of the
# abits-3 bit-plane VGG's integer head
MLP_HIDDEN = (4096, 4096)
MLP_HEAD = (4096, 10)
PLANE_HEAD = (1024, 10)
SCAN = (1024, (4096, 4096))  # the JAX package's packed GEMM scan shape
# each formulation's kind timed at SCAN: the wrappers' default geometries,
# and G's faster accumulator count
MEASURED_TIMED = ("outer-128x128", "outer_acc-128x128x16", "chunk3d-64x64x4",
                  "lanered-1x16", "multiacc-4")
PROBE_SHAPE = (4096, 1024)  # vpu_probe's BLOCK (256, 1024) x GRID 16
# the measurement phase's reduced repeats (the experiments' defaults are
# 16 x 5 and, for the probe, 64 x 3)
MEASURE_REPEATS = dict(iters=8, repeats=3)
# the int8 VGG against its f32 twin at these batches; 1024 is bench.py's
TWIN_BATCHES = (256, 1024)
# E's encodings: (JAX act, thresholds): pm1, levels with 1, 3 and 20
# (more than the kernel's 15 in shared memory), zo, and tanh with 2, 6 and
# 254 thresholds (nb 2, 3 and 8: signed codes down to -127)
I8_ENCODINGS = {"pm1": ("pm1", 1), "levels1": ("levels", 1),
                "levels3": ("levels", 3), "levels20": ("levels", 20),
                "zo": ("zo", 1), "tanh2": ("tanh", 2), "tanh6": ("tanh", 6),
                "tanh254": ("tanh", 254)}
# E's encodings in the served int8 paths (cifar10-bnn pm1, cifar10-tnn
# levels, cifar10-bnn zo, cifar10-tnn tanh, full-qnn's levels on 4-bit
# grid weights), the kinds phase 7 times
I8_SERVED = ("i8conv-pm1", "i8conv-levels1", "i8conv-zo", "i8conv-tanh2",
             "i8conv-levels1-w4")

KERNELS = {  # name -> (CUDA source, the TPU kernel it replaces)
    "xnor_conv3x3_fused": ("qnx_torch/kernels/csrc/expand_mma_conv.cu",
                           "qnx/kernels/xnor_conv_fused.py:54"),
    "xnor_dense_fused": ("qnx_torch/kernels/csrc/expand_mma_dense.cu",
                         "qnx/kernels/xnor_conv_fused.py:54"),
    "ternary_dense_fused": ("qnx_torch/kernels/csrc/expand_mma_dense.cu",
                            "qnx/kernels/xnor_conv_fused.py:54"),
    "xnor_gemm_popcount": ("qnx_torch/kernels/csrc/popcount_gemm.cu",
                           "qnx/kernels/xnor_gemm.py:73"),
    "ternary_gemm": ("qnx_torch/kernels/csrc/popcount_gemm.cu",
                     "qnx/kernels/ternary_gemm.py:29"),
    "xnor_head": ("qnx_torch/kernels/csrc/popcount_head.cu",
                  "qnx/kernels/xnor_gemm.py:73"),
    "ternary_head": ("qnx_torch/kernels/csrc/popcount_head.cu",
                     "qnx/kernels/ternary_gemm.py:29"),
    "plane_head": ("qnx_torch/kernels/csrc/popcount_head.cu",
                   "qnx/kernels/plane_gemm.py:32"),
    "i8_conv3x3_fused": ("qnx_torch/kernels/csrc/i8_conv_fused.cu",
                         "qnx/kernels/i8_conv_fused.py:40"),
    "ternary_conv3x3_fused": ("qnx_torch/kernels/csrc/expand_mma_conv.cu",
                              "qnx/kernels/xnor_conv_fused.py:54"),
    "plane_conv3x3_fused": ("qnx_torch/kernels/csrc/expand_mma_conv.cu",
                            "qnx/kernels/plane_gemm.py:32"),
    "plane_dense_fused": ("qnx_torch/kernels/csrc/expand_mma_dense.cu",
                          "qnx/kernels/plane_gemm.py:32"),
    "gemm_outer": ("qnx_torch/kernels/csrc/gemm_formulations.cu",
                   "experiments/gemm_shootout.py:36"),
    "gemm_outer_acc": ("qnx_torch/kernels/csrc/gemm_formulations.cu",
                       "experiments/gemm_shootout.py:65"),
    "gemm_chunk3d": ("qnx_torch/kernels/csrc/gemm_formulations.cu",
                     "experiments/gemm_shootout.py:95"),
    "gemm_lanered": ("qnx_torch/kernels/csrc/gemm_formulations.cu",
                     "experiments/gemm_shootout.py:122"),
    "xnor_multiacc": ("qnx_torch/kernels/csrc/gemm_formulations.cu",
                      "experiments/xnor_sol_variants.py:52"),
    "int_chain": ("qnx_torch/kernels/csrc/int_probe.cu",
                  "experiments/vpu_probe.py:50"),
}
# the kernels that the measurement path (phase 6) runs (B and C at wide N);
# the others run on the slices (phase 4) and the CLI (phase 5)
MEASURED = ("xnor_gemm_popcount", "ternary_gemm", "gemm_outer",
            "gemm_outer_acc", "gemm_chunk3d", "gemm_lanered", "xnor_multiacc",
            "int_chain")
# the integer heads' kernel entries (popcount_head.cu), by make_case kind
HEADS = {"head": "xnor_head", "ternary_head": "ternary_head",
         "plane_head": "plane_head"}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True,
                          timeout=120).stdout.strip()


def golden(name: str):
    return np.load(DATA / f"torch_port_golden_{name}.npz")


# ---------------------------------------------------------------- operands

def epilogue(rng, n: int, k: int):
    """Mixed-direction thresholds around the spread of s, with int32-extreme
    channels (the folded gamma == 0 constant bits) where N allows."""
    sgn = rng.choice(np.array([1, -1], np.int32), n)
    lim = 2 * int(np.sqrt(k)) + 1
    tau = rng.integers(-lim, lim, n).astype(np.int32)
    tau[:3] = [I32_MIN, I32_MAX, I32_MAX][:n]
    sgn[1:2] = -1
    return sgn, tau


def cuda(torch, a):
    return torch.from_numpy(np.ascontiguousarray(a)).cuda()


def pm1(rng, shape):
    return np.where(rng.random(shape) < 0.5, 1.0, -1.0).astype(np.float32)


def conv_operands(torch, rng, b, h, w, c, n):
    from qnx_torch.kernels.xnor_conv import (pack_conv_weights_np,
                                             padding_correction)
    from qnx_torch.ops.packing import pack_bits_np

    x = pm1(rng, (b, h, w, c))
    pattern = pm1(rng, (3, 3, c, n))
    wp, k = pack_conv_weights_np(pattern)
    sgn, tau = epilogue(rng, n, k)
    return (cuda(torch, pack_bits_np(x, -1)), cuda(torch, wp), k,
            cuda(torch, padding_correction(pattern, h, w)), cuda(torch, sgn),
            cuda(torch, tau))


def dense_operands(torch, rng, m, k, n):
    from qnx_torch.ops.packing import pack_bits_np

    sgn, tau = epilogue(rng, n, k)
    return (cuda(torch, pack_bits_np(pm1(rng, (m, k)), -1)),
            cuda(torch, pack_bits_np(pm1(rng, (k, n)), 0)), k,
            cuda(torch, sgn), cuda(torch, tau))


def ternary_weights(rng, shape):
    """{-1, 0, +1} weights, half zero as the dingke weights are, with one
    all-zero output channel where N > 2."""
    w = rng.choice(np.array([-1.0, 0.0, 1.0], np.float32), shape,
                   p=[0.25, 0.5, 0.25])
    if shape[-1] > 2:
        w[..., 1] = 0.0
    return w


def ternary_operands(torch, rng, m, k, n):
    """±1 activations and ternary weights (:func:`ternary_weights`)."""
    from qnx_torch.ops.packing import pack_bits_np, pack_ternary_np

    w = ternary_weights(rng, (k, n))
    sgn, tau = epilogue(rng, n, k)
    return (cuda(torch, pack_bits_np(pm1(rng, (m, k)), -1)),
            *(cuda(torch, a) for a in pack_ternary_np(w, axis=0)),
            cuda(torch, sgn), cuda(torch, tau))


def ternary_conv_operands(torch, rng, b, h, w, c, n):
    """±1 inputs, 3x3 ternary weights as (mask, sign, nnz) and the ternary
    pattern's pad correction, and :func:`epilogue` thresholds."""
    from qnx_torch.kernels.xnor_conv import (pack_conv_ternary_np,
                                             padding_correction)
    from qnx_torch.ops.packing import pack_bits_np

    pattern = ternary_weights(rng, (3, 3, c, n))
    sgn, tau = epilogue(rng, n, 9 * c)
    return [cuda(torch, a) for a in (
        pack_bits_np(pm1(rng, (b, h, w, c)), -1), *pack_conv_ternary_np(pattern),
        padding_correction(pattern, h, w), sgn, tau)]


def plane_operands(torch, rng, p, n_thresh, lead, c, n, conv, corr=False):
    """Kernel D's operands: P {0,1} planes of levels drawn in [0, 2^P) over
    ``lead + (c,)``, ternary weights (3x3 tap-major for a conv) as (mask,
    msign); with ``n_thresh`` > 0 mixed-direction ascending thresholds
    around the spread of s with int32-extreme channels (levels n_thresh, 0
    and n_thresh - 1, sgn = -1 on the second).  ``corr``: quantized_tanh's
    planes, unsigned indices in [0, 2^P - 2], and the conv's border term
    (2^(P-1) - 1) x the pattern's padding correction, last."""
    from qnx_torch.kernels.xnor_conv import pack_conv_ternary_np, padding_correction
    from qnx_torch.ops.packing import pack_bits_np, pack_ternary_np

    lvl = rng.integers(0, 2**p - (1 if corr else 0), (*lead, c))
    planes = np.stack([pack_bits_np((lvl >> j) & 1, axis=-1) for j in range(p)])
    if conv:
        pattern = ternary_weights(rng, (3, 3, c, n))
        mask, sign, _ = pack_conv_ternary_np(pattern)
    else:
        mask, sign, _ = pack_ternary_np(ternary_weights(rng, (c, n)), axis=0)
    args = [planes, mask, mask & sign]
    lim = int(np.sqrt(9 * c if conv else c)) * 2 ** (p - 1) + 1
    if corr:  # the border term shifts s by up to (L - 1) 9 C
        lim += (2 ** (p - 1) - 1) * 3 * c
    if n_thresh:
        sgn = rng.choice(np.array([1, -1], np.int32), n)
        sgn[1:2] = -1
        tau = np.sort(rng.integers(-lim, lim, (n_thresh, n)), axis=0).astype(np.int32)
        tau[:, :3] = np.array([I32_MIN, I32_MAX, I32_MIN], np.int64)[:n]
        tau[-1, 2:3] = I32_MAX
        args += [sgn, tau]
    if corr:
        h, w = lead[1:3]
        args.append((2 ** (p - 1) - 1) * padding_correction(pattern, h, w))
    return [cuda(torch, a) for a in args]


def i8_operands(torch, rng, b, h, w, c, n, encoding: str, n_thresh: int,
                wbits: int = 0):
    """Codes of the encoding (pm1 ±1, zo {0, 1}, levels 0..n_thresh, tanh
    signed -n_thresh/2..n_thresh/2), ternary weights or ``wbits``-bit grid
    weights in [-2^(wbits-1), 2^(wbits-1) - 1] (the bottom in every column),
    mixed-direction thresholds around the spread of s with int32-extreme
    channels (sgn = -1 on one, so under the pool too)."""
    shape = (b, h, w, c)
    if encoding == "pm1":
        x = np.where(rng.random(shape) < 0.5, 1, -1).astype(np.int8)
    elif encoding == "tanh":
        x = rng.integers(-(n_thresh // 2), n_thresh // 2 + 1, shape, dtype=np.int8)
    else:
        x = rng.integers(0, n_thresh + 1, shape, dtype=np.int8)
    m = 2 ** (wbits - 1) if wbits else 1
    wgt = rng.integers(-m, m + (0 if wbits else 1), (3, 3, c, n), dtype=np.int8)
    if wbits:
        wgt[1, 1, 0, :] = -m
    sgn = rng.choice(np.array([1, -1], np.int32), n)
    sgn[1:2] = -1
    lim = 2 * int(np.sqrt(9 * c)) * m * max(1, n_thresh // 2) + 1
    tau = np.sort(rng.integers(-lim, lim, (n_thresh, n)), axis=0).astype(np.int32)
    tau[:, :3] = np.array([I32_MIN, I32_MAX, I32_MIN], np.int64)[:n]
    if encoding in ("pm1", "zo"):
        tau = tau[0]
    return [cuda(torch, a) for a in (x, wgt, sgn, tau)]


def int_mm_call(torch, rng, m: int, k: int, n: int, levels: int = 0,
                weights: str = "pm1") -> Callable:
    """One ``torch._int_mm`` on int8 operands of (M, K) x (K, N), the
    library yardstick of a kernel: it computes the same int32 s, unpacked,
    with no epilogue, pool or repack.  Activations ±1, or with ``levels`` =
    P the levels in [0, 2^P) that P {0,1} planes hold (s = sum_j 2^j t_j
    in one product); weights ±1 or {-1, 0, +1} (``ternary``).  B is
    column-major, the layout cuBLAS runs fastest; ``_int_mm`` takes only
    M > 16 and K, N multiples of 8, so those are padded up (the heads'
    N = 10 to 16)."""
    up = lambda v: -(-v // 8) * 8
    shape = (max(m, 17), up(k))
    if levels:
        a = rng.integers(0, 2**levels, shape).astype(np.int8)
    else:
        a = np.where(rng.random(shape) < 0.5, 1, -1).astype(np.int8)
    if weights == "pm1":
        b = np.where(rng.random((up(n), up(k))) < 0.5, 1, -1).astype(np.int8)
    else:
        b = rng.integers(-1, 2, (up(n), up(k))).astype(np.int8)
    a, bt = cuda(torch, a), cuda(torch, b)
    return lambda: torch._int_mm(a, bt.t())


@dataclass
class Case:
    """One kernel call on fresh operands: the kernel, its plain version,
    whether the output is packed words, the inputs and the MACs for the
    bound, and the library call's (M, K, N) and operands
    (:func:`int_mm_call`'s keywords); ``mkn`` None where no library call
    computes the function."""
    name: str
    kern: Callable
    plain: Callable
    words: bool
    inputs: list
    macs: int
    mkn: tuple | None
    lib: dict = field(default_factory=dict)

    def bound(self, out) -> tuple[float, float]:
        """(ms of the MACs at the int8 peak, ms of the bytes: each input
        read once and the output written once), the least time the card
        could take, from the peaks of
        :data:`qnx_torch.bench.roofline.H100_PEAKS`.  Every kernel's product
        takes ±1 activations or the levels of up to 8 {0,1} planes
        (unsigned, below 2^8) against ±1 or ternary weights, which the int8
        tensor cores' s8 x s8 and u8 x s8 MMA take, so each counts one int8
        MAC per real MAC whatever its planes."""
        from qnx_torch.bench.roofline import H100_PEAKS

        nbytes = sum(t.numel() * t.element_size() for t in [*self.inputs, out])
        return (self.macs / H100_PEAKS["int8_macs"] * 1e3,
                nbytes / H100_PEAKS["hbm_bytes"] * 1e3)


def make_case(torch, rng, kind: str, b: int, shape) -> Case:
    """A :class:`Case` of kernel ``kind`` at batch ``b`` on fresh operands
    of one shape."""
    from qnx_torch.kernels import i8_conv_fused as E
    from qnx_torch.kernels import ternary_gemm as T
    from qnx_torch.kernels import xnor_conv_fused as F
    from qnx_torch.kernels import xnor_gemm as X

    if kind.split("-")[0] in HEADS:
        return head_case(torch, rng, kind, b, shape)
    if kind.startswith("plane_"):  # plane_{conv,dense}-P-n_thresh
        return plane_case(torch, rng, kind, b, shape)
    if kind.split("-")[0] in FORMULATIONS or kind.startswith("int_chain-"):
        return measured_case(torch, rng, kind, b, shape)
    if kind == "ternary_conv":
        h, w, c, n, pool = shape
        args = ternary_conv_operands(torch, rng, b, h, w, c, n)
        return Case("ternary_conv3x3_fused",
                    lambda: F.ternary_conv_fused(*args, pool=pool),
                    lambda: F.ternary_conv_fused_ref(*args, pool=pool), True,
                    args, b * h * w * 9 * c * n, (b * h * w, 9 * c, n),
                    dict(weights="ternary"))
    if kind.startswith("i8conv-"):  # i8conv-ENC[-wBITS]
        _, enc, *grid = kind.split("-")
        encoding, n_thresh = I8_ENCODINGS[enc]
        h, w, c, n, pool = shape
        args = i8_operands(torch, rng, b, h, w, c, n, encoding, n_thresh,
                           int(grid[0][1:]) if grid else 0)
        kw = dict(encoding=encoding, pool=pool)
        # the K-major weights made beforehand, as I8Conv holds them, so the
        # kernel is timed alone (a checkout from before them reads w8)
        x8, w8, sgn, tau = args
        kern_kw, inputs = dict(kw), args
        if hasattr(E, "k_major"):
            kern_kw["wk"] = E.k_major(w8)
            inputs = [x8, kern_kw["wk"], sgn, tau]
        return Case("i8_conv3x3_fused", lambda: E.i8_conv_fused(*args, **kern_kw),
                    lambda: E.i8_conv_fused_ref(*args, **kw), False, inputs,
                    b * h * w * 9 * c * n, (b * h * w, 9 * c, n))
    if kind == "conv":
        h, w, c, n, pool = shape
        xp, wp, k, corr, sgn, tau = conv_operands(torch, rng, b, h, w, c, n)
        return Case("xnor_conv3x3_fused",
                    lambda: F.xnor_conv_fused(xp, wp, k, corr, sgn, tau, pool=pool),
                    lambda: F.xnor_conv_fused_ref(xp, wp, k, corr, sgn, tau, pool=pool),
                    True, [xp, wp, corr, sgn, tau], b * h * w * k * n,
                    (b * h * w, k, n))
    k_in, n = shape
    work = dict(macs=b * k_in * n, mkn=(b, k_in, n))
    if kind in ("dense", "popcount"):
        xp, wp, k, sgn, tau = dense_operands(torch, rng, b, k_in, n)
        if kind == "dense":
            return Case("xnor_dense_fused",
                        lambda: F.xnor_gemm_fused(xp, wp, k, sgn, tau),
                        lambda: F.xnor_gemm_fused_ref(xp, wp, k, sgn, tau), True,
                        [xp, wp, sgn, tau], **work)
        return Case("xnor_gemm_popcount", lambda: X.xnor_gemm_popcount(xp, wp, k),
                    lambda: X.xnor_gemm_popcount_ref(xp, wp, k), False,
                    [xp, wp], **work)
    xp, mask, sign, nnz, sgn, tau = ternary_operands(torch, rng, b, k_in, n)
    work["lib"] = dict(weights="ternary")
    if kind == "ternary_dense":
        return Case("ternary_dense_fused",
                    lambda: F.ternary_gemm_fused(xp, mask, sign, nnz, sgn, tau),
                    lambda: F.ternary_gemm_fused_ref(xp, mask, sign, nnz, sgn, tau),
                    True, [xp, mask, sign, nnz, sgn, tau], **work)
    return Case("ternary_gemm", lambda: T.ternary_gemm(xp, mask, sign, nnz),
                lambda: T.ternary_gemm_ref(xp, mask, sign, nnz), False,
                [xp, mask, sign, nnz], **work)


def plane_case(torch, rng, kind: str, b: int, shape) -> Case:
    """A :class:`Case` of kernel D: ``plane_conv-P-T[-corr]`` (shape (H, W,
    C, N, pool); ``-corr``: quantized_tanh's planes and the border term) or
    ``plane_dense-P-T`` (shape (K, N)) with P planes and T thresholds.  The
    library call is one ``_int_mm`` on the planes' levels."""
    from qnx_torch.kernels import plane_gemm as D

    name, p, n_thresh, *opts = kind.split("-")
    p, n_thresh = int(p), int(n_thresh)
    lib = dict(levels=p, weights="ternary")
    if name == "plane_conv":
        h, w, c, n, pool = shape
        args = plane_operands(torch, rng, p, n_thresh, (b, h, w), c, n, conv=True,
                              corr="corr" in opts)
        kw = dict(pool=pool)
        if "corr" in opts:  # a checkout from before the border term takes none
            kw["corr"] = args[5]
        return Case("plane_conv3x3_fused",
                    lambda: D.plane_conv_fused(*args[:5], **kw),
                    lambda: D.plane_conv_fused_ref(*args[:5], **kw), True, args,
                    b * h * w * 9 * c * n, (b * h * w, 9 * c, n), lib)
    k, n = shape
    args = plane_operands(torch, rng, p, n_thresh, (b,), k, n, conv=False)
    return Case("plane_dense_fused", lambda: D.plane_dense_fused(*args),
                lambda: D.plane_dense_fused_ref(*args), True, args,
                b * k * n, (b, k, n), lib)


def head_case(torch, rng, kind: str, b: int, shape) -> Case:
    """A :class:`Case` of an integer logit head through its module as the
    checkout defines it: ``head`` (``PackedDenseLogits``),
    ``ternary_head[-nnz]`` (``TernaryDenseLogits``; ``-nnz``: nnz off the
    mask's count) or ``plane_head-P[-outside]`` (``PlaneDenseLogits`` over P
    planes; ``-outside``: msign bits outside the mask), at shape (K, N) or
    (K, N, "s" | "logits"): the module's int32 s (``scores``) or its forward,
    the logits (the default).  ``-fn`` calls the wrapper instead
    (``xnor_head``, ``ternary_head``, ``plane_head``; ``plane_gemm`` for D's
    s), which makes the K-major weights per call.  The plain version is the
    GEMM's plain version and the float64 affine.  The library call is one
    ``_int_mm`` on the same product, N padded to 16 (s only)."""
    from qnx_torch.kernels import plane_gemm as D
    from qnx_torch.kernels import ternary_gemm as T
    from qnx_torch.kernels import xnor_gemm as X
    from qnx_torch.nn import inference as I

    k, n, *out = shape
    name, *opts = kind.split("-")
    affine = getattr(X, "affine", None) or I._affine  # a checkout from before
    a = cuda(torch, rng.uniform(-0.1, 0.1, n).astype(np.float32))
    c = cuda(torch, rng.uniform(-2, 2, n).astype(np.float32))
    work = dict(macs=b * k * n, mkn=(b, k, n))
    if name == "head":
        x, wp, k, _, _ = dense_operands(torch, rng, b, k, n)
        head = I.PackedDenseLogits(wp, a, c, k)
        s_ref, weights = (lambda: X.xnor_gemm_popcount_ref(x, wp, k)), [wp]
        fn = lambda *ac: X.xnor_head(x, wp, k, *ac)
    elif name == "ternary_head":
        x, mask, sign, nnz, _, _ = ternary_operands(torch, rng, b, k, n)
        if "nnz" in opts:
            nnz = nnz + cuda(torch, rng.integers(-5, 6, n).astype(np.int32))
        head = I.TernaryDenseLogits(mask, sign, nnz, a, c)
        s_ref = lambda: T.ternary_gemm_ref(x, mask, sign, nnz)
        fn = lambda *ac: T.ternary_head(x, mask, sign, nnz, *ac)
        weights, work["lib"] = [mask, sign, nnz], dict(weights="ternary")
    else:
        p = int(opts[0])
        x, mask, msign = plane_operands(torch, rng, p, 0, (b,), k, n, conv=False)
        if "outside" in opts:
            noise = rng.integers(I32_MIN, I32_MAX, tuple(mask.shape), dtype=np.int32,
                                 endpoint=True)
            msign = msign | (cuda(torch, noise) & ~mask)
        head = I.PlaneDenseLogits(mask, msign, a, c)
        s_ref, weights = (lambda: D.plane_gemm_ref(x, mask, msign)), [mask, msign]
        work["lib"] = dict(levels=p, weights="ternary")
        fn = lambda *ac: (D.plane_head(x, mask, msign, *ac) if ac
                          else D.plane_gemm(x, mask, msign))
    if "fn" not in opts:
        fn = lambda *ac: head(x) if ac else head.scores(x)
    if out == ["s"]:
        return Case(HEADS[name], fn, s_ref, False, [x, *weights], **work)
    return Case(HEADS[name], lambda: fn(a, c), lambda: affine(a, s_ref(), c),
                False, [x, *weights, a, c], **work)


# kind prefix of make_case -> the KERNELS name, also its wrapper's in
# qnx_torch.kernels.gemm_formulations; the geometry follows the prefix as
# BMxBN[xBK|xKC], RxC or NACC
FORMULATIONS = {"outer": "gemm_outer", "outer_acc": "gemm_outer_acc",
                "chunk3d": "gemm_chunk3d", "lanered": "gemm_lanered",
                "multiacc": "xnor_multiacc"}


def measured_case(torch, rng, kind: str, m, shape) -> Case:
    """A :class:`Case` of the measurement path's kernels: a formulation of
    the popcount GEMM, ``outer-256x128`` or ``multiacc-2`` (shape (K, N),
    seeded words with zero pad bits, the plain version kernel B's), or
    ``int_chain-MODE-REPS`` (shape of the elements, the int32 extremes in
    both operands; no library call computes it)."""
    from qnx_torch.experiments.gemm_shootout import random_words
    from qnx_torch.kernels import gemm_formulations as G
    from qnx_torch.kernels import int_probe as P
    from qnx_torch.kernels.xnor_gemm import xnor_gemm_popcount_ref

    prefix, geometry = kind.split("-", 1)
    if prefix == "int_chain":
        mode, reps = geometry.split("-")
        reps = int(reps)
        x, y = (rng.integers(I32_MIN, I32_MAX, shape, dtype=np.int32, endpoint=True)
                for _ in range(2))
        edge = np.array([I32_MIN, I32_MAX, -1, 0, 1, I32_MAX - 1], np.int32)
        x.flat[:6], y.flat[:6], y.flat[6:12] = edge, edge[::-1], edge
        x, y = cuda(torch, x), cuda(torch, y)
        return Case("int_chain", lambda: P.int_chain(x, y, mode, reps),
                    lambda: P.int_chain_ref(x, y, mode, reps), False, [x, y], 0, None)
    name = FORMULATIONS[prefix]
    g = [int(v) for v in geometry.split("x")]
    k, n = shape
    xp = cuda(torch, random_words(rng, m, k))
    wp = cuda(torch, random_words(rng, n, k, along_rows=True))
    w = wp.t().contiguous() if prefix == "lanered" else wp
    fn = getattr(G, name)
    return Case(name, lambda: fn(xp, w, k, *g),
                lambda: xnor_gemm_popcount_ref(xp, wp, k), False, [xp, w],
                m * k * n, (m, k, n))


# (M, (K, N)): ragged M and K (k % 32 != 0), N = 1, 10, 33, 128, the MNIST
# head's 256 x 4096 x 10 and the scan shape
RAGGED_SHAPES = [(3, (100, 1)), (37, (153, 10)), (130, (1000, 33)),
                 (257, (4000, 128)), (256, (4096, 10)), (1024, (4096, 4096))]


def head_cases() -> list:
    """The three integer heads, their int32 s and their logits, at the MLPs'
    and the abits-3 VGG's head shapes at batch 32 and 256 (D's with 1, 2, 3
    and 8 planes), and on :data:`RAGGED_SHAPES` and M = 1 with nnz off the
    mask's count and msign bits outside the mask (D at 3 and 8 planes); and
    the wrappers called without the heads' K-major copy."""
    cases = []
    for out in ("s", "logits"):
        for b in (CHECK_BATCH, TIME_BATCH):
            cases += [("head", b, (*MLP_HEAD, out)),
                      ("ternary_head", b, (*MLP_HEAD, out))]
            cases += [(f"plane_head-{p}", b, (*PLANE_HEAD, out)) for p in (1, 2, 3, 8)]
        for m, (k, n) in [*RAGGED_SHAPES, (1, (100, 10)), (1, (4096, 33))]:
            cases += [("head", m, (k, n, out)), ("ternary_head-nnz", m, (k, n, out)),
                      (f"plane_head-{3 if m % 2 else 8}-outside", m, (k, n, out))]
        # the wrappers themselves, with the K-major weights made per call
        cases += [(kind, 37, (153, 10, out)) for kind in
                  ("head-fn", "ternary_head-fn", "plane_head-1-fn", "plane_head-2-fn")]
    return cases


def measured_cases() -> list:
    """F1-F4 and G at every geometry the shootout sweeps, on
    :data:`RAGGED_SHAPES` (zero pad bits); H in every mode at every compiled
    length on a ragged count of elements."""
    from qnx_torch.kernels import gemm_formulations as G
    from qnx_torch.kernels.int_probe import MODES, REPS

    kinds = [f"outer-{bm}x{bn}" for bm, bn in G.OUTER_GEOMETRIES]
    kinds += [f"outer_acc-{bm}x{bn}x{bk}" for bm, bn, bk in G.OUTER_ACC_GEOMETRIES]
    kinds += [f"chunk3d-{bm}x{bn}x{kc}" for bm, bn, kc in G.CHUNK3D_GEOMETRIES]
    kinds += [f"lanered-{r}x{c}" for r, c in G.LANERED_GEOMETRIES]
    kinds += [f"multiacc-{a}" for a in G.NACCS]
    cases = [(kind, m, s) for kind in kinds for m, s in RAGGED_SHAPES]
    return cases + [(f"int_chain-{mode}-{reps}", None, (37, 29))
                    for mode in MODES for reps in REPS]


def tile_bytes(name: str, b: int, shape, planes: int = 1) -> int | None:
    """Bytes the blocks of kernel ``name`` copy from L2 into shared memory
    at batch ``b`` and ``shape`` (H, W, C, N, pool) of a conv or (K, N) of a
    dense layer, from the kernels' tiling: E (``i8_conv_fused.cu``) 128
    rows x 128 channels, K steps of 128 channels of a tap moving 256 x 128
    bytes, ceil(Cp / 128) a tap (Cp = C rounded up to 16); A, A' and D
    (``expand_mma_conv.cu``, ``expand_mma_dense.cu``) 128 x 128, K steps
    of one to four words (of a tap) moving 128 activation rows of each of
    ``planes`` planes and 128 weight columns of each weight plane, 4 bytes
    a word (the dense kernel's split K moves each tile's K once over the
    blocks of its cluster).  None for another kernel."""
    weight_planes = {"xnor_conv3x3_fused": 1, "ternary_conv3x3_fused": 2,
                     "plane_conv3x3_fused": 2, "i8_conv3x3_fused": 0,
                     "xnor_dense_fused": 1, "ternary_dense_fused": 2,
                     "plane_dense_fused": 2}.get(name)
    if weight_planes is None:
        return None
    if name in DENSE_NAMES:
        k, n = shape
        tiles = -(-b // 128) * -(-n // 128)
        return tiles * -(-k // 32) * 4 * 128 * (planes + weight_planes)
    h, w, c, n, pool = shape
    qh, qw = (h // 2, w // 2) if pool else (-(-h // 2), -(-w // 2))
    row_blocks = -(-4 * b * qh * qw // 128)
    if name == "i8_conv3x3_fused":
        steps = 9 * -(-(-(-c // 16) * 16) // 128)
        return row_blocks * -(-n // 128) * steps * 256 * 128
    words = 9 * -(-c // 32)
    return row_blocks * -(-n // 128) * words * 4 * 128 * (planes + weight_planes)


def word_err(torch, got, want) -> float:
    """Max |difference| of the ±1 codes the two word tensors hold."""
    from qnx_torch.ops.packing import unpack_bits

    kbits = got.shape[-1] * 32
    a = unpack_bits(got, kbits, dtype=torch.float32)
    b = unpack_bits(want, kbits, dtype=torch.float32)
    return float((a - b).abs().max())


def compare(torch, err: dict, name: str, got, want, words: bool, what: str) -> None:
    """Record the max abs error of ``got`` against ``want`` under ``name``
    and raise unless they are equal."""
    e = (word_err(torch, got, want) if words
         else float((got.double() - want.double()).abs().max()))
    err[name] = max(err[name], e)
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{name} {what}: kernel output differs from the "
                             f"plain version's (max abs err {e})")


# ---------------------------------------------------------------- phases

def phase_device(torch) -> str:
    from qnx_torch.kernels import _build

    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    clocks = run(["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
                  "--format=csv,noheader"]).splitlines()[0]
    nvcc = run([_build._nvcc(), "--version"]).splitlines()[-1]
    print(card, flush=True)
    log("device", f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
        f" | max/current SM clock {clocks} | torch {torch.__version__} "
        f"CUDA {torch.version.cuda} | {nvcc}")
    return card


def phase_build() -> None:
    from qnx_torch.kernels import _build

    fresh = not _build.library_path().exists()
    t0 = time.perf_counter()
    _build.load()
    dt = time.perf_counter() - t0
    log("build", f"{_build.library_path().name} "
        f"{'built' if fresh else 'reused'} in {dt:.2f} s")
    for line in _build.build_log().splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling", "arning",
                                   "Performance")):
            log("build", line.strip())
    for name, (whole, loop, steps) in mma_sass(_build.library_path()).items():
        per_step = {op: round(c / steps, 2) for op, c in sorted(loop.items())}
        log("build", f"SASS {name}: K loop ({steps} steps an iteration) per "
            f"step {per_step}; whole function " + ", ".join(
                f"{op} {whole[op]}" for op in (*MMA_OPS, "POPC", "LOP3")))
        # every instance's K loop: wgmma, no popcount, no mma.sync
        if not loop["IGMMA"] or loop["POPC"] or loop["IMMA"]:
            raise AssertionError(f"SASS {name}: the K loop is not a wgmma loop "
                                 f"({dict(loop)})")


# SASS opcodes reported per K step of the tensor-core convs: the MMAs
# (mma.sync is IMMA, wgmma on integers IGMMA) and the rest
MMA_OPS = ("IMMA", "HGMMA", "IGMMA")
SASS_OPS = (*MMA_OPS, "POPC", "LOP3", "SHF", "IMAD", "IADD3", "LDSM", "LDS",
            "STS", "LDGSTS", "BAR", "WARPGROUP")


# the wgmma k32 a warp issues per K step of kernel E (i8_conv_fused.cu's
# kKC = 128 channels)
E_K32_PER_STEP = 4


def mma_sass(library: Path) -> dict:
    """{kernel instance (A, A' or D's planes, conv or dense, and KW; E's
    copy width): (opcode Counter of the function, of its K loop, K steps an
    iteration of that loop)} of each expand_mma_conv3x3_kernel,
    expand_mma_dense_kernel and i8_conv3x3_kernel instance in the built
    library, or {} without ``cuobjdump``.  The K loop is the innermost backward branch's range that
    holds the most MMAs; a step issues KW IGMMA (wgmma) a warp, E's
    E_K32_PER_STEP, or 16 times as many IMMA (mma.sync)."""
    from qnx_torch.experiments.vpu_probe import _cuobjdump

    tool = _cuobjdump()
    if tool is None:
        return {}
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    funcs, name = {}, None
    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            name = (head.group(1) if any(k in head.group(1) for k in (
                "expand_mma_conv3x3_kernel", "expand_mma_dense_kernel",
                "i8_conv3x3_kernel")) else None)
            if name:
                funcs[name] = []
            continue
        ins = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)"
                       r"([^;]*)", line)
        if name and ins:
            target = re.search(r"0x([0-9a-f]+)", ins.group(3))
            funcs[name].append((int(ins.group(1), 16), ins.group(2).split(".")[0],
                                int(target.group(1), 16)
                                if ins.group(2) == "BRA" and target else None))
    out = {}
    for name, code in funcs.items():
        def mmas(lo, hi):
            return sum(op in MMA_OPS for a, op, _ in code if lo <= a <= hi)

        loops = [(mmas(lo, hi), lo - hi, lo, hi) for hi, op, lo in code
                 if op == "BRA" and lo is not None and lo < hi]
        if not loops or not max(loops)[0]:
            continue
        mma, _, lo, hi = max(loops)  # the most MMAs, then the shortest range
        loop = Counter(op for a, op, _ in code if lo <= a <= hi and op in SASS_OPS)
        *first, last = (int(v) for v in re.findall(r"Li(\d+)E", name))
        if "i8_conv3x3_kernel" in name:
            label, k32 = f"E copies of {last} B", E_K32_PER_STEP
        else:
            ops = ("D P=" + str(first[0] or "any")
                   + (" corr" if "Lb1E" in name else "")  # kBorderTerm
                   if "PlaneOperands" in name
                   else "A'" if "TernaryOperands" in name else "A")
            layer = "dense" if "expand_mma_dense_kernel" in name else "conv"
            label, k32 = f"{ops} {layer} KW={last}", last
        per_step = 16 * k32 if loop["IMMA"] else k32
        out[label] = (Counter(op for _, op, _ in code), loop, max(1, mma // per_step))
    return out


def phase_kernels(torch, err: dict) -> None:
    from qnx_torch.kernels.gemm_formulations import DoesNotFit

    rng = np.random.default_rng(10)
    # the VGG's layers at batch 32, ragged batch and odd spatial, any N
    cases = [("conv", CHECK_BATCH, s) for s in CONV_SHAPES]
    cases += [("dense", b, s) for b in (CHECK_BATCH, TIME_BATCH) for s in DENSE_SHAPES]
    cases += [("conv", 3, CONV_SHAPES[0]), ("conv", 3, (5, 7, 32, 64, False)),
              ("dense", 3, DENSE_SHAPES[0])]
    cases += [("conv", 2, (32, 32, 8, 8, True)), ("conv", 3, (5, 7, 16, 48, False)),
              ("dense", CHECK_BATCH, (64, 8)), ("dense", 3, (100, 48))]
    # the MLPs' hidden layers and heads at batch 32 and 256, the packed GEMM
    # scan shape, and a partial word with N = 10, 1 and 33
    for b in (CHECK_BATCH, TIME_BATCH):
        cases += [("dense", b, MLP_HIDDEN), ("ternary_dense", b, MLP_HIDDEN),
                  ("popcount", b, MLP_HEAD), ("ternary", b, MLP_HEAD)]
    kinds = ("ternary_dense", "popcount", "ternary")
    cases += [(kind, SCAN[0], SCAN[1]) for kind in kinds]
    cases += [(kind, 3, (100, n)) for kind in kinds for n in (10, 1, 33)]
    # A's conv at batch 256, C not a multiple of 32 or of 128 (40, 96, 160:
    # one word a K step), N = 10, 33, 130
    cases += [("conv", TIME_BATCH, s) for s in CONV_SHAPES]
    cases += [("conv", 3, (4, 6, 40, 33, True)), ("conv", 2, (6, 6, 40, 10, False)),
              ("conv", 3, (6, 4, 64, 10, False)), ("conv", 5, (8, 8, 160, 256, True)),
              ("conv", 3, (7, 9, 96, 130, False)), ("conv", 3, (7, 5, 256, 33, False))]
    # kernel E at the int8 VGGs' conv shapes at batch 32 and 256, ragged
    # batch, odd spatial (with and without the pool), C = N = 8, C not a
    # multiple of 16 or of 128 (6: byte copies, 8, 20, 40: 4-byte copies,
    # 96), N = 10, 33, 130, 300 (three 128-channel blocks), each in the pm1
    # encoding and in levels with 1, 3 and 20 thresholds
    i8 = [f"i8conv-{e}" for e in I8_ENCODINGS]
    cases += [(kind, b, s) for b in (CHECK_BATCH, TIME_BATCH)
              for s in CONV_SHAPES for kind in i8]
    cases += [(kind, b, s) for b, s in ((3, (5, 7, 16, 48, False)),
                                        (3, (7, 5, 16, 48, True)),
                                        (2, (32, 32, 8, 8, True)),
                                        (3, (5, 7, 8, 8, False)),
                                        (3, (5, 7, 40, 33, False)),
                                        (3, (6, 4, 40, 130, True)),
                                        (3, (7, 9, 96, 130, True)),
                                        (2, (4, 6, 96, 33, False)),
                                        (3, (5, 7, 6, 10, True)),
                                        (2, (4, 4, 20, 300, False)))
              for kind in i8]
    cases += i8_activation_cases()
    cases += (ternary_vgg_cases() + plane_cases() + dense_cases() + head_cases()
              + measured_cases())
    splits_seen = set()
    for kind, b, shape in cases:
        case = make_case(torch, rng, kind, b, shape)
        try:
            got = case.kern()
        except DoesNotFit as e:  # a geometry the shootout prints as such
            log("kernels", f"{case.name} {kind} batch {b} {shape}: does not fit ({e})")
            continue
        want = case.plain()
        torch.cuda.synchronize()
        compare(torch, err, case.name, got, want, case.words,
                f"{kind} batch {b} {shape}")
        split = dense_split(torch, case.name, b, shape)
        splits_seen.add(split)
        log("kernels", f"{case.name} {kind} batch {b} {shape}: out "
            f"{tuple(got.shape)}, equal, max_abs_err {err[case.name]}"
            + (f", K split over {split} blocks" if split else ""))
    if splits_seen - {None} != {1, 2, 4, 8}:
        raise AssertionError(f"the dense cases reached the splits "
                             f"{sorted(splits_seen - {None})}, not 1, 2, 4 and 8")


DENSE_NAMES = ("xnor_dense_fused", "ternary_dense_fused", "plane_dense_fused")
# the kernels phase 7 also times as CUDA graph replays
GRAPH_NAMES = (*DENSE_NAMES, *HEADS.values())


def dense_split(torch, name: str, m: int, shape) -> int | None:
    """The blocks a tile's K is split over in the dense kernel
    (``expand_mma_dense.cu``) for a call of ``name`` at batch ``m`` and
    shape (K, N), as its wrapper picks them on this card; None for another
    kernel."""
    from qnx_torch.kernels.xnor_conv_fused import dense_splits

    if name not in DENSE_NAMES:
        return None
    k, n = shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return dense_splits(m, n, -(-k // 32), sms)


def dense_cases() -> list:
    """The dense kernels of A, A' and D beside their served shapes: M = 1,
    17, 100, 300; K of one K step or less (100), of 13 words (392: one word
    a step, a ragged split), 1024 and 8192; N = 1, 10, 33, 130, 1024, 4096;
    so that the wrappers pick each split, 1, 2, 4 and 8 blocks a tile; D
    with 1 to 8 planes and 1 to 255 thresholds (16 and more from L1)."""
    shapes = [(m, s) for m in (1, 17, 100, 300)
              for s in ((100, 10), (392, 33), (1024, 130), (8192, 1))]
    shapes += [(300, (1024, 1024)), (300, MLP_HIDDEN), (17, (4096, 4096))]
    cases = [(kind, m, s) for kind in ("dense", "ternary_dense") for m, s in shapes]
    return cases + [("plane_dense-1-1", 1, (392, 33)),
                    ("plane_dense-2-3", 17, (1024, 130)),
                    ("plane_dense-3-7", 100, (8192, 1)),
                    ("plane_dense-4-15", 300, (1024, 1024)),
                    ("plane_dense-5-31", 300, (392, 10)),
                    ("plane_dense-6-63", 17, MLP_HIDDEN),
                    ("plane_dense-7-127", 100, (100, 130)),
                    ("plane_dense-8-255", 300, MLP_HIDDEN),
                    ("plane_dense-8-255", 1, (1024, 33)),
                    ("plane_dense-2-1", TIME_BATCH, MLP_HIDDEN)]


def i8_activation_cases() -> list:
    """E in the zo and tanh encodings (2, 6 and 254 thresholds) and on 4-
    and 8-bit grid weights (-128 included) at the int8 VGGs' conv shapes at
    batch 32 and 256, ragged batch, odd spatial, C not a multiple of 16 or
    128, N = 10, 33, 130."""
    kinds = ["i8conv-zo", "i8conv-tanh2", "i8conv-tanh6", "i8conv-tanh254",
             "i8conv-levels1-w4", "i8conv-pm1-w8", "i8conv-levels3-w8"]
    cases = [(kind, b, s) for b in (CHECK_BATCH, TIME_BATCH)
             for s in CONV_SHAPES for kind in kinds[:2] + kinds[4:5]]
    cases += [(kind, CHECK_BATCH, s) for s in CONV_SHAPES
              for kind in kinds[2:4] + kinds[5:]]
    return cases + [(kind, b, s) for b, s in ((3, (5, 7, 16, 48, False)),
                                             (3, (7, 5, 16, 48, True)),
                                             (3, (6, 4, 40, 130, True)),
                                             (3, (5, 7, 6, 10, True)),
                                             (2, (4, 6, 96, 33, False)))
                    for kind in kinds]


def ternary_vgg_cases() -> list:
    """A' at the ternary VGG's (abits 1) conv and dense shapes at batch 32
    and 256; the conv with ragged batch, odd spatial, C not a multiple of
    32 or of 128 (96, 160: one word a K step), N = 8, 10, 33, 48, 130."""
    cases = [(kind, b, s) for b in (CHECK_BATCH, TIME_BATCH)
             for kind, shapes in (("ternary_conv", CONV_SHAPES),
                                  ("ternary_dense", DENSE_SHAPES))
             for s in shapes]
    return cases + [("ternary_conv", 3, (5, 7, 16, 48, False)),
                    ("ternary_conv", 2, (32, 32, 8, 8, True)),
                    ("ternary_conv", 3, (4, 6, 40, 33, True)),
                    ("ternary_conv", 3, (6, 4, 64, 10, False)),
                    ("ternary_conv", 5, (8, 8, 160, 256, True)),
                    ("ternary_conv", 3, (7, 9, 96, 130, False)),
                    ("ternary_conv", 3, (7, 5, 256, 33, False))]


def plane_cases() -> list:
    """D at the bit-plane VGGs' shapes at batch 32 and 256: one plane and
    one threshold (``cifar10-tnn``), two planes and three thresholds (abits
    3); then 1 to 8 planes with 1 to 255 thresholds
    (levels to 255, the u8 operand's top bit), ragged batch, odd spatial, C
    not a multiple of 32 or of 128, N = 8, 10, 33, 48, K not a multiple of
    32."""
    cases = []
    for b in (CHECK_BATCH, TIME_BATCH):
        cases += [(f"plane_conv-{pt}", b, s) for pt in ("1-1", "2-3")
                  for s in CONV_SHAPES]
        cases += [(f"plane_dense-{pt}", b, s) for pt in ("1-1", "2-3")
                  for s in DENSE_SHAPES]
    cases += [("plane_conv-2-1", CHECK_BATCH, CONV_SHAPES[0]),
              ("plane_conv-3-3", CHECK_BATCH, CONV_SHAPES[1]),
              ("plane_conv-3-7", CHECK_BATCH, CONV_SHAPES[2]),
              ("plane_conv-1-1", CHECK_BATCH, CONV_SHAPES[0]),
              ("plane_conv-2-3", 3, (5, 7, 16, 48, False)),
              ("plane_conv-3-3", 3, (5, 7, 40, 10, False)),
              ("plane_conv-2-3", 3, (4, 6, 32, 33, True)),
              ("plane_conv-1-1", 2, (32, 32, 8, 8, True)),
              ("plane_conv-4-15", 2, (8, 8, 8, 8, True)),
              ("plane_conv-7-3", 3, (8, 8, 64, 64, False)),
              ("plane_conv-8-255", 2, (8, 6, 32, 40, True)),
              ("plane_conv-8-255", 2, (4, 6, 128, 40, True)),
              ("plane_conv-2-3", 3, (5, 7, 128, 48, False)),
              ("plane_conv-2-3", 5, (8, 8, 160, 256, True)),
              ("plane_conv-1-1", 3, (7, 9, 96, 130, False)),
              # the border term (quantized_tanh): P = 2 as served, 3 and 8
              *[("plane_conv-2-2-corr", b, s) for b in (CHECK_BATCH, TIME_BATCH)
                for s in CONV_SHAPES],
              ("plane_conv-3-6-corr", CHECK_BATCH, CONV_SHAPES[1]),
              ("plane_conv-3-6-corr", 3, (5, 7, 40, 10, False)),
              ("plane_conv-2-2-corr", 3, (4, 6, 32, 33, True)),
              ("plane_conv-8-254-corr", 2, (8, 6, 32, 40, True)),
              ("plane_conv-8-254-corr", 2, (4, 6, 128, 40, False)),
              ("plane_dense-3-3", CHECK_BATCH, DENSE_SHAPES[0]),
              ("plane_dense-3-7", 3, (100, 48)),
              ("plane_dense-2-3", 37, (96, 33)),
              ("plane_dense-1-1", 5, (100, 10)),
              ("plane_dense-5-31", 3, (64, 8))]
    return cases


def serve(torch, label: str, model, images, per_batch: dict, plain_forward,
          err: dict, gold, tol=(LOGIT_RTOL, LOGIT_ATOL_REL)) -> dict:
    """Serve ``images`` in CHUNKS through the engine with every launch count
    set to 0 just before and read just after; check the answers, the counts
    (``per_batch`` x batches), and the logits against the plain path and
    the golden within ``tol`` (rtol, atol over max |logit|).  Returns the
    launch counts."""
    from qnx_torch.kernels import launch_counters
    from qnx_torch.serve.engine import ServeEngine, normalize_u8

    engine = ServeEngine(model, batch_size=SERVE_BATCH, max_wait_ms=50.0)
    futs, off = [], 0
    for size in CHUNKS:  # queued before start: the batching is deterministic
        futs += engine.submit_many(images[off:off + size])
        off += size
    counted = launch_counters()
    for w in counted.values():
        w.launches = 0
    engine.start()
    try:
        logits = np.stack([f.result(timeout=600) for f in futs])
    finally:
        engine.stop()
    launches = {name: w.launches for name, w in counted.items()}
    batches = engine.stats()["batches"]
    log(label, f"engine answered {len(logits)}/{len(images)} requests in "
        f"{batches} batches of {SERVE_BATCH} (pad fraction "
        f"{engine.stats()['pad_fraction']:.3f}); launches {launches}")
    if len(logits) != len(images) or not all(f.done() for f in futs):
        raise AssertionError(f"{label}: not every request was answered")
    classes = gold["logits"].shape[1]
    if logits.shape != (len(images), classes) or not np.isfinite(logits).all():
        raise AssertionError(f"{label}: bad logits, shape {logits.shape}")
    want = {name: per_batch.get(name, 0) * batches for name in KERNELS}
    if launches != want:
        raise AssertionError(f"{label}: launch counts {launches} != {want}")

    plain = []
    with torch.inference_mode():
        for s in range(0, len(images), SERVE_BATCH):
            x = normalize_u8(cuda(torch, images[s:s + SERVE_BATCH]))
            plain.append(plain_forward(torch, model, x, err).cpu().numpy())
    plain = np.concatenate(plain)
    d_plain = float(np.abs(logits - plain).max())
    rtol, atol_rel = tol
    np.testing.assert_allclose(logits, plain, rtol=rtol,
                               atol=atol_rel * float(np.abs(plain).max()))
    if not (logits.argmax(-1) == plain.argmax(-1)).all():
        raise AssertionError(f"{label}: argmax differs from the plain path")
    gold = gold["logits"]
    ours = logits[:len(gold)]
    d_gold = float(np.abs(ours - gold).max())
    np.testing.assert_allclose(ours, gold, rtol=rtol,
                               atol=atol_rel * float(np.abs(gold).max()))
    if not (ours.argmax(-1) == gold.argmax(-1)).all():
        raise AssertionError(f"{label}: argmax differs from the JAX golden")
    log(label, f"every layer's words or codes equal to the plain path for all "
        f"{len(images)} images; logits max |engine - plain| {d_plain:.3g}, "
        f"max |engine - JAX golden| {d_gold:.3g} (max |logit| "
        f"{float(np.abs(gold).max()):.3g}, {classes} classes; tolerance rtol "
        f"{rtol:g}, atol {atol_rel:g} x max |logit|); argmax identical")
    return launches


def requests(cf, gold):
    """600 seeded uint8 images, the golden's 8 first."""
    images = np.random.default_rng(2).integers(
        0, 256, (sum(CHUNKS), *cf.input_shape), dtype=np.uint8)
    images[:len(gold["images"])] = gold["images"]
    return images


def plain_vgg_forward(torch, model, x, err: dict):
    """The VGG forward with each packed layer run both ways on the same
    input bits: kernel words must equal the plain version's."""
    from qnx_torch.kernels import xnor_conv_fused as F
    from qnx_torch.nn.inference import TernaryConvBits, TernaryDenseBits

    bits = model.first(x)
    for i, conv in enumerate(model.convs, 1):
        got = conv(bits)
        if isinstance(conv, TernaryConvBits):
            name = "ternary_conv3x3_fused"
            bits = F.ternary_conv_fused_ref(bits, conv.mask, conv.sign, conv.nnz,
                                            conv.corr, conv.sgn, conv.tau,
                                            pool=conv.pool)
        else:
            name = "xnor_conv3x3_fused"
            bits = F.xnor_conv_fused_ref(bits, conv.wp, conv.k, conv.corr,
                                         conv.sgn, conv.tau, pool=conv.pool)
        compare(torch, err, name, got, bits, True, f"conv_{i}")
    bits = bits.reshape(bits.shape[0], -1)
    for j, dense in enumerate(model.denses):
        got = dense(bits)
        if isinstance(dense, TernaryDenseBits):
            name = "ternary_dense_fused"
            bits = F.ternary_gemm_fused_ref(bits, dense.mask, dense.sign,
                                            dense.nnz, dense.sgn, dense.tau)
        else:
            name = "xnor_dense_fused"
            bits = F.xnor_gemm_fused_ref(bits, dense.wp, dense.k, dense.sgn,
                                         dense.tau)
        compare(torch, err, name, got, bits, True, f"dense_{j}")
    return model.head(bits)


def check_values(torch, label: str, codes, want=None) -> None:
    """A hidden layer's codes (or levels) must take two values or more, or
    exactly ``want``: random weights must not make a layer constant, which
    would let its parity pass without exercising it."""
    values = set(torch.unique(codes).tolist())
    if (values != set(want)) if want else len(values) < 2:
        raise AssertionError(f"{label}: the layer's codes take the values "
                             f"{sorted(values)}, not {sorted(want) if want else 'two or more'}")


def plane_levels(torch, planes, n: int):
    """The level index that (P, ..., Nw) planes hold over n channels."""
    from qnx_torch.ops.packing import unpack_bits

    return sum(((unpack_bits(planes[j], n, dtype=torch.int32) + 1) // 2) << j
               for j in range(planes.shape[0]))


def plain_plane_forward(torch, model, x, err: dict):
    """The bit-plane VGG forward with each plane layer and the integer
    head run both ways on the same input planes: planes, the head's int32 s
    and its logits must be equal; every layer's levels take two values or
    more (tanh mode at abits 2: the three indices 0, 1, 2)."""
    from qnx_torch.kernels import plane_gemm as D
    from qnx_torch.nn.inference import PlaneDenseLogits

    tanh3 = {0, 1, 2} if model.first.mode == "tanh" and model.first.nb == 2 else None
    planes = model.first(x)
    for i, conv in enumerate(model.convs, 1):
        got = conv(planes)
        planes = D.plane_conv_fused_ref(planes, conv.mask, conv.msign, conv.sgn,
                                        conv.tau, pool=conv.pool, corr=conv.corr)
        compare(torch, err, "plane_conv3x3_fused", got, planes, True, f"conv_{i}")
        check_values(torch, f"conv_{i}", plane_levels(torch, planes,
                                                      conv.mask.shape[1]), tanh3)
    planes = planes.reshape(planes.shape[0], planes.shape[1], -1)
    for j, dense in enumerate(model.denses):
        got = dense(planes)
        planes = D.plane_dense_fused_ref(planes, dense.mask, dense.msign,
                                         dense.sgn, dense.tau)
        compare(torch, err, "plane_dense_fused", got, planes, True, f"dense_{j}")
        check_values(torch, f"dense_{j}", plane_levels(torch, planes,
                                                       dense.mask.shape[1]), tanh3)
    head = model.head
    if isinstance(head, PlaneDenseLogits):
        return plain_head(torch, err, "plane_head", head, planes,
                          D.plane_gemm_ref(planes, head.mask, head.msign))
    return head(planes)


def plain_head(torch, err: dict, name: str, head, x, s):
    """Hold an integer head's int32 s (``scores``) and logits (its forward,
    one launch) against the plain ``s`` and its float64 affine; return the
    plain logits."""
    from qnx_torch.kernels.xnor_gemm import affine

    compare(torch, err, name, head.scores(x), s, False, "head s")
    logits = affine(head.a, s, head.c)
    compare(torch, err, name, head(x), logits, False, "head logits")
    return logits


def plain_mlp_forward(torch, model, x, err: dict):
    """The MLP forward with each hidden layer and the integer head run both
    ways on the same input bits: words, the head's int32 s and its logits
    must be equal."""
    from qnx_torch.kernels import xnor_conv_fused as F
    from qnx_torch.kernels.ternary_gemm import ternary_gemm_ref
    from qnx_torch.kernels.xnor_gemm import xnor_gemm_popcount_ref
    from qnx_torch.nn.inference import TernaryDenseBits, TernaryDenseLogits

    bits = model.first(x.reshape(x.shape[0], -1))
    for i, layer in enumerate(model.hidden, 1):
        got = layer(bits)
        if isinstance(layer, TernaryDenseBits):
            name = "ternary_dense_fused"
            bits = F.ternary_gemm_fused_ref(bits, layer.mask, layer.sign,
                                            layer.nnz, layer.sgn, layer.tau)
        else:
            name = "xnor_dense_fused"
            bits = F.xnor_gemm_fused_ref(bits, layer.wp, layer.k, layer.sgn,
                                         layer.tau)
        compare(torch, err, name, got, bits, True, f"dense_{i}")
    head = model.head
    if isinstance(head, TernaryDenseLogits):
        return plain_head(torch, err, "ternary_head", head, bits,
                          ternary_gemm_ref(bits, head.mask, head.sign, head.nnz))
    return plain_head(torch, err, "xnor_head", head, bits,
                      xnor_gemm_popcount_ref(bits, head.wp, head.k))


def exact_dot(torch, x8, w8):
    """int8 (M, K) x (K, N) -> int32 in float64 (exact below 2^53): the
    plain counterpart of the engine's ``torch._int_mm``."""
    return (x8.double() @ w8.double()).to(torch.int32)


def check_codes(torch, label: str, got, want) -> None:
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{label}: the engine's output differs from the "
                             f"plain path's")


def plain_i8_forward(torch, model, x, err: dict):
    """The int8 forward with each conv run through kernel E and its plain
    version on the same input codes (codes must be equal), and each dense
    layer's and integer head's ``_int_mm`` against a float64 product; every
    layer's codes take two values or more (zo's {0, 1}, tanh's {-1, 0, 1}
    at abits 2)."""
    from qnx_torch.kernels.i8_conv_fused import act_epilogue, i8_conv_fused_ref
    from qnx_torch.nn.int8_engine import I8DenseLogits, I8MLP

    if isinstance(model, I8MLP):
        x8, convs, denses = model.first(x.reshape(x.shape[0], -1)), [], model.hidden
    else:
        x8, convs, denses = model.first(x), model.convs, model.denses
    want = {"zo": {0, 1}, "tanh": {-1, 0, 1} if model.first.nb == 2 else None}.get(
        model.first.act)
    check_values(torch, "first", x8, want)
    for i, conv in enumerate(convs, 1):
        got = conv(x8)
        x8 = i8_conv_fused_ref(x8, conv.w8, conv.sgn, conv.tau,
                               encoding=conv.act, pool=conv.pool)
        compare(torch, err, "i8_conv3x3_fused", got, x8, False, f"conv_{i}")
        check_values(torch, f"conv_{i}", x8, want)
    x8 = x8.reshape(x8.shape[0], -1)
    for j, dense in enumerate(denses):
        got = dense(x8)
        x8 = act_epilogue(dense.act, exact_dot(torch, x8, dense.w8), dense.sgn,
                          dense.tau)
        check_codes(torch, f"dense_{j} codes", got, x8)
        check_values(torch, f"dense_{j}", x8, want)
    head = model.head
    if isinstance(head, I8DenseLogits):
        s = exact_dot(torch, x8, head.w8)
        check_codes(torch, "head int32 s", head.scores(x8), s)
        return head.logits(s)
    return head(x8)


def plain_relu_forward(torch, model, x, err: dict):
    """The relu network type's VGG (``I8WConv``, ``I8WDense``, ``I8WHead``)
    in float64 on the card, the same layers in the same order: the weights
    dequantized, the 'SAME' conv, bias, pool, BN and relu; every hidden
    layer's output has zeros and positives.  No kernel of the repo runs
    here, so ``err`` is not touched."""
    import torch.nn.functional as F

    def bn(layer, y):
        mul = torch.rsqrt(layer.bn_var.double() + layer.bn_eps) * layer.bn_scale.double()
        return (y - layer.bn_mean.double()) * mul + layer.bn_bias.double()

    def dense(layer, a):
        y = a @ (layer.w.double() * layer.alpha.double())
        return y if layer.bias is None else y + layer.bias.double()

    a = x.double()
    for i, layer in enumerate([model.first, *model.convs]):
        w = layer.w.double() * layer.alpha.double()
        y = F.conv2d(a.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
        y = y.permute(0, 2, 3, 1)
        if layer.bias is not None:
            y = y + layer.bias.double()
        if layer.pool:
            b, h, wd, c = y.shape
            y = y.reshape(b, h // 2, 2, wd // 2, 2, c).amax(dim=(2, 4))
        a = torch.relu(bn(layer, y))
        check_values(torch, f"conv_{i}", torch.sign(a), {0.0, 1.0})
    a = a.reshape(a.shape[0], -1)
    for j, layer in enumerate(model.denses):
        a = torch.relu(bn(layer, dense(layer, a)))
        check_values(torch, f"dense_{j}", torch.sign(a), {0.0, 1.0})
    return bn(model.head, dense(model.head, a)).float()


def phase_slices(torch, err: dict):
    """Serve every path; returns the models and the summed launch counts."""
    from qnx_torch.convert.pack_model import (pack_int8, pack_mlp, pack_vgg,
                                              pack_vgg_bitplane)
    from qnx_torch.models.factory import init_variables
    from qnx_torch.utils.config import (CIFAR10_BNN, CIFAR10_TNN, MNIST_BNN,
                                        MNIST_TNN)

    models, launches = {}, dict.fromkeys(KERNELS, 0)
    paths = [("cifar10_bnn", CIFAR10_BNN, pack_vgg, plain_vgg_forward,
              {"xnor_conv3x3_fused": 5, "xnor_dense_fused": 2}),
             ("mnist_bnn", MNIST_BNN, pack_mlp, plain_mlp_forward,
              {"xnor_dense_fused": 2, "xnor_head": 1}),
             ("mnist_tnn", MNIST_TNN, pack_mlp, plain_mlp_forward,
              {"ternary_dense_fused": 2, "ternary_head": 1}),
             ("cifar10_bnn_int8", CIFAR10_BNN, pack_int8, plain_i8_forward,
              {"i8_conv3x3_fused": 5}),
             ("cifar10_tnn_int8", CIFAR10_TNN, pack_int8, plain_i8_forward,
              {"i8_conv3x3_fused": 5}),
             ("mnist_bnn_int8", MNIST_BNN, pack_int8, plain_i8_forward, {}),
             ("cifar10_tnn", CIFAR10_TNN, pack_vgg_bitplane, plain_plane_forward,
              {"plane_conv3x3_fused": 5, "plane_dense_fused": 2}),
             ("cifar10_tnn_a3", CIFAR10_TNN.replace(abits=3, last_layer_float=False),
              pack_vgg_bitplane, plain_plane_forward,
              {"plane_conv3x3_fused": 5, "plane_dense_fused": 2, "plane_head": 1}),
             ("cifar10_tnn_a1", CIFAR10_TNN.replace(abits=1), pack_vgg,
              plain_vgg_forward,
              {"ternary_conv3x3_fused": 5, "ternary_dense_fused": 2})]
    paths += activation_paths()
    for name, cf, pack, plain_forward, per_batch in paths:
        model = pack(init_variables(cf, seed=0), cf)  # on the card by default
        if not all(t.is_cuda for t in model.buffers()):
            raise AssertionError(f"{name}: the converter's default is not the card")
        gold = golden(name)
        tol = ((RELU_LOGIT_RTOL, RELU_LOGIT_ATOL_REL)
               if plain_forward is plain_relu_forward else
               (LOGIT_RTOL, LOGIT_ATOL_REL))
        counts = serve(torch, f"slice {name}", model, requests(cf, gold),
                       per_batch, plain_forward, err, gold, tol)
        for k, v in counts.items():
            launches[k] += v
        models[name] = model
    return models, launches


def activation_paths() -> list:
    """The five paths of the other activations and the wbits > 1 network
    types, as :func:`phase_slices` takes them: (golden name, config,
    converter, plain forward, launches a batch)."""
    from qnx_torch.convert.pack_model import pack_int8, pack_vgg_bitplane
    from qnx_torch.utils.config import CIFAR10_BNN, CIFAR10_TNN

    tanh = CIFAR10_TNN.replace(activation="quantized_tanh")
    e5 = {"i8_conv3x3_fused": 5}
    return [("cifar10_bnn_zo_int8", CIFAR10_BNN.replace(activation="binary_sigmoid"),
             pack_int8, plain_i8_forward, e5),
            ("cifar10_tnn_tanh_int8", tanh, pack_int8, plain_i8_forward, e5),
            ("cifar10_qnn_int8", CIFAR10_TNN.replace(network_type="full-qnn",
                                                      wbits=4),
             pack_int8, plain_i8_forward, e5),
            ("cifar10_qnn_relu_int8", CIFAR10_BNN.replace(network_type="qnn",
                                                           wbits=4),
             pack_int8, plain_relu_forward, {}),
            ("cifar10_tnn_tanh", tanh, pack_vgg_bitplane, plain_plane_forward,
             {"plane_conv3x3_fused": 5, "plane_dense_fused": 2})]


# the CLI phase's artifacts: (golden name, preset, engine, model type,
# kernel launches a batch)
CLI_ARTIFACTS = [
    ("cifar10_bnn_int8", "cifar10-bnn", "int8", "I8VGG", {"i8_conv3x3_fused": 5}),
    ("cifar10_bnn", "cifar10-bnn", "packed", "PackedVGG",
     {"xnor_conv3x3_fused": 5, "xnor_dense_fused": 2}),
    ("cifar10_tnn", "cifar10-tnn", "packed", "PlaneVGG",
     {"plane_conv3x3_fused": 5, "plane_dense_fused": 2}),
    ("mnist_bnn", "mnist-bnn", "packed", "PackedMLP",
     {"xnor_dense_fused": 2, "xnor_head": 1}),
    ("mnist_tnn", "mnist-tnn", "packed", "PackedMLP",
     {"ternary_dense_fused": 2, "ternary_head": 1}),
]
CLI_REQUESTS = 2048  # serve's default: 8 batches of SERVE_BATCH
CLI_CHECK = 512  # requests of the host-normalisation and mixed-batch checks


def cli(args: list[str]) -> str:
    """``python3 -m qnx_torch ARGS`` from the checkout; its stdout."""
    proc = subprocess.run([sys.executable, "-m", "qnx_torch", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"python3 -m qnx_torch {' '.join(args)} exited "
                             f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    return proc.stdout


def assert_same_buffers(label: str, got, want) -> None:
    """Every buffer of two modules: same names, dtypes, strides and bytes."""
    a, b = got.state_dict(), want.state_dict()
    if list(a) != list(b):
        raise AssertionError(f"{label}: buffers {list(a)} != {list(b)}")
    for name in a:
        if (a[name].dtype, a[name].stride()) != (b[name].dtype, b[name].stride()) \
                or not a[name].equal(b[name]):
            raise AssertionError(f"{label}: buffer {name} differs")


def serve_bits(torch, model, chunks, device_normalize=True):
    """Logits of ``chunks`` queued before the start, through the engine with
    the CLI's forward, as int32 bit patterns."""
    from qnx_torch.__main__ import _engine_forward
    from qnx_torch.serve.engine import ServeEngine

    engine = ServeEngine(model, batch_size=SERVE_BATCH, max_wait_ms=50.0,
                         forward=_engine_forward(model),
                         device_normalize=device_normalize)
    futs = [f for c in chunks for f in engine.submit_many(c)]
    with engine:
        return np.stack([f.result(timeout=600) for f in futs]).view(np.int32)


def phase_cli(torch, card: str, models: dict, device: str = "cuda") -> dict:
    """The CLI: the five artifacts of :data:`CLI_ARTIFACTS` built by
    ``_pack_for_engine`` from ``init_variables(cf, 0)`` at full width (their
    buffers equal to the slices' models), written by ``convert``'s writer,
    each served by ``python3 -m qnx_torch serve`` in a process of its own
    (every request answered, its kernel launches = layers x batches); the
    loaded artifact's logits on the golden images equal to the in-memory
    module's; ``device_normalize=False`` (the native host runtime, which
    must have built) and a batch mixing uint8 and float32 chunks equal to
    the device's normalisation bit for bit; and, where h5py is installed,
    ``convert --h5`` of the full-width ``cifar10-bnn`` into both engines,
    every buffer equal to a direct ``pack_int8`` and ``pack_vgg``.  Returns
    the served launch counts."""
    import importlib.util
    import tempfile

    from qnx_torch import native
    from qnx_torch.__main__ import _pack_for_engine, load_artifact, save_artifact
    from qnx_torch.models.factory import init_variables
    from qnx_torch.serve.engine import normalize_u8
    from qnx_torch.utils.config import CONFIGS

    if not native.available():
        raise AssertionError("the native host runtime (qnx_torch/native) did "
                             "not build: g++ is expected on this machine")
    log("cli", "native host runtime built (g++, qnx_torch/native/_build)")
    launches = dict.fromkeys(KERNELS, 0)
    with tempfile.TemporaryDirectory(prefix="qnx_torch_cli_") as tmp:
        for name, preset, engine, type_name, per_batch in CLI_ARTIFACTS:
            cf = CONFIGS[preset]
            label = f"{engine} {preset}"
            model = _pack_for_engine(init_variables(cf, 0), cf, engine, device)
            if type(model).__name__ != type_name:
                raise AssertionError(f"{label}: {type(model).__name__}, "
                                     f"not {type_name}")
            assert_same_buffers(label, model, models[name])
            path = str(Path(tmp) / f"{name}.pt")
            save_artifact(path, model, cf, engine)
            shape = ",".join(map(str, cf.input_shape))
            t0 = time.perf_counter()
            out = cli(["serve", "--model", path, "--batch-size", str(SERVE_BATCH),
                       "--requests", str(CLI_REQUESTS), "--input-shape", shape,
                       "--device", device])
            wall = time.perf_counter() - t0
            stats = json.loads(out[out.index("{"):])
            batches = -(-CLI_REQUESTS // SERVE_BATCH)
            want = {k: v * batches for k, v in per_batch.items()}
            if (stats["images"], stats["batches"]) != (CLI_REQUESTS, batches):
                raise AssertionError(f"{label}: served {stats['images']} images "
                                     f"in {stats['batches']} batches")
            if stats["launches"] != want:
                raise AssertionError(f"{label}: launches {stats['launches']} "
                                     f"!= {want}")
            for k, v in stats["launches"].items():
                launches[k] += v
            log("cli", f"{card} | python3 -m qnx_torch serve {label} "
                f"({type_name}, {os.path.getsize(path) / 2**20:.1f} MiB "
                f"artifact): {stats['images']} requests in {stats['batches']} "
                f"batches of {SERVE_BATCH}: wall_throughput_ips "
                f"{stats['wall_throughput_ips']:.1f}, throughput_ips "
                f"{stats['throughput_ips']:.1f}, latency p50 "
                f"{stats['latency_ms_p50']:.1f} ms; launches "
                f"{stats['launches']}; process {wall:.1f} s")

            loaded = load_artifact(path, device)["model"]
            assert_same_buffers(f"{label} artifact", loaded, model)
            gold = golden(name)
            with torch.inference_mode():
                x = normalize_u8(torch.from_numpy(gold["images"]).to(device))
                got, mem = loaded(x), model(x)
            if not torch.equal(got, mem):
                raise AssertionError(f"{label}: the loaded artifact's logits "
                                     f"differ from the in-memory module's")
            got = got.cpu().numpy()
            np.testing.assert_allclose(
                got, gold["logits"], rtol=LOGIT_RTOL,
                atol=LOGIT_ATOL_REL * float(np.abs(gold["logits"]).max()))
            if not (got.argmax(-1) == gold["logits"].argmax(-1)).all():
                raise AssertionError(f"{label}: argmax differs from the golden")

            u8 = np.random.default_rng(5).integers(
                0, 256, (CLI_CHECK, *cf.input_shape), dtype=np.uint8)
            a, b = CLI_CHECK // 5, 3 * CLI_CHECK // 5  # chunks that split
            chunks = [u8[:a], u8[a:b], u8[b:]]
            on_device = serve_bits(torch, loaded, chunks)
            on_host = serve_bits(torch, loaded, chunks, device_normalize=False)
            f32 = native.u8_to_f32(u8)
            mixed = serve_bits(torch, loaded, [u8[:a], f32[a:b], u8[b:]])
            pre = serve_bits(torch, loaded, [f32])
            for what, bits in (("device_normalize=False", on_host),
                               ("the mixed batch", mixed),
                               ("the pre-normalised images", pre)):
                if not np.array_equal(bits, on_device):
                    raise AssertionError(f"{label}: {what} differs from the "
                                         f"device's normalisation")
            log("cli", f"{label}: artifact buffers and golden logits equal to "
                f"the in-memory module's; {CLI_CHECK} requests normalised on "
                f"the host (native), in a mixed uint8/float32 batch and "
                f"pre-normalised give the device path's logits bit for bit")

        if importlib.util.find_spec("h5py") is None:
            log("cli", "convert --h5 not run on this machine: h5py is not "
                "installed (its parity rests on tests/test_torch_keras_h5.py "
                "and tests/test_torch_cli.py)")
        else:
            cli_h5(tmp, {"int8": models["cifar10_bnn_int8"],
                         "packed": models["cifar10_bnn"]}, device)
    return launches


def cli_h5(tmp: str, direct: dict, device: str) -> None:
    """``convert --h5`` of the full-width ``cifar10-bnn`` into both engines;
    every buffer equal to the direct converters' (``direct``: engine ->
    module built from ``init_variables(cf, 0)``)."""
    from qnx_torch.__main__ import load_artifact
    from qnx_torch.convert.keras_h5 import write_legacy_h5
    from qnx_torch.models.factory import init_variables
    from qnx_torch.utils.config import CONFIGS

    v = init_variables(CONFIGS["cifar10-bnn"], 0)
    p, st = v["params"], v["batch_stats"]
    layers = []
    for cn, bn in zip([f"conv_{i}" for i in range(6)] + ["dense_0", "dense_1",
                                                         "dense_out"],
                      [f"bn_conv_{i}" for i in range(6)] + ["bn_dense_0",
                                                            "bn_dense_1", "bn_out"]):
        layers.append((cn, [(f"{cn}/{k}:0", p[cn][k]) for k in ("kernel", "bias")
                            if k in p[cn]]))
        layers.append((bn, [(f"{bn}/gamma:0", p[bn]["scale"]),
                            (f"{bn}/beta:0", p[bn]["bias"]),
                            (f"{bn}/moving_mean:0", st[bn]["mean"]),
                            (f"{bn}/moving_variance:0", st[bn]["var"])]))
    h5 = str(Path(tmp) / "cifar10_bnn.h5")
    write_legacy_h5(h5, layers)
    for engine, want in direct.items():
        out = str(Path(tmp) / f"h5_{engine}.pt")
        cli(["convert", "--h5", h5, "--config", "cifar10-bnn", "--engine", engine,
             "--out", out, "--device", device])
        assert_same_buffers(f"convert --h5 --engine {engine}",
                            load_artifact(out, device)["model"], want)
    log("cli", "convert --h5 of the full-width cifar10-bnn (legacy layout): "
        "the int8 and packed artifacts' buffers equal a direct pack_int8 and "
        "pack_vgg byte for byte")


def phase_measure(torch) -> dict:
    """The measurement path: the three experiments' ``main`` and the
    roofline on the card with :data:`MEASURE_REPEATS`, every count set to 0
    just before and read just after.  The shootout holds every candidate
    against kernel B at its full shapes (B is held against its plain
    version in phase 3).  Returns the launch counts."""
    from qnx_torch.bench import roofline
    from qnx_torch.experiments import gemm_shootout, vpu_probe, xnor_sol_variants
    from qnx_torch.kernels import launch_counters

    counted = launch_counters()
    for w in counted.values():
        w.launches = 0
    t0 = time.perf_counter()
    shoot = gemm_shootout.main(**MEASURE_REPEATS)
    sol = xnor_sol_variants.main(**MEASURE_REPEATS)
    probe = vpu_probe.main(iters=16, repeats=3)
    roof = roofline.main(**MEASURE_REPEATS)
    launches = {name: w.launches for name, w in counted.items()}
    log("measure", f"{len(shoot)} shootout rows ({sum(not r['fits'] for r in shoot)} "
        f"do not fit, every other equal to kernel B), {len(sol)} scan rows, "
        f"{len(probe)} probe modes, {len(roof)} roofline rows in "
        f"{time.perf_counter() - t0:.1f} s; launches {launches}")
    missing = [name for name in MEASURED if not launches[name]]
    if missing:
        raise AssertionError(f"the measurement path launched no {missing}")
    return launches


def time_ms(torch, fn, iters: int, reps: int = 7) -> list[float]:
    """Per-call ms of ``fn`` from CUDA events around ``iters`` calls, ``reps``
    times, after a warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return out


def fmt(ms: list[float]) -> str:
    return (f"median {statistics.median(ms):.4f} ms "
            f"(min {min(ms):.4f}, max {max(ms):.4f}, n={len(ms)})")


def phase_times(torch, card: str, models: dict) -> dict:
    """Each kernel against its plain version and its library call,
    interleaved (plain, kernel, library, library, kernel, plain).  ``total``
    sums, per kernel, the medians and the bound over every layer of every
    path at batch 256 (a per-forward figure of each path, summed over the
    paths; kernel E's over the five int8 VGGs: pm1, levels, zo, tanh, and
    levels on 4-bit grid weights; D's over the three bit-plane VGGs: one
    plane, two, and tanh mode's two with the border term, its convs also
    timed without the term, outside the sums; the heads' logits, their
    int32 s aside), the measurement path's kernels (B and C among them) at
    one call at the scan shape."""
    rng = np.random.default_rng(11)
    total = {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                        ops_bound_ms=0.0, bytes_bound_ms=0.0, graph_ms=0.0,
                        library_graph_ms=0.0) for name in KERNELS}
    b = TIME_BATCH
    # (kind, batch, shape, layers of this shape in the served paths)
    cases = [("conv", b, s, 1) for s in CONV_SHAPES]
    cases += [("dense", b, s, 1) for s in DENSE_SHAPES]
    cases += [("dense", b, MLP_HIDDEN, 2), ("ternary_dense", b, MLP_HIDDEN, 2)]
    # the served heads: the logits (one launch each) and the int32 s; B and
    # C at the MLP head's shape, for comparison
    cases += [(kind, b, (*shape, out), int(out == "logits"))
              for out in ("logits", "s")
              for kind, shape in (("head", MLP_HEAD), ("ternary_head", MLP_HEAD),
                                  ("plane_head-2", PLANE_HEAD))]
    cases += [("popcount", b, MLP_HEAD, 0), ("ternary", b, MLP_HEAD, 0)]
    cases += [(kind, b, s, 1) for kind in I8_SERVED for s in CONV_SHAPES]
    cases += [("ternary_dense", SCAN[0], SCAN[1], 0)]
    cases += [(kind, SCAN[0], SCAN[1], 1) for kind in ("popcount", "ternary")]
    # the ternary VGG's A' layers, and D at the bit-plane VGGs' layers: one
    # plane and one threshold, then two planes, three thresholds and the head
    cases += [(kind, b, s, 1) for kind, shapes in (("ternary_conv", CONV_SHAPES),
                                                   ("ternary_dense", DENSE_SHAPES))
              for s in shapes]
    cases += [(f"plane_{layer}-{pt}", b, s, 1) for pt in ("1-1", "2-3")
              for layer, shapes in (("conv", CONV_SHAPES), ("dense", DENSE_SHAPES))
              for s in shapes]
    # the tanh bit-plane VGG: two planes, two thresholds, the border term;
    # its convs also without the border term, in turns with it
    for s in CONV_SHAPES:
        cases += [("plane_conv-2-2-corr", b, s, 1), ("plane_conv-2-2", b, s, 0)]
    cases += [("plane_dense-2-2", b, s, 1) for s in DENSE_SHAPES]
    # the measurement path's kernels: each formulation's default geometry
    # at the scan shape, H's popc chain at the JAX probe's size
    cases += [(kind, SCAN[0], SCAN[1], 1) for kind in MEASURED_TIMED]
    cases.append(("int_chain-pc-96", None, PROBE_SHAPE, 1))
    for kind, m, shape, layers in cases:
        case = make_case(torch, rng, kind, m, shape)
        lib = None if case.mkn is None else int_mm_call(torch, rng, *case.mkn,
                                                        **case.lib)
        p1, k1 = time_ms(torch, case.plain, 3, 3), time_ms(torch, case.kern, 20, 4)
        if lib:
            lt = time_ms(torch, lib, 20, 4) + time_ms(torch, lib, 20, 4)
        k2, p2 = time_ms(torch, case.kern, 20, 4), time_ms(torch, case.plain, 3, 3)
        kt, pt = k1 + k2, p1 + p2
        ops_ms, bytes_ms = case.bound(case.kern())
        t = total[case.name]
        t["ms"] += layers * statistics.median(kt)
        t["plain_ms"] += layers * statistics.median(pt)
        if lib:
            t["library_ms"] += layers * statistics.median(lt)
            lib_txt = (f"library torch._int_mm {case.mkn} (int8 GEMM only, no "
                       f"epilogue or pool) {fmt(lt)}")
        else:
            t["library_ms"], lib_txt = None, "no library call computes it"
        t["bound_ms"] += layers * max(ops_ms, bytes_ms)
        t["ops_bound_ms" if ops_ms >= bytes_ms else "bytes_bound_ms"] += (
            layers * max(ops_ms, bytes_ms))
        graph_txt = ""
        if case.name in GRAPH_NAMES:  # calls shorter than a host launch
            g = graph_ms(case.kern, lib)
            t["graph_ms"] += layers * g["kernel"]["median"]
            t["library_graph_ms"] += layers * g["library"]["median"]
            split = dense_split(torch, case.name, m, shape)
            graph_txt = ("; CUDA graph replays: " + "; ".join(
                f"{what} {fmt_graph(g[what])}" for what in ("kernel", "library"))
                + f"; factor {g['kernel']['median'] / g['library']['median']:.3f}"
                + (f"; K split over {split} blocks" if split else ""))
        log("times", f"{card} | {case.name} {kind} batch {m} {shape}: kernel "
            f"{fmt(kt)}; plain {fmt(pt)}; {lib_txt}; bound "
            f"{max(ops_ms, bytes_ms):.4f} ms (operations {ops_ms:.4f}, bytes "
            f"{bytes_ms:.4f}){graph_txt}")
        planes = int(kind.split("-")[1]) if kind.startswith("plane_") else 1
        l2 = tile_bytes(case.name, m, shape, planes) if layers else None
        if l2:
            log("times", f"{case.name} {kind} batch {m} {shape}: its blocks copy "
                f"{l2 / 1e6:.1f} MB from L2 for {case.macs / 1e9:.2f} GMAC "
                f"({case.macs / l2:.0f} MAC a byte), "
                f"{l2 / 1e9 / statistics.median(kt):.2f} TB/s at the "
                f"kernel's median")

    for name, model in models.items():
        shape = (b, 32, 32, 3) if name.startswith("cifar") else (b, 28, 28, 1)
        x = cuda(torch, np.random.default_rng(12).uniform(-1, 1, shape)
                 .astype(np.float32))
        with torch.inference_mode():
            fwd = time_ms(torch, lambda: model(x), 10)
        med = statistics.median(fwd)
        log("times", f"{card} | end-to-end {type(model).__name__} {name} "
            f"forward batch {b}: {fmt(fwd)} = {b / med * 1e3:.1f} img/s")
    log("times", f"{card} | per forward at batch {b}, summed over the paths' "
        f"layer shapes (the measurement path's kernels at one call): " + "; ".join(
            f"{k} kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.4f} ms, "
            f"library {v['library_ms'] or 0:.4f} ms, bound {v['bound_ms']:.4f} ms"
            + (f", graph replays kernel {v['graph_ms']:.4f} ms, library "
               f"{v['library_graph_ms']:.4f} ms" if k in GRAPH_NAMES else "")
            for k, v in total.items()))
    return total


def graph_ms(kern: Callable, lib: Callable, iters: int = 20, repeats: int = 7) -> dict:
    """The marginal device time of a call of ``kern`` and of ``lib`` as CUDA
    graph replays (:func:`qnx_torch.bench.microbench.time_fns_marginal_interleaved`
    with ``graph=True``: no host launch in the timed chain), interleaved;
    ``{"kernel"|"library": summary}`` in ms."""
    from qnx_torch.bench.microbench import time_fns_marginal_interleaved

    out = time_fns_marginal_interleaved(
        {"kernel": (kern, ()), "library": (lib, ())}, iters=iters,
        repeats=repeats, graph=True)
    return {what: dict(r, t=r["t"] * 1e3, median=r["median"] * 1e3,
                       samples=[v * 1e3 for v in r["samples"]])
            for what, r in out.items()}


def fmt_graph(r: dict) -> str:
    return (f"median {r['median']:.4f} ms (min-based {r['t']:.4f}, spread "
            f"{r['spread']:.3f}, n={len(r['samples'])})")


def phase_twin(torch, card: str, model, relu_model) -> None:
    """The int8 VGG (``cifar10-bnn``) and the relu network type's VGG
    (``qnn``, 4-bit weights, float relu activations) against the
    strict-f32 float twin, TF32 off, at batch 256 and 1024 (``bench.py``'s
    batch), interleaved (f32, int8, qnn, qnn, int8, f32); median and spread
    of each, and their ratios."""
    from qnx_torch.bench.float_baseline import (float_forward, float_variables,
                                                strict_f32)
    from qnx_torch.models.factory import init_variables
    from qnx_torch.utils.config import CIFAR10_BNN

    fcf = CIFAR10_BNN.replace(network_type="float")
    fvars = float_variables(init_variables(fcf, seed=0), "cuda")
    rng = np.random.default_rng(14)
    for b in TWIN_BATCHES:
        x = cuda(torch, rng.uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32))

        def twin():
            with strict_f32():
                return float_forward(fvars, fcf, x)

        with torch.inference_mode():
            out = twin()
            if out.shape != (b, 10) or not torch.isfinite(out).all():
                raise AssertionError(f"float twin: bad logits {tuple(out.shape)}")
            f1, i1 = time_ms(torch, twin, 3, 5), time_ms(torch, lambda: model(x), 5, 5)
            r1 = time_ms(torch, lambda: relu_model(x), 3, 5)
            r2 = time_ms(torch, lambda: relu_model(x), 3, 5)
            i2, f2 = time_ms(torch, lambda: model(x), 5, 5), time_ms(torch, twin, 3, 5)
        f, i, r = f1 + f2, i1 + i2, r1 + r2
        fm, im, rm = statistics.median(f), statistics.median(i), statistics.median(r)
        log("twin", f"{card} | batch {b}: strict-f32 twin {fmt(f)} "
            f"(spread {(max(f) - min(f)) / fm:.3f}); int8 I8VGG {fmt(i)} "
            f"(spread {(max(i) - min(i)) / im:.3f}); relu qnn I8VGG {fmt(r)} "
            f"(spread {(max(r) - min(r)) / rm:.3f})")
        print(f"{card} | int8 VGG cifar10-bnn against the strict-f32 twin, "
              f"batch {b}: {fm / im:.3f}x the twin's img/s "
              f"({b / im * 1e3:.1f} against {b / fm * 1e3:.1f})", flush=True)
        print(f"{card} | relu qnn VGG (4-bit weights) against the strict-f32 "
              f"twin, batch {b}: {fm / rm:.3f}x the twin's img/s "
              f"({b / rm * 1e3:.1f} against {b / fm * 1e3:.1f})", flush=True)


def time_stages(torch, card: str, label: str, model, x, stages) -> None:
    """Each stage alone, the whole forward, and its peak memory."""
    with torch.inference_mode():
        parts = 0.0
        for name, fn in stages:
            ms = time_ms(torch, fn, 20)
            parts += statistics.median(ms)
            log("stages", f"{card} | {label} {name} batch {TIME_BATCH}: {fmt(ms)}")
        whole = time_ms(torch, lambda: model(x), 20)
        log("stages", f"{card} | {label} whole forward batch {TIME_BATCH}: "
            f"{fmt(whole)}; sum of the stage medians {parts:.4f} ms")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        model(x)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    weights = sum(t.numel() * t.element_size() for t in model.buffers())
    log("stages", f"{card} | {label} peak device memory allocated over one "
        f"forward at batch {TIME_BATCH}: {peak / 2**20:.1f} MiB, of which "
        f"{(peak - before) / 2**20:.1f} MiB above what was allocated before "
        f"it (all models, inputs and stage tensors; this model's buffers "
        f"{weights / 2**20:.1f} MiB)")


def engine_rate(card: str, label: str, model, rng, image_shape) -> None:
    """The engine over ENGINE_BATCHES full batches queued at once (host
    clock, first dispatch to last answer)."""
    from qnx_torch.serve.engine import ServeEngine

    images = rng.integers(0, 256, (ENGINE_BATCHES * SERVE_BATCH, *image_shape),
                          dtype=np.uint8)
    engine = ServeEngine(model, batch_size=SERVE_BATCH, max_wait_ms=50.0)
    futs = [f for s in range(0, len(images), SERVE_BATCH)
            for f in engine.submit_many(images[s:s + SERVE_BATCH])]
    with engine:  # queued before start: every batch is full
        for f in futs:
            f.result(timeout=600)
    st = engine.stats()
    log("stages", f"{card} | {label} engine, {st['batches']} batches of "
        f"{SERVE_BATCH} queued at once: {st['wall_throughput_ips']:.1f} img/s "
        f"host clock from first dispatch to last answer; "
        f"{st['throughput_ips']:.1f} img/s over the batches' busy time; "
        f"latency p50 {st['latency_ms_p50']:.1f} ms, p99 "
        f"{st['latency_ms_p99']:.1f} ms (queueing included)")


def phase_stages(torch, card: str, models: dict) -> None:
    """Where the time goes at batch 256: each stage of the packed VGGs
    (binary and ternary), mnist-bnn, int8 and bit-plane forwards alone on
    their own activations, peak memory, and the engine."""
    from qnx_torch.ops.packing import pack_bits
    from qnx_torch.serve.engine import normalize_u8

    b = TIME_BATCH
    rng = np.random.default_rng(13)
    for label in ("cifar10_bnn", "cifar10_tnn_a1"):
        stages_packed(torch, card, label, models[label], rng)

    model = models["mnist_bnn"]
    u8 = cuda(torch, rng.integers(0, 256, (b, 28, 28, 1), dtype=np.uint8))
    first, head = model.first, model.head
    with torch.inference_mode():
        x = normalize_u8(u8)
        flat = x.reshape(b, -1)
        y = first.dense(flat)
        z = first._bn(y)
        stages = [("normalize_u8", lambda: normalize_u8(u8)),
                  ("first: cuBLAS sgemm + bias", lambda: first.dense(flat)),
                  ("first: BN", lambda: first._bn(y)),
                  ("first: sign + pack_bits", lambda: pack_bits(z, axis=-1))]
        bits = first(flat)
        for i, layer in enumerate(model.hidden, 1):
            stages.append((f"dense_{i} kernel", lambda l=layer, a=bits: l(a)))
            bits = layer(bits)
        stages += [("head kernel: int32 s", lambda a=bits: head.scores(a)),
                   ("head kernel: logits", lambda a=bits: head(a))]
    time_stages(torch, card, "mnist_bnn", model, x, stages)
    engine_rate(card, "mnist_bnn", model, rng, (28, 28, 1))

    stages_int8(torch, card, models["cifar10_bnn_int8"], rng)
    for label in ("cifar10_tnn", "cifar10_tnn_tanh"):
        stages_plane(torch, card, label, models[label], rng)
    for name, *_ in activation_paths():
        if name != "cifar10_tnn_tanh":
            engine_rate(card, name, models[name], rng, (32, 32, 3))


def stages_packed(torch, card: str, label: str, model, rng) -> None:
    """Each stage of a batch-256 packed VGG (binary ``cifar10-bnn``: kernel
    A; ternary ``cifar10_tnn_a1``: A'): the float first layer, each conv
    and dense kernel, the float head; then the engine."""
    from qnx_torch.ops.packing import pack_bits
    from qnx_torch.serve.engine import normalize_u8

    b = TIME_BATCH
    u8 = cuda(torch, rng.integers(0, 256, (b, 32, 32, 3), dtype=np.uint8))
    first = model.first
    with torch.inference_mode():
        x = normalize_u8(u8)
        y = first.conv(x)
        z = first._bn(y)
        stages = [("normalize_u8", lambda: normalize_u8(u8)),
                  ("first: cuDNN conv + bias", lambda: first.conv(x)),
                  ("first: BN", lambda: first._bn(y)),
                  ("first: sign + pack_bits", lambda: pack_bits(z, axis=-1))]
        bits = first(x)
        for i, conv in enumerate(model.convs, 1):
            stages.append((f"conv_{i} kernel", lambda l=conv, a=bits: l(a)))
            bits = conv(bits)
        bits = bits.reshape(b, -1)
        for j, dense in enumerate(model.denses):
            stages.append((f"dense_{j} kernel", lambda l=dense, a=bits: l(a)))
            bits = dense(bits)
        stages.append(("head: unpack + sgemm + BN", lambda a=bits: model.head(a)))
    time_stages(torch, card, label, model, x, stages)
    engine_rate(card, label, model, rng, (32, 32, 3))


def stages_int8(torch, card: str, model, rng) -> None:
    """Each stage of the batch-256 int8 VGG (``cifar10-bnn``): the float
    first layer, each kernel E conv, each dense layer's ``_int_mm`` and its
    epilogue, the float head; then the engine."""
    from qnx_torch.kernels.i8_conv_fused import act_epilogue
    from qnx_torch.nn.int8_engine import _encode_float
    from qnx_torch.serve.engine import normalize_u8

    b = TIME_BATCH
    u8 = cuda(torch, rng.integers(0, 256, (b, 32, 32, 3), dtype=np.uint8))
    first = model.first
    with torch.inference_mode():
        x = normalize_u8(u8)
        y = first.conv(x)
        z = first._bn(y)
        stages = [("normalize_u8", lambda: normalize_u8(u8)),
                  ("first: cuDNN conv + bias", lambda: first.conv(x)),
                  ("first: BN", lambda: first._bn(y)),
                  ("first: encode int8 codes",
                   lambda: _encode_float(first.act, z, first.nb))]
        x8 = first(x)
        for i, conv in enumerate(model.convs, 1):
            stages.append((f"conv_{i} kernel E", lambda l=conv, a=x8: l(a)))
            x8 = conv(x8)
        x8 = x8.reshape(b, -1)
        for j, dense in enumerate(model.denses):
            s = dense.scores(x8)
            stages += [(f"dense_{j} torch._int_mm", lambda l=dense, a=x8: l.scores(a)),
                       (f"dense_{j} epilogue", lambda l=dense, a=s:
                        act_epilogue(l.act, a, l.sgn, l.tau))]
            x8 = dense(x8)
        stages.append(("head: codes * q + sgemm + BN", lambda a=x8: model.head(a)))
    time_stages(torch, card, "cifar10_bnn_int8", model, x, stages)
    engine_rate(card, "cifar10_bnn_int8", model, rng, (32, 32, 3))


def stages_plane(torch, card: str, label: str, model, rng) -> None:
    """Each stage of a batch-256 bit-plane VGG (``cifar10-tnn``, in relu
    mode and in tanh mode): the float first layer, each kernel D conv and
    dense layer, the float head over the planes; then the engine."""
    from qnx_torch.serve.engine import normalize_u8

    b = TIME_BATCH
    u8 = cuda(torch, rng.integers(0, 256, (b, 32, 32, 3), dtype=np.uint8))
    first = model.first
    with torch.inference_mode():
        x = normalize_u8(u8)
        y = first.conv(x)
        z = first._bn(y)
        stages = [("normalize_u8", lambda: normalize_u8(u8)),
                  ("first: cuDNN conv + bias", lambda: first.conv(x)),
                  ("first: BN", lambda: first._bn(y)),
                  ("first: levels + planes", lambda: first.levels(z))]
        planes = first(x)
        for i, conv in enumerate(model.convs, 1):
            stages.append((f"conv_{i} kernel D", lambda l=conv, a=planes: l(a)))
            planes = conv(planes)
        planes = planes.reshape(planes.shape[0], b, -1)
        for j, dense in enumerate(model.denses):
            stages.append((f"dense_{j} kernel D", lambda l=dense, a=planes: l(a)))
            planes = dense(planes)
        stages.append(("head: planes to values + sgemm + BN",
                       lambda a=planes: model.head(a)))
    time_stages(torch, card, label, model, x, stages)
    engine_rate(card, label, model, rng, (32, 32, 3))


def ab_shapes(kind: str) -> list:
    """The shapes ``--ab`` times a kind at: the dense kinds (``dense``,
    ``ternary_dense``, ``plane_dense-P-T``) at the VGG's dense layers and
    the MLPs' hidden layer, the head kinds (``head``, ``ternary_head``,
    ``plane_head-P``) at their head shape, the int32 s and the logits, the
    conv kinds at the five VGG convs; a ``forward-PATH`` kind at its path."""
    prefix = kind.split("-")[0]
    if prefix == "forward":
        return [kind.split("-", 1)[1]]
    if prefix in ("dense", "ternary_dense", "plane_dense"):
        return [*DENSE_SHAPES, MLP_HIDDEN]
    if prefix in HEADS:
        shape = PLANE_HEAD if prefix == "plane_head" else MLP_HEAD
        return [(*shape, "s"), (*shape, "logits")]
    return CONV_SHAPES


def forward_case(torch, name: str):
    """The ``--ab`` kind ``forward-NAME``: the served path NAME's model
    (``mnist_bnn``, ``mnist_tnn``, ``cifar10_tnn_a3``) as the checkout's
    converter builds it from seed 0, a batch of TIME_BATCH of its
    normalized requests (the golden's first), and the golden logits."""
    from qnx_torch.convert.pack_model import pack_mlp, pack_vgg_bitplane
    from qnx_torch.models.factory import init_variables
    from qnx_torch.serve.engine import normalize_u8
    from qnx_torch.utils.config import CIFAR10_TNN, MNIST_BNN, MNIST_TNN

    cf, pack = {"mnist_bnn": (MNIST_BNN, pack_mlp),
                "mnist_tnn": (MNIST_TNN, pack_mlp),
                "cifar10_tnn_a3": (CIFAR10_TNN.replace(abits=3, last_layer_float=False),
                                   pack_vgg_bitplane)}[name]
    gold = golden(name)
    x = normalize_u8(cuda(torch, requests(cf, gold)[:TIME_BATCH]))
    return pack(init_variables(cf, seed=0), cf), x, gold["logits"]


def ab_child(kinds: str, root: str) -> int:
    """One run of ``--ab``: time each kind of ``kinds`` at its
    :func:`ab_shapes` at batch TIME_BATCH with the ``qnx_torch`` of
    checkout ``root``, per call (CUDA events around 20 calls, median of 7)
    and as CUDA graph replays (the marginal median of 7), after one call
    held against the plain version (a forward: its logits against the JAX
    golden's, within the slices' tolerance; per call only, since a
    forward's ``pack_bits`` copies its shift table from the host, which a
    graph cannot capture); print them as JSON."""
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    import torch
    import qnx_torch
    from qnx_torch.bench.microbench import time_fns_marginal_interleaved

    if not Path(qnx_torch.__file__).resolve().is_relative_to(root):
        raise AssertionError(f"imported {qnx_torch.__file__}, not {root}'s")
    rng = np.random.default_rng(0)
    out = {}
    for kind in kinds.split(","):
        row = out.setdefault(kind, {"ms": [], "graph_ms": [], "equal": True})
        for shape in ab_shapes(kind):
            if kind.startswith("forward-"):
                model, x, gold = forward_case(torch, shape)
                kern = lambda: model(x)
                got = kern()[:len(gold)].cpu().numpy()
                row["equal"] &= bool(np.allclose(
                    got, gold, rtol=LOGIT_RTOL,
                    atol=LOGIT_ATOL_REL * float(np.abs(gold).max())))
            else:
                case = make_case(torch, rng, kind, TIME_BATCH, shape)
                kern = case.kern
                row["equal"] &= bool(torch.equal(kern(), case.plain()))
            row["ms"].append(statistics.median(time_ms(torch, kern, 20)))
            if kind.startswith("forward-"):
                continue
            g = time_fns_marginal_interleaved({"kernel": (kern, ())}, iters=20,
                                              repeats=7, graph=True)
            row["graph_ms"].append(g["kernel"]["median"] * 1e3)
    print(json.dumps(out))
    return 0


def ab(kinds: str, roots: list[str]) -> int:
    """``--ab``: each checkout of ``roots`` in turn, each in a process of
    its own; one line per run and kind."""
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    failed = 0
    for i, root in enumerate(roots):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--ab-child", kinds, root], capture_output=True,
                              text=True, timeout=900)
        if proc.returncode != 0:  # the other checkouts still run
            failed += 1
            print(f"{card} | run {i} {root}: exit {proc.returncode}\n"
                  f"{proc.stderr[-3000:]}", flush=True)
            continue
        for kind, row in json.loads(proc.stdout.strip().splitlines()[-1]).items():
            shapes = ab_shapes(kind)
            print(f"{card} | run {i} {root}: {kind} at batch {TIME_BATCH}, "
                  f"shapes {shapes}: per call " + ", ".join(
                      f"{t:.4f}" for t in row["ms"]) + f" ms, sum "
                  f"{sum(row['ms']):.4f} ms; "
                  + (("graph replays " + ", ".join(
                      f"{t:.4f}" for t in row["graph_ms"]) + f" ms, sum "
                      f"{sum(row['graph_ms']):.4f} ms; ") if row["graph_ms"] else "")
                  + (f"{'' if row['equal'] else 'NOT '}within the slices' "
                     f"tolerance of the JAX golden" if kind.startswith("forward-")
                     else "equal to the plain version" if row["equal"]
                     else "DIFFERS from the plain version"), flush=True)
    return 1 if failed else 0


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: chip_smoke.py "
                           "needs one CUDA card")
    if argv[:1] == ["--ab"] and len(argv) > 2:
        return ab(argv[1], argv[2:])
    if argv[:1] == ["--ab-child"] and len(argv) == 3:
        return ab_child(argv[1], argv[2])
    if argv:
        raise SystemExit(f"usage: python3 chip_smoke.py [--ab KINDS DIR ...]; "
                         f"got {argv}")
    card = phase_device(torch)
    phase_build()
    err = dict.fromkeys(KERNELS, 0.0)
    phase_kernels(torch, err)
    models, launches = phase_slices(torch, err)
    for k, v in phase_cli(torch, card, models).items():
        launches[k] += v
    measured = phase_measure(torch)
    launches.update({name: measured[name] for name in MEASURED})
    total = phase_times(torch, card, models)
    phase_twin(torch, card, models["cifar10_bnn_int8"],
               models["cifar10_qnn_relu_int8"])
    phase_stages(torch, card, models)
    if any(m.split(".")[0] in ("jax", "jaxlib", "flax", "qnx") for m in sys.modules):
        raise AssertionError("the port imported jax or the JAX package")

    def bound_by(t: dict) -> str:
        return ("operations" if t["ops_bound_ms"] >= t["bytes_bound_ms"]
                else "bytes")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], "max_abs_err": err[name],
         "ms": total[name]["ms"], "plain_ms": total[name]["plain_ms"],
         "bound_ms": total[name]["bound_ms"], "bound_by": bound_by(total[name]),
         "library_ms": total[name]["library_ms"]}
        for name, (source, replaces) in KERNELS.items()]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
