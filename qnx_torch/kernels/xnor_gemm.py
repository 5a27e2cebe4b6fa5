"""Packed binary popcount GEMM with int32 output (torch port of
:mod:`qnx.kernels.xnor_gemm`, kernel B):

    s[m, n] = k - 2 * sum_kw popcount(xp[m, kw] ^ wp[kw, n])

with k the true (unpadded) reduction length; pad bits are 0 in both
operands, so they XOR to 0.  Two wrappers launch two CUDA kernels:

* :func:`xnor_gemm_popcount`, ``csrc/popcount_gemm.cu``: the GEMM at wide N
  (the TP ring's chunks and the measurement path) on the single-bit tensor
  cores, ``s = k - 2 (rx + cw) + 4 P`` with P the AND-popcount product and
  rx, cw the operands' row and column popcounts;
* :func:`xnor_head`, ``csrc/popcount_head.cu``: the binary logit head
  (``PackedDenseLogits``), int32 s or the logits ``a * s + c`` in one
  launch, on the weights K-major (:func:`k_major`).

Each launches its kernel for a CUDA tensor and runs its plain version
(``*_ref``) only for a tensor on the CPU; ``launches`` on each counts kernel
launches.  The helpers the three heads' wrappers share (:func:`affine`,
:func:`k_major`, :func:`check_head`, :func:`head_out`) live here too.  The
JAX module's ``default_blocks`` and ``check_block_shape`` are TPU tiling
rules and have no counterpart here.
"""
from __future__ import annotations

import torch

from qnx_torch.ops.packing import WORD, unpack_bits
from . import _build


def _dot_to_s(dot: torch.Tensor, kw: int, k: int) -> torch.Tensor:
    """±1 dot over all 32*kw unpacked bits -> s over the true k.  Padding bits
    are 0 in both operands; each decodes to -1 and adds +1 to the dot."""
    return dot.to(torch.int32) - (WORD * kw - k)


def xnor_gemm_popcount_ref(xp: torch.Tensor, wp: torch.Tensor,
                           k: int) -> torch.Tensor:
    """Plain version of :func:`xnor_gemm_popcount`: unpack to ±1, float32
    matmul (exact: integer sums below 2^24), pad-bit correction."""
    kw = wp.shape[0]
    x = unpack_bits(xp, kw * WORD, dtype=torch.float32)
    w = unpack_bits(wp, kw * WORD, axis=0, dtype=torch.float32)
    return _dot_to_s(x @ w, kw, k)


def check_and_products(name: str, kw: int) -> None:
    """The single-bit tensor-core GEMMs (``csrc/popcount_gemm.cu``) add
    ``4 P`` with P up to ``32 kw``: refuse a Kw whose ``128 kw`` does not
    fit an int32."""
    if 4 * WORD * kw >= 2**31:
        raise ValueError(f"{name}: Kw={kw} words: 4 P up to {4 * WORD * kw} does "
                         "not fit the kernel's int32 sums")


def xnor_gemm_popcount(xp: torch.Tensor, wp: torch.Tensor, k: int) -> torch.Tensor:
    """Packed binary GEMM -> (M, N) int32 exact ±1 dot products.

    Args:
      xp: (M, Kw) int32 activations packed along K (``pack_bits(x, -1)``).
      wp: (Kw, N) int32 weights packed along K (``pack_bits(w, 0)``).
      k:  true (unpadded) reduction length.
    """
    m, kw = xp.shape
    if wp.dim() != 2 or wp.shape[0] != kw:
        raise ValueError(f"xnor_gemm_popcount: xp {tuple(xp.shape)} and wp "
                         f"{tuple(wp.shape)} disagree on Kw")
    check_and_products("xnor_gemm_popcount", kw)
    n = wp.shape[1]
    if not _build.check_operands("xnor_gemm_popcount", xp, wp=wp):
        return xnor_gemm_popcount_ref(xp, wp, k)
    out = torch.empty((m, n), dtype=torch.int32, device=xp.device)
    if out.numel():
        _build.launch("qnx_xnor_gemm_popcount", xp.device, xp, wp, out, m, kw, n, k)
        xnor_gemm_popcount.launches += 1
    return out


xnor_gemm_popcount.launches = 0


def affine(a: torch.Tensor, s: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Logits ``a * s + c`` of an integer head, rounded once as the JAX
    package's ``a * f32(s) + c`` is under XLA, which contracts it into one
    fused multiply-add.  ``a * s`` is exact in float64 (a has 24 significant
    bits, |s| < 2^24), so the float64 sum rounded to float32 is that one
    rounding but for a double-rounding tie, which float64's 29 spare bits
    make vanishingly rare.  The head kernel (``csrc/popcount_head.cu``)
    computes the same float64 product and sum, each rounded to nearest, so
    it equals this bit for bit whatever ``s``."""
    return (a.double() * s.double() + c.double()).float()


def k_major(*planes: torch.Tensor) -> torch.Tensor:
    """(Kw, N) weight planes -> (planes, N, Kw) int32, each column's words
    contiguous: the layout the head kernel reads (a lane's loads of one
    column's words coalesced)."""
    return torch.stack([p.t() for p in planes]).contiguous()


def check_head(name: str, xp: torch.Tensor, kw: int, n: int, levels: int,
               a, c, wt, planes: dict, **others: torch.Tensor) -> bool:
    """Checks shared by the head wrappers, then :func:`_build.check_operands`
    of every operand (True where the kernel launches).  ``levels`` is the
    largest level an activation bit stands for (2^P - 1 for P planes), so
    |s| is at most ``32 * kw * levels``, which the kernel's int32 sums must
    hold; ``wt`` (or None) must be ``k_major`` of the (Kw, N) weight
    ``planes`` (name -> tensor); ``a`` and ``c`` come together, (N,)
    float32."""
    if (a is None) != (c is None):
        raise ValueError(f"{name}: give both a and c, or neither")
    if a is not None and (tuple(a.shape) != (n,) or tuple(c.shape) != (n,)):
        raise ValueError(f"{name}: a {tuple(a.shape)} and c {tuple(c.shape)} "
                         f"must be ({n},)")
    want = (len(planes), n, kw)
    if wt is not None and tuple(wt.shape) != want:
        raise ValueError(f"{name}: wt {tuple(wt.shape)} must be {want}, the "
                         "weight planes K-major (k_major)")
    if WORD * kw * levels > 2**31 - 1:
        raise ValueError(f"{name}: |s| up to {WORD * kw * levels} does not "
                         "fit the kernel's int32 sums")
    extra = {} if wt is None else {"wt": wt}
    dtypes = {}
    if a is not None:
        extra.update(a=a, c=c)
        dtypes.update(a=torch.float32, c=torch.float32)
    return _build.check_operands(name, xp, dtypes, **planes, **others, **extra)


def head_out(xp: torch.Tensor, m: int, n: int, a) -> torch.Tensor:
    """The head kernel's output: (M, N) float32 logits where ``a`` is given,
    else int32 s."""
    return torch.empty((m, n), dtype=torch.int32 if a is None else torch.float32,
                       device=xp.device)


def xnor_head_ref(xp: torch.Tensor, wp: torch.Tensor, k: int, a=None,
                  c=None) -> torch.Tensor:
    """Plain version of :func:`xnor_head`: :func:`xnor_gemm_popcount_ref`,
    then :func:`affine` where ``a`` and ``c`` are given."""
    s = xnor_gemm_popcount_ref(xp, wp, k)
    return s if a is None else affine(a, s, c)


def xnor_head(xp: torch.Tensor, wp: torch.Tensor, k: int, a=None, c=None, *,
              wt=None) -> torch.Tensor:
    """Binary logit head: (M, N) int32 s, or float32 logits ``a * s + c``
    where ``a`` and ``c`` are given, in one launch.

    Args:
      xp: (M, Kw) int32 activations packed along K.
      wp: (Kw, N) int32 weights packed along K.
      k:  true (unpadded) reduction length.
      a, c: (N,) float32 affine, or None for s.
      wt: ``k_major(wp)``, the weights as the kernel reads them, made once
          by the caller (``PackedDenseLogits`` holds it); made per call
          without it.
    """
    m, kw = xp.shape
    if wp.dim() != 2 or wp.shape[0] != kw:
        raise ValueError(f"xnor_head: xp {tuple(xp.shape)} and wp "
                         f"{tuple(wp.shape)} disagree on Kw")
    n = wp.shape[1]
    if not check_head("xnor_head", xp, kw, n, 1, a, c, wt, {"wp": wp}):
        return xnor_head_ref(xp, wp, k, a, c)
    out = head_out(xp, m, n, a)
    if out.numel():
        _build.launch("qnx_xnor_head", xp.device, xp,
                      k_major(wp) if wt is None else wt, a, c, out, m, kw, n, k)
        xnor_head.launches += 1
    return out


xnor_head.launches = 0


def xnor_gemm(xp: torch.Tensor, wp: torch.Tensor, k: int,
              strategy: str = "popcount") -> torch.Tensor:
    """Strategy dispatcher of :func:`qnx.kernels.xnor_gemm.xnor_gemm`, a torch
    reference for comparisons from the same packed words: ``popcount`` runs
    :func:`xnor_gemm_popcount`; ``int8`` unpacks to ±1 and runs a dense
    matmul (float32, exact for integer sums below 2^24), paying for the
    unpack as the JAX strategy does."""
    if strategy == "popcount":
        return xnor_gemm_popcount(xp, wp, k)
    if strategy == "int8":
        x = unpack_bits(xp, k, axis=-1, dtype=torch.float32)
        w = unpack_bits(wp, k, axis=0, dtype=torch.float32)
        return (x @ w).to(torch.int32)
    raise ValueError(f"unknown strategy {strategy!r} for packed inputs")
