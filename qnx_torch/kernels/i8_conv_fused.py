"""Fused int8 3x3 conv + integer threshold epilogue (+2x2 max pool): torch
port of :mod:`qnx.kernels.i8_conv_fused`, kernel E.

    s    = 3x3 'SAME' stride-1 conv of x8 with w8, int32   (zero pads)
    code = sgn * s >= tau ? 1 : -1         (encoding "pm1", tau (N,))
    code = sgn * s >= tau ? 1 : 0          (encoding "zo", tau (N,))
    code = sum_v [sgn * s >= tau[v]]       (encoding "levels", tau (L, N))
    code = sum_v [sgn * s >= tau[v]] - L/2 (encoding "tanh", tau (L, N),
                                            L = 2^nb - 2 even: signed codes)
    pool: 2x2/2 max of the codes, the window's min where sgn < 0
          ('VALID': an odd H or W floors)

:func:`i8_conv_fused` launches the CUDA kernel of ``csrc/i8_conv_fused.cu``
(an implicit GEMM on the int8 tensor cores, ``wgmma``) for a CUDA tensor
and runs its plain version, :func:`i8_conv_fused_ref`, only for a tensor on
the CPU; ``i8_conv_fused.launches`` counts kernel launches.  The plain
version is the unfused ``qnx.nn.int8_engine.I8Conv``: conv, threshold, then
the pool of the codes.  The kernel reads the weights K-major
(:func:`k_major`), which ``I8Conv`` makes once.

The encoding is an argument, never inferred from ``tau``'s shape: the JAX
``I8Conv(fused=True)`` passes ``levels = tau.shape[0]``, and its kernel takes
one threshold as the sign encoding, so a levels layer with one threshold
gives {-1, +1} there where ``I8Conv`` gives {0, 1} (ROADMAP.md §3).  The
kernel takes each encoding as the affine form of its code,
``mul * k - off`` of the k thresholds passed (:func:`code_affine`).  The JAX
wrapper's TPU tiling (``block_b``, ``block_n``, the VMEM budget) and its
pool split between the kernel and XLA have no counterpart here.

The epilogues (:func:`act_epilogue`) are shared with the dense layers of
:mod:`qnx_torch.nn.int8_engine`.
"""
from __future__ import annotations

import torch

from . import _build

ENCODINGS = ("pm1", "zo", "levels", "tanh")
# |s| <= 9 * C * 128 * 128 must stay below 2^31 for int8 operands
MAX_CHANNELS = (2**31 - 1) // (9 * 128 * 128)
# each tap's channels of the K-major weights are zero-padded to a multiple
# of this, so every tap starts 16-byte aligned for the kernel's copies
K_ALIGN = 16


def sign_epilogue(s: torch.Tensor, sgn: torch.Tensor,
                  tau: torch.Tensor) -> torch.Tensor:
    """±1 int8 codes of the integer threshold test ``sgn * s >= tau``
    (sgn and tau (N,), broadcast over the leading dims of s)."""
    return torch.where(sgn * s >= tau, 1, -1).to(torch.int8)


def zo_epilogue(s: torch.Tensor, sgn: torch.Tensor,
                tau: torch.Tensor) -> torch.Tensor:
    """{0, 1} int8 codes of the same test (binary_sigmoid: 1 iff BN(y) > 0,
    the sign test of pm1 with another coding)."""
    return torch.where(sgn * s >= tau, 1, 0).to(torch.int8)


def multi_threshold(s: torch.Tensor, sgn: torch.Tensor,
                    tau: torch.Tensor) -> torch.Tensor:
    """int32 level ``sum_v [sgn * s >= tau[v]]`` (tau (n_thresh, N),
    ascending, broadcast over the leading dims of s)."""
    u = sgn * s
    lvl = torch.zeros(s.shape, dtype=torch.int32, device=s.device)
    for v in range(tau.shape[0]):
        lvl += (u >= tau[v]).to(torch.int32)
    return lvl


def level_epilogue(s: torch.Tensor, sgn: torch.Tensor, tau: torch.Tensor,
                   off: int = 0) -> torch.Tensor:
    """Level codes int8 ``sum_v [sgn * s >= tau[v]] - off`` (tau (n_thresh,
    N)): off 0 for quantized_relu, off = n_thresh // 2 = L - 1 recentres
    quantized_tanh's unsigned index into its signed code."""
    return (multi_threshold(s, sgn, tau) - off).to(torch.int8)


def act_epilogue(act: str, s: torch.Tensor, sgn: torch.Tensor,
                 tau: torch.Tensor) -> torch.Tensor:
    """int32 s -> int8 activation codes of encoding ``act``."""
    if act == "pm1":
        return sign_epilogue(s, sgn, tau)
    if act == "zo":
        return zo_epilogue(s, sgn, tau)
    if act == "levels":
        return level_epilogue(s, sgn, tau)
    if act == "tanh":
        return level_epilogue(s, sgn, tau, off=tau.shape[0] // 2)
    raise ValueError(f"unknown int8 encoding {act!r}")


def code_affine(encoding: str, n_thresh: int) -> tuple[int, int]:
    """(mul, off) of the encoding's code ``mul * k - off`` of the k
    thresholds passed, as kernel E takes it: pm1 (2, 1), zo and levels
    (1, 0), tanh (1, n_thresh // 2)."""
    return {"pm1": (2, 1), "zo": (1, 0), "levels": (1, 0),
            "tanh": (1, n_thresh // 2)}[encoding]


def _n_thresholds(encoding: str, n: int, sgn: torch.Tensor,
                  tau: torch.Tensor) -> int:
    """Check sgn (N,) and tau ((N,) for pm1 and zo, (L, N) for levels and
    (L, N) with L even for tanh); return the number of thresholds."""
    if encoding not in ENCODINGS:
        raise ValueError(f"encoding must be one of {ENCODINGS}, got {encoding!r}")
    if encoding in ("pm1", "zo"):
        tau_ok = tau.shape == (n,)
    else:
        tau_ok = tau.dim() == 2 and tau.shape[0] >= 1 and tau.shape[1] == n
        if encoding == "tanh":  # 2^nb - 2 thresholds, codes within int8
            tau_ok = tau_ok and tau.shape[0] % 2 == 0 and tau.shape[0] <= 254
    if sgn.shape != (n,) or not tau_ok:
        raise ValueError(f"i8_conv_fused: sgn {tuple(sgn.shape)} must be ({n},) "
                         f"and tau {tuple(tau.shape)} ({n},) for pm1 and zo, "
                         f"(L >= 1, {n}) for levels, (L even <= 254, {n}) for "
                         f"tanh (got {encoding!r})")
    return tau.shape[0] if tau.dim() == 2 else 1


def conv3x3_s_ref(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Plain int8 3x3 'SAME' conv -> int32 s: gather the 9 taps (int8 zero
    pads), float64 matmul (exact: integer sums below 2^53; a float32 product
    is exact only below 2^24, which 9*512*127*128 exceeds)."""
    b, h, w, c = x8.shape
    n = w8.shape[-1]
    xpad = x8.new_zeros(b, h + 2, w + 2, c)
    xpad[:, 1:h + 1, 1:w + 1] = x8
    patches = torch.cat([xpad[:, dy:dy + h, dx:dx + w]
                         for dy in range(3) for dx in range(3)], dim=-1)
    s = patches.reshape(b * h * w, 9 * c).double() @ w8.reshape(9 * c, n).double()
    return s.to(torch.int32).reshape(b, h, w, n)


def _maxpool2(y: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pool, NHWC, 'VALID' (an odd H or W floors)."""
    b, h, w, c = y.shape
    y = y[:, :h // 2 * 2, :w // 2 * 2]
    return y.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def pool_codes(code: torch.Tensor, sgn: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pool (NHWC, 'VALID') of threshold codes, the window's min on
    channels with sgn < 0, whose epilogue decreases (negate, pool, negate
    back), as the JAX ``_pool_codes``."""
    flip = sgn < 0
    p = _maxpool2(torch.where(flip, -code, code))
    return torch.where(flip, -p, p)


def k_major(w8: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, N) int8 weights -> the same weights K-major, (N, 9 Cp)
    with K contiguous per output channel: tap-major, each tap's C channels
    zero-padded to Cp = ceil(C / K_ALIGN) K_ALIGN.  Column n, tap t holds
    ``w8.reshape(9, C, N)[t, :, n]`` then zeros."""
    c, n = w8.shape[2], w8.shape[3]
    cp = -(-c // K_ALIGN) * K_ALIGN
    wk = w8.new_zeros(n, 9, cp)
    wk[:, :, :c] = w8.reshape(9, c, n).permute(2, 0, 1)
    return wk.reshape(n, 9 * cp)


def i8_conv_fused_ref(x8: torch.Tensor, w8: torch.Tensor, sgn: torch.Tensor,
                      tau: torch.Tensor, *, encoding: str,
                      pool: bool = False) -> torch.Tensor:
    """Plain version of :func:`i8_conv_fused`, the unfused ``I8Conv``:
    int32 conv, threshold, then the pool of the codes."""
    out = act_epilogue(encoding, conv3x3_s_ref(x8, w8), sgn, tau)
    return pool_codes(out, sgn) if pool else out


def i8_conv_fused(x8: torch.Tensor, w8: torch.Tensor, sgn: torch.Tensor,
                  tau: torch.Tensor, *, encoding: str, pool: bool = False,
                  wk: torch.Tensor | None = None) -> torch.Tensor:
    """Fused int8 3x3 'SAME' stride-1 conv + threshold (+2x2 max pool).

    Args:
      x8:  (B, H, W, C) int8 activation codes.
      w8:  (3, 3, C, N) int8 weights (HWIO), any int8 values.
      sgn: (N,) int32 threshold direction (+1 / -1).
      tau: (N,) int32 threshold (``encoding`` "pm1" or "zo"), or (L, N)
           int32 thresholds ("levels", L >= 1; "tanh", L = 2^nb - 2).
      encoding: "pm1" (codes ±1), "zo" (codes 0, 1), "levels" (codes
           0..L) or "tanh" (codes -L/2..L/2).
      pool: 2x2/2 max pool of the codes (window min where sgn < 0).
      wk:  ``k_major(w8)``, the weights as the kernel reads them.  Without
           it the wrapper makes that copy itself (a torch transpose of the
           weights at every call) before it launches the kernel; the CPU's
           plain version reads ``w8`` either way.

    Returns:
      (B, H', W', N) int8 codes; H' = H // 2, W' = W // 2 with pool.
    """
    b, h, w, c = x8.shape
    if w8.dim() != 4 or tuple(w8.shape[:3]) != (3, 3, c):
        raise ValueError(f"i8_conv_fused: w8 {tuple(w8.shape)} must be "
                         f"(3, 3, {c}, N) for x8 {tuple(x8.shape)}")
    if c > MAX_CHANNELS:
        raise ValueError(f"i8_conv_fused: C = {c} > {MAX_CHANNELS} could "
                         "overflow the int32 accumulator")
    n = w8.shape[3]
    n_thresh = _n_thresholds(encoding, n, sgn, tau)
    kshape = (n, 9 * (-(-c // K_ALIGN) * K_ALIGN))
    if wk is not None and tuple(wk.shape) != kshape:
        raise ValueError(f"i8_conv_fused: wk {tuple(wk.shape)} must be {kshape}, "
                         "k_major(w8)")
    if not _build.check_operands("i8_conv_fused", x8,
                                 {"xp": torch.int8, "w8": torch.int8,
                                  "wk": torch.int8},
                                 w8=w8, sgn=sgn, tau=tau,
                                 **({} if wk is None else {"wk": wk})):
        return i8_conv_fused_ref(x8, w8, sgn, tau, encoding=encoding, pool=pool)
    if wk is None:
        wk = k_major(w8)
    ho, wo = (h // 2, w // 2) if pool else (h, w)
    out = torch.empty((b, ho, wo, n), dtype=torch.int8, device=x8.device)
    if out.numel():
        _build.launch("qnx_i8_conv3x3_fused", x8.device, x8, wk, sgn, tau, out,
                      b, h, w, c, n, n_thresh,
                      *code_affine(encoding, n_thresh), int(pool))
        i8_conv_fused.launches += 1
    return out


i8_conv_fused.launches = 0
