"""ctypes bindings for the native host runtime (qnx_host.cpp), the port's
copy of :mod:`qnx.native.hostlib` with the same C ABI and Python API.

Build model: compiled with g++ at the first call (never at import) into
``qnx_torch/native/_build/``, keyed on the source's hash, and loaded with
ctypes.  ``QNX_TORCH_NO_NATIVE=1`` turns the build off.  Every entry point
has a numpy fallback with identical results, so the package works on a
machine without a toolchain; ``available()`` reports which route is active.

``u8_to_f32`` rounds once on both routes: the C++ is an explicit
``std::fmaf`` and the numpy route computes in float64 and rounds to
float32, so both equal :func:`qnx_torch.serve.engine.normalize_u8` bit for
bit.

Layout contracts are those of :mod:`qnx_torch.ops.packing` (LSB-first
words, bit 1 iff element > 0, zero-padded tail words).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from qnx_torch.ops.packing import pack_bits_np, pack_ternary_np

_SRC = os.path.join(os.path.dirname(__file__), "qnx_host.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False

_i64 = ctypes.c_int64
_i32 = ctypes.c_int32
_pf32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_pu8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_pi32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")

_INV_127_5 = np.float64(np.float32(1.0 / 127.5))


def _build() -> ctypes.CDLL | None:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(_BUILD_DIR, f"qnx_host_{tag}.so")
    if not os.path.exists(so):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = so + f".tmp{os.getpid()}"
        # no -ffast-math: u8_to_f32's fmaf must round once
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
               "-std=c++17", "-pthread", _SRC, "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
        os.replace(tmp, so)
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.qnx_host_abi_version.restype = _i32
    lib.qnx_host_abi_version.argtypes = []
    if lib.qnx_host_abi_version() != 1:
        return None
    lib.qnx_u8_to_f32.argtypes = [_pu8, _pf32, _i64]
    lib.qnx_pack_bits_f32.argtypes = [_pf32, _i64, _i64, _pi32]
    lib.qnx_pack_ternary_f32.argtypes = [_pf32, _i64, _i64, _pi32, _pi32,
                                         _pi32]
    lib.qnx_xnor_gemm.argtypes = [_pi32, _pi32, _pi32, _i64, _i64, _i64,
                                  _i32]
    for fn in (lib.qnx_u8_to_f32, lib.qnx_pack_bits_f32,
               lib.qnx_pack_ternary_f32, lib.qnx_xnor_gemm):
        fn.restype = None
    return lib


def _lib() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _LOCK:
        if not _TRIED:
            if os.environ.get("QNX_TORCH_NO_NATIVE", "0") != "1":
                _LIB = _build()
            _TRIED = True
    return _LIB


def available() -> bool:
    """True when the C++ library compiled and loaded (else numpy fallback)."""
    return _lib() is not None


def u8_to_f32_np(img: np.ndarray) -> np.ndarray:
    """The numpy route of :func:`u8_to_f32`: the float64 product and
    difference are exact, so rounding them to float32 rounds once."""
    img = np.asarray(img, np.uint8)
    return (img.astype(np.float64) * _INV_127_5 - 1.0).astype(np.float32)


def u8_to_f32(img: np.ndarray) -> np.ndarray:
    """uint8 [0,255] -> float32 [-1,1] (the reference's input scaling)."""
    img = np.ascontiguousarray(img, np.uint8)
    lib = _lib()
    if lib is None:
        return u8_to_f32_np(img)
    out = np.empty(img.shape, np.float32)
    lib.qnx_u8_to_f32(img.reshape(-1), out.reshape(-1), img.size)
    return out


def pack_bits_f32(x: np.ndarray) -> np.ndarray:
    """(rows, k) float32 -> (rows, kw) int32 sign-packed words."""
    x = np.ascontiguousarray(x, np.float32)
    rows, k = x.shape
    kw = (k + 31) // 32
    lib = _lib()
    if lib is None:
        return pack_bits_np(x, axis=-1)
    out = np.empty((rows, kw), np.int32)
    lib.qnx_pack_bits_f32(x, rows, k, out)
    return out


def pack_ternary_f32(x: np.ndarray):
    """(rows, k) float32 -> (mask, sign, nnz) two-plane ternary packing."""
    x = np.ascontiguousarray(x, np.float32)
    rows, k = x.shape
    kw = (k + 31) // 32
    lib = _lib()
    if lib is None:
        return pack_ternary_np(x, axis=-1)
    mask = np.empty((rows, kw), np.int32)
    sign = np.empty((rows, kw), np.int32)
    nnz = np.empty((rows,), np.int32)
    lib.qnx_pack_ternary_f32(x, rows, k, mask, sign, nnz)
    return mask, sign, nnz


def xnor_gemm_host(xp: np.ndarray, wp: np.ndarray, k: int) -> np.ndarray:
    """Host oracle for the packed GEMM: xp (M, Kw), wp (Kw, N) -> (M, N)
    with dot = k - 2*popcount(x ^ w). Independent cross-check of the device
    kernels (C++ when available, numpy otherwise)."""
    xp = np.ascontiguousarray(xp, np.int32)
    wp = np.ascontiguousarray(wp, np.int32)
    m, kw = xp.shape
    kw2, n = wp.shape
    if kw != kw2:
        raise ValueError(f"xp has {kw} words a row, wp {kw2}")
    lib = _lib()
    if lib is None:
        xu = xp.view(np.uint32)[:, None, :]
        wu = np.ascontiguousarray(wp.T).view(np.uint32)[None, :, :]
        mism = np.zeros((m, n), np.int32)
        for shift in range(32):  # numpy popcount via bit loop
            mism += (((xu >> np.uint32(shift)) ^ (wu >> np.uint32(shift)))
                     & np.uint32(1)).sum(-1, dtype=np.int32)
        return np.int32(k) - 2 * mism
    out = np.empty((m, n), np.int32)
    wpT = np.ascontiguousarray(wp.T)
    lib.qnx_xnor_gemm(xp, wpT, out, m, n, kw, k)
    return out
