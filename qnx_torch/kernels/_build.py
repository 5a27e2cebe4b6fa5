"""Build the CUDA kernels in ``csrc/`` at first use and bind them with ctypes.

``nvcc`` compiles every ``csrc/*.cu``, with the ``csrc/*.cuh`` headers they
include, into one shared library with a plain C interface: one ``nvcc -c``
for each source, all started together, then one link (seconds; sources that
include PyTorch's headers would take minutes).  The library lands in
``_build/`` beside this file, named by a hash of the sources and flags, so
an edited source rebuilds and an unchanged one is reused.  Nothing here runs
at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# argument types of each C entry point in csrc/*.cu
_SIGNATURES = {
    "qnx_xnor_dense_fused": [_P] * 5 + [_I] * 5 + [_P],
    "qnx_ternary_dense_fused": [_P] * 7 + [_I] * 4 + [_P],
    "qnx_xnor_conv3x3_fused": [_P] * 6 + [_I] * 7 + [_P],
    "qnx_xnor_conv3x3_residual": [_P] * 8 + [_I] * 7 + [_P],
    "qnx_xnor_gemm_popcount": [_P] * 3 + [_I] * 4 + [_P],
    "qnx_ternary_gemm": [_P] * 5 + [_I] * 3 + [_P],
    "qnx_i8_conv3x3_fused": [_P] * 5 + [_I] * 9 + [_P],
    "qnx_ternary_conv3x3_fused": [_P] * 8 + [_I] * 6 + [_P],
    "qnx_plane_conv3x3_fused": [_P] * 7 + [_I] * 8 + [_P],
    "qnx_plane_dense_fused": [_P] * 6 + [_I] * 6 + [_P],
    "qnx_xnor_head": [_P] * 5 + [_I] * 4 + [_P],
    "qnx_ternary_head": [_P] * 6 + [_I] * 3 + [_P],
    "qnx_plane_head": [_P] * 5 + [_I] * 4 + [_P],
    "qnx_gemm_outer": [_P] * 3 + [_I] * 6 + [_P],
    "qnx_gemm_outer_acc": [_P] * 3 + [_I] * 7 + [_P],
    "qnx_gemm_chunk3d": [_P] * 3 + [_I] * 7 + [_P],
    "qnx_gemm_lanered": [_P] * 3 + [_I] * 6 + [_P],
    "qnx_xnor_multiacc": [_P] * 3 + [_I] * 5 + [_P],
    "qnx_int_chain": [_P] * 3 + [_I] * 3 + [_P],
    "qnx_tc_probe": [_P] * 3 + [_I] * 3 + [_P],
}


def _units() -> list[Path]:
    """The translation units nvcc compiles."""
    return sorted(CSRC.glob("*.cu"))


def _sources() -> list[Path]:
    """Every file the library is built from: the units and their headers."""
    return _units() + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the qnx_torch "
        "CUDA kernels are built from source at first use and need the CUDA "
        "toolkit")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libqnx_kernels_{h.hexdigest()[:16]}.so"


def build_log() -> str:
    """The compiler's output (ptxas register and spill report) of the build
    of the current sources, or "" if it has not been built."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _build(lib: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    objs = BUILD_DIR / f"{lib.stem}.{os.getpid()}.objs"
    objs.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    nvcc = _nvcc()
    jobs = []
    for unit in _units():  # one compiler per source, all at once
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(objs / f"{unit.stem}.o"),
               str(unit)]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, proc in jobs:  # wait for every one, failed or not
        out = proc.communicate()[0]
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"(exit {proc.returncode}): {' '.join(cmd)}\n{out}")
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, sorted(objs.glob("*.o")))]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            failed.append(f"(exit {proc.returncode}): {' '.join(cmd)}\n{proc.stdout}")
    shutil.rmtree(objs, ignore_errors=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("building the qnx_torch CUDA kernels failed "
                           + "\n".join(failed))
    lib.with_suffix(".log").write_text("".join(log))
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with typed entry points."""
    lib_path = library_path()
    if not lib_path.exists():
        _build(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.qnx_cuda_error_string.argtypes = [ctypes.c_int]
    lib.qnx_cuda_error_string.restype = ctypes.c_char_p
    return lib


def launch(fn_name: str, device: torch.device, *args) -> None:
    """Call C entry point ``fn_name`` on ``device``'s current stream with
    ``args`` (tensors are passed by pointer) and raise if the launch was
    refused."""
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, fn_name)(
            *(ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor) else a
              for a in args), ctypes.c_void_p(stream))
    if code != 0:
        msg = lib.qnx_cuda_error_string(code).decode()
        raise RuntimeError(f"{fn_name}: CUDA launch failed with error {code}: {msg}")


def check_operands(name: str, xp: torch.Tensor,
                   dtypes: dict[str, torch.dtype] | None = None,
                   **tensors: torch.Tensor) -> bool:
    """Check what every kernel wrapper's operands must be: of their dtype,
    contiguous, on ``xp``'s device.  ``dtypes`` maps an operand's name
    ("xp" for the first) to its dtype; an operand it does not name must be
    int32.  Returns True where the wrapper launches its kernel (a CUDA
    tensor) and False where it runs its plain version (a CPU tensor); any
    other device raises."""
    dtypes = dtypes or {}
    for arg, t in {"xp": xp, **tensors}.items():
        want = dtypes.get(arg, torch.int32)
        if t.dtype != want:
            raise TypeError(f"{name}: {arg} must be {want}, got {t.dtype}")
        if t.device != xp.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, xp on {xp.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if xp.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: no kernel for device {xp.device}")
    return xp.is_cuda
