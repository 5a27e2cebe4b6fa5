"""Native host runtime (C++ via ctypes): serving-side image normalization,
bit-packing, and a popcount-GEMM oracle; the port's copy of
:mod:`qnx.native`. See qnx_host.cpp for the ABI and hostlib for the Python
bindings + numpy fallback."""
from qnx_torch.native.hostlib import (available, pack_bits_f32,
                                      pack_ternary_f32, u8_to_f32,
                                      xnor_gemm_host)

__all__ = ["available", "u8_to_f32", "pack_bits_f32", "pack_ternary_f32",
           "xnor_gemm_host"]
