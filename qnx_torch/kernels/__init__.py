"""The CUDA kernels (``csrc/``) and their wrappers; each wrapper counts the
launches of its kernel in ``.launches``."""


def launch_counters() -> dict:
    """Each CUDA kernel entry's wrapper, by kernel name.  A wrapper adds one
    to its ``.launches`` where it launches its kernel, and nowhere else."""
    from qnx_torch.kernels import gemm_formulations as G
    from qnx_torch.kernels import plane_gemm as D
    from qnx_torch.kernels import xnor_conv_fused as F
    from qnx_torch.kernels.i8_conv_fused import i8_conv_fused
    from qnx_torch.kernels.int_probe import int_chain
    from qnx_torch.kernels.ternary_gemm import ternary_gemm, ternary_head
    from qnx_torch.kernels.xnor_gemm import xnor_gemm_popcount, xnor_head

    return {"xnor_conv3x3_fused": F.xnor_conv_fused,
            "xnor_conv3x3_residual": F.xnor_conv_residual,
            "xnor_dense_fused": F.xnor_gemm_fused,
            "ternary_dense_fused": F.ternary_gemm_fused,
            "xnor_gemm_popcount": xnor_gemm_popcount,
            "ternary_gemm": ternary_gemm,
            "xnor_head": xnor_head,
            "ternary_head": ternary_head,
            "plane_head": D.plane_head,
            "i8_conv3x3_fused": i8_conv_fused,
            "ternary_conv3x3_fused": F.ternary_conv_fused,
            "plane_conv3x3_fused": D.plane_conv_fused,
            "plane_dense_fused": D.plane_dense_fused,
            "gemm_outer": G.gemm_outer,
            "gemm_outer_acc": G.gemm_outer_acc,
            "gemm_chunk3d": G.gemm_chunk3d,
            "gemm_lanered": G.gemm_lanered,
            "xnor_multiacc": G.xnor_multiacc,
            "int_chain": int_chain}
