"""The check for JAX compares whole top-level names."""
import subprocess
import sys

from qbench.checks import forbidden_modules


def test_whole_top_level_names():
    assert forbidden_modules(["qnx_torch", "qnx_torch.nn.inference", "numpy"]) == []
    assert forbidden_modules(["qnx", "numpy"]) == ["qnx"]
    assert forbidden_modules(["qnx.kernels.xnor_gemm"]) == ["qnx"]
    assert forbidden_modules(["jax.numpy", "jaxlib.xla_client", "flax.linen",
                              "optax", "orbax.checkpoint"]) == \
        ["flax", "jax", "jaxlib", "optax", "orbax"]
    assert forbidden_modules(["qnxfoo", "jaxtyping", "flaxen"]) == []


def test_the_harness_loads_no_jax():
    """Importing the harness and the program's serving path loads none."""
    code = ("import sys; import qbench.run, qbench.trace, qbench.calibrate;"
            "import qnx_torch.serve.engine, qnx_torch.convert.pack_model;"
            "from qbench.checks import forbidden_modules;"
            "print(forbidden_modules(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"
