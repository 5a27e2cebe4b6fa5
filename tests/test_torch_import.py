"""qnx_torch imports without jax or the JAX package (a CUDA host need not
have them), without triton, and without h5py, keras or scikit-learn (the
card's machine has none), and builds no kernel or native library at
import."""
import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "qnx_torch"

EXPECTED = {
    "qnx_torch.ops.packing", "qnx_torch.ops.reference",
    "qnx_torch.kernels.xnor_conv", "qnx_torch.kernels.xnor_conv_fused",
    "qnx_torch.kernels._build", "qnx_torch.nn.inference",
    "qnx_torch.convert.pack_model", "qnx_torch.models.factory",
    "qnx_torch.serve.engine", "qnx_torch.utils.config",
    "qnx_torch.transforms.bn_fold", "qnx_torch.kernels.xnor_gemm",
    "qnx_torch.kernels.ternary_gemm", "qnx_torch.ops.quant",
    "qnx_torch.kernels.i8_conv_fused", "qnx_torch.nn.int8_engine",
    "qnx_torch.bench.float_baseline", "qnx_torch.kernels.plane_gemm",
    "qnx_torch.bench.microbench", "qnx_torch.bench.roofline",
    "qnx_torch.kernels.gemm_formulations", "qnx_torch.kernels.int_probe",
    "qnx_torch.experiments.gemm_shootout",
    "qnx_torch.experiments.xnor_sol_variants",
    "qnx_torch.experiments.vpu_probe",
    "qnx_torch.__main__", "qnx_torch.convert.keras_h5",
    "qnx_torch.data.datasets", "qnx_torch.native", "qnx_torch.native.hostlib",
}

_PROBE = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "triton", "qnx", "h5py",
             "keras", "sklearn"):
    sys.modules[name] = None  # any import of these now raises ImportError
import qnx_torch
names = sorted(m.name for m in pkgutil.walk_packages(qnx_torch.__path__, "qnx_torch."))
for name in names:
    importlib.import_module(name)
import qnx_torch.kernels._build as b
assert b.load.cache_info().currsize == 0  # no kernel was built or loaded
import qnx_torch.native.hostlib as h
assert not h._TRIED  # nor the native host runtime
print("\\n".join(names))
"""


def test_import_every_module_with_jax_and_triton_blocked():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert EXPECTED <= set(proc.stdout.split())


def test_no_source_names_jax_flax_optax_or_triton_at_top_level():
    """The port and chip_smoke.py stand on their own: no module of the JAX
    package is imported, not even its numpy-only ones."""
    for path in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "flax", "optax", "triton",
                                    "qnx"), \
                    f"{path.relative_to(ROOT)} imports {name}"
