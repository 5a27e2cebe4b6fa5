"""qnx_torch's integer issue-rate probe (kernel H,
:mod:`qnx_torch.kernels.int_probe`) against the JAX kernel body of
``experiments/vpu_probe.py`` (``_chain_kernel``, run outside Pallas with
numpy arrays standing in for the refs), every mode, several chain lengths,
inputs including INT32_MIN and INT32_MAX.  Exact.  The CUDA kernel is held
against the plain version on the card by ``chip_smoke.py``."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from qnx_torch.experiments import vpu_probe
from qnx_torch.kernels.int_probe import MODES, REPS, int_chain, int_chain_ref

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("jax_experiment_vpu_probe",
                                               ROOT / "experiments" / "vpu_probe.py")
JAX_PROBE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(JAX_PROBE)

I32 = np.iinfo(np.int32)


def _inputs(seed: int, shape=(6, 16)):
    """Seeded int32 words with the extremes (and -1, 0, 1, the values next
    to them) in both operands."""
    rng = np.random.default_rng(seed)
    x = rng.integers(I32.min, I32.max, shape, dtype=np.int32, endpoint=True)
    y = rng.integers(I32.min, I32.max, shape, dtype=np.int32, endpoint=True)
    edge = np.array([I32.min, I32.max, -1, 0, 1, I32.max - 1, I32.min + 1, I32.max],
                    np.int32)
    x.flat[:8] = edge
    y.flat[:8] = edge[::-1]
    y.flat[8:16] = edge
    return x, y


def _jax_chain(x, y, mode, reps):
    out = np.empty_like(x)
    JAX_PROBE._chain_kernel(x, y, out, mode=mode, reps=reps)
    return out


@pytest.mark.parametrize("reps", [1, 2, 5, 32])
@pytest.mark.parametrize("mode", MODES)
def test_plain_chain_matches_jax_body(mode, reps):
    x, y = _inputs(reps * 10 + MODES.index(mode))
    want = _jax_chain(x, y, mode, reps)
    got = int_chain_ref(torch.from_numpy(x), torch.from_numpy(y), mode, reps)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", MODES)
def test_wrapper_runs_the_plain_version_on_cpu(mode):
    x, y = _inputs(7)
    int_chain.launches = 0
    for reps in REPS:
        got = int_chain(torch.from_numpy(x), torch.from_numpy(y), mode, reps)
        np.testing.assert_array_equal(got.numpy(), _jax_chain(x, y, mode, reps))
    assert int_chain.launches == 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, y = (torch.from_numpy(a) for a in _inputs(0))
    with pytest.raises(ValueError, match="mode"):
        int_chain(x, y, "nand", 32)
    with pytest.raises(ValueError, match="mode"):
        int_chain_ref(x, y, "nand", 32)
    with pytest.raises(ValueError, match="not compiled in"):
        int_chain(x, y, "pc", 64)
    with pytest.raises(ValueError, match="shape"):
        int_chain(x, y[:2], "pc", 32)
    with pytest.raises(TypeError, match="int32"):
        int_chain(x, y.to(torch.int64), "pc", 32)


def test_probe_on_the_cpu_route():
    """The probe's plumbing at a small shape: a row per mode; CPU times are
    no measurement and carry no clock."""
    rows = vpu_probe.main(shape=(8, 64), iters=2, repeats=1, device="cpu")
    assert [r["mode"] for r in rows] == list(MODES)
    for r in rows:
        assert r["steps_per_clock_per_sm"] is None and r["sm_clock_mhz"] is None


def test_sass_counts_parse_the_chain_kernels(tmp_path, monkeypatch):
    """The SASS reader keys each int_chain_kernel instance by (mode, reps)
    and counts its opcodes, predicated or not."""
    sass = """
        Function : _ZN12_GLOBAL__N_116int_chain_kernelILi3ELi32EEEvPKjS2_Pji
        .headerflags    @"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;     /* 0x00000a00ff017b82 */
                                                              /* 0x000fe40000000800 */
        /*0010*/                   POPC R5, R4 ;
        /*0020*/                   POPC R6, R4 ;
        /*0030*/                   LOP3.LUT R4, R2, R3, RZ, 0x3c, !PT ;
        /*0040*/               @P0 EXIT ;
        Function : _ZN12_GLOBAL__N_114outer_kernelILi128ELi128EEEvPKjS2_Piiiii
        /*0000*/                   POPC R5, R4 ;
    """
    monkeypatch.setattr(vpu_probe, "_cuobjdump", lambda: "cuobjdump")
    monkeypatch.setattr(vpu_probe.subprocess, "run",
                        lambda *a, **k: type("P", (), {"stdout": sass})())
    counts = vpu_probe.sass_counts(tmp_path / "lib.so")
    assert set(counts) == {("pc", 32)}
    assert counts[("pc", 32)] == {"LDC": 1, "POPC": 2, "LOP3": 1, "EXIT": 1}
