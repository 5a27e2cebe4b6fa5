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


@pytest.mark.parametrize("reps", [1, 2, 5, 32, 128, 384])
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
        # both differences: 384 - 128 steps, and the JAX file's 96 - 32
        assert r["jax_steps_per_clock_per_sm"] is None
        assert set(r["us"]) == {384, 128, 96, 32}
        assert r["bytes_ms"] == pytest.approx(12 * 8 * 64 / 3.35e12 * 1e3)
        assert "sass_per_step" not in r  # no SASS read on the CPU


def test_issue_bound_takes_the_slowest_pipe():
    """Each opcode on its pipe, all through the issue slots: pc's one POPC
    a step outweighs its LOP3, VIADD and half IADD3; xor's LOP3 and VIADD
    issue on two pipes and fill both, and the issue slots; csa's two LOP3
    and one IADD3 share the integer pipe."""
    from qnx_torch.bench.roofline import H100_PEAKS

    n = 4096 * 1024
    pc = vpu_probe.issue_ms({"POPC": 1, "LOP3": 1, "VIADD": 1, "IADD3": 0.5}, 96, n)
    assert pc == pytest.approx(96 * n / H100_PEAKS["popc_ops"] * 1e3)
    xor = vpu_probe.issue_ms({"LOP3": 1, "VIADD": 1}, 128, n)
    assert xor == pytest.approx(128 * n / H100_PEAKS["imad_ops"] * 1e3)
    # its LOP3 pipe and the issue slots measured within 0.2% of that
    for pipe, per_step in (("int_ops", 1), ("issue_ops", 2)):
        assert xor == pytest.approx(128 * n * per_step / H100_PEAKS[pipe] * 1e3, rel=2e-3)
    csa = vpu_probe.issue_ms({"LOP3": 2, "IADD3": 1, "VIADD": 1}, 128, n)
    assert csa == pytest.approx(128 * n * 3 / H100_PEAKS["int_ops"] * 1e3)
    # at 128 steps xor's issue takes about twice its 12 bytes' time
    assert 1.5 < xor / (12 * n / H100_PEAKS["hbm_bytes"] * 1e3) < 2.5


def test_sass_counts_parse_the_chain_kernels(tmp_path, monkeypatch):
    """The SASS reader keys each int_chain_kernel instance by (mode, reps)
    and counts its opcodes, predicated or not; the issue pair's 128- and
    384-step builds difference to the instructions a step."""
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
    step = "        /*0000*/                   POPC R5, R4 ;\n" \
           "        /*0010*/                   LOP3.LUT R4, R2, R3, RZ, 0x3c, !PT ;\n" \
           "        /*0020*/               @!P1 VIADD R2, R2, 0x1 ;\n"
    for reps, unrolled in ((128, 128), (384, 384)):
        sass += ("        Function : _ZN12_GLOBAL__N_116int_chain_kernelILi3ELi"
                 f"{reps}EEEvPKjS2_Pji\n" + step * unrolled
                 + "        /*0fff*/                   EXIT ;\n")
    monkeypatch.setattr(vpu_probe, "_cuobjdump", lambda: "cuobjdump")
    monkeypatch.setattr(vpu_probe.subprocess, "run",
                        lambda *a, **k: type("P", (), {"stdout": sass})())
    counts = vpu_probe.sass_counts(tmp_path / "lib.so")
    assert set(counts) == {("pc", 32), ("pc", 128), ("pc", 384)}
    assert counts[("pc", 32)] == {"LDC": 1, "POPC": 2, "LOP3": 1, "EXIT": 1}
    assert counts[("pc", 384)] == {"POPC": 384, "LOP3": 384, "VIADD": 384, "EXIT": 1}
    per_step = vpu_probe.sass_per_step(counts, "pc", *vpu_probe.PAIRS[0])
    assert per_step == {"POPC": 1, "LOP3": 1, "VIADD": 1}
