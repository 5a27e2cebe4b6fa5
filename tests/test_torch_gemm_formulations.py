"""qnx_torch's popcount-GEMM formulations (F1-F4 of
``experiments/gemm_shootout.py``, G of ``experiments/xnor_sol_variants.py``;
:mod:`qnx_torch.kernels.gemm_formulations`) against the JAX kernel bodies,
run outside Pallas with numpy arrays standing in for the refs, against
``xnor_multiacc`` itself in interpret mode, and against
``qnx.ops.reference.xnor_gemm_ref``, on the same seeded words.  Exact.  On
CPU tensors every wrapper runs the one plain version; the CUDA kernels are
held against it on the card by ``chip_smoke.py``."""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qnx.ops.reference import xnor_gemm_ref as jax_xnor_gemm_ref
from qnx_torch.experiments import gemm_shootout
from qnx_torch.kernels import gemm_formulations as G
from qnx_torch.kernels.xnor_gemm import xnor_gemm_popcount_ref

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def _load(name: str):
    """An experiment module of the JAX package, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        f"jax_experiment_{name}", ROOT / "experiments" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SHOOTOUT = _load("gemm_shootout")
SOL = _load("xnor_sol_variants")

# (m, k, n): k not a multiple of 32 (zero pad bits), M not a multiple of any
# tile, N = 1, 10, 33 and 128
SHAPES = [(16, 153, 24), (7, 100, 10), (5, 64, 1), (9, 300, 33), (3, 40, 128)]
IDS = [f"m{m}k{k}n{n}" for m, k, n in SHAPES]


def _case(m, k, n):
    rng = np.random.default_rng(m * 1000 + k + n)
    xp = gemm_shootout.random_words(rng, m, k)
    wp = gemm_shootout.random_words(rng, n, k, along_rows=True)
    return xp, wp


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _body(kernel, x, w, m, n, **kw):
    """A Pallas kernel body run on numpy refs."""
    out = np.zeros((m, n), np.int32)
    kernel(x, w, out, **kw)
    return out


@pytest.mark.parametrize("m,k,n", SHAPES, ids=IDS)
def test_plain_version_matches_jax_bodies_and_reference(m, k, n):
    xp, wp = _case(m, k, n)
    kw = xp.shape[1]
    want = np.asarray(jax_xnor_gemm_ref(jnp.asarray(xp), jnp.asarray(wp), k))
    got = xnor_gemm_popcount_ref(*_t(xp, wp), k)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)
    bodies = [_body(SHOOTOUT._outer_kernel, xp, wp, m, n, k=k, kw=kw),
              _body(SHOOTOUT._lanered_kernel, xp, np.ascontiguousarray(wp.T), m, n,
                    k=k, bn=n)]
    bodies += [_body(SHOOTOUT._chunk3d_kernel, xp, wp, m, n, k=k, kw=kw, kc=kc)
               for kc in (2, 4, 8)]
    bodies += [_body(SOL._kernel_multiacc, xp, wp, m, n, k=k, kw=kw, nacc=a)
               for a in G.NACCS]
    for body in bodies:
        np.testing.assert_array_equal(body, want)


@pytest.mark.parametrize("m,k,n", SHAPES, ids=IDS)
def test_every_wrapper_and_geometry_runs_the_plain_version(m, k, n):
    xp, wp = _case(m, k, n)
    x, w = _t(xp, wp)
    wt = w.t().contiguous()
    want = xnor_gemm_popcount_ref(x, w, k)
    outs = [G.gemm_outer(x, w, k, *g) for g in G.OUTER_GEOMETRIES]
    outs += [G.gemm_outer_acc(x, w, k, *g) for g in G.OUTER_ACC_GEOMETRIES]
    outs += [G.gemm_chunk3d(x, w, k, *g) for g in G.CHUNK3D_GEOMETRIES]
    outs += [G.gemm_lanered(x, wt, k, *g) for g in G.LANERED_GEOMETRIES]
    outs += [G.xnor_multiacc(x, w, k, nacc=a) for a in G.NACCS]
    for out in outs:
        assert out.dtype == torch.int32
        assert torch.equal(out, want)


@pytest.mark.parametrize("nacc", G.NACCS)
def test_xnor_multiacc_matches_jax_in_interpret_mode(nacc):
    xp, wp = _case(256, 153, 256)
    want = np.asarray(SOL.xnor_multiacc(jnp.asarray(xp), jnp.asarray(wp), 153,
                                        nacc=nacc))
    got = G.xnor_multiacc(*_t(xp, wp), 153, nacc=nacc)
    np.testing.assert_array_equal(got.numpy(), want)


def test_outer_shared_memory_check_is_a_function_of_the_shape():
    # the strips are ceil(Kw / 32) tiles of 128-byte rows, bm + bn rows
    # each, after 1024 bytes of alignment, then the barrier and the terms.
    # Kw = 128 (K = 4096): 128x128, 256x128 and 128x64 fit, the wider ones
    # do not
    assert G.outer_smem_bytes(128, 128, 128) == 1024 + 256 * 4 * 128 + 8 + 4 * 256
    assert G.outer_smem_bytes(128, 64, 128) == 100104  # two blocks a SM
    for bm, bn in ((128, 128), (256, 128), (128, 64)):
        G.check_outer_fits(bm, bn, 128)
    for bm, bn in ((256, 256), (512, 256), (1024, 128)):
        with pytest.raises(G.DoesNotFit, match="shared memory"):
            G.check_outer_fits(bm, bn, 128)
    # K = 1152 (Kw = 36, two tiles): all but 1024x128 fit; 512x256 takes
    # 200,712 bytes of 232,448
    G.check_outer_fits(512, 256, 36)
    with pytest.raises(G.DoesNotFit):
        G.check_outer_fits(1024, 128, 36)
    # K = 2304 (Kw = 72, three tiles): 256x256 fits, 512x256 does not
    G.check_outer_fits(256, 256, 72)
    with pytest.raises(G.DoesNotFit):
        G.check_outer_fits(512, 256, 72)
    # a tile holds 32 words: Kw = 31 and 32 take one, Kw = 33 two
    assert G.outer_smem_bytes(128, 64, 31) == G.outer_smem_bytes(128, 64, 32)
    assert G.outer_smem_bytes(128, 64, 33) - G.outer_smem_bytes(128, 64, 32) == 192 * 128
    # the wrapper refuses before any launch, on any device
    x, w = _t(*_case(3, 4096, 256))
    with pytest.raises(G.DoesNotFit):
        G.gemm_outer(x, w, 4096, 256, 256)


def test_wrappers_reject_what_the_kernels_do_not_take():
    x, w = _t(*_case(4, 100, 10))
    wt = w.t().contiguous()
    for call in (lambda: G.gemm_outer(x, w[:1], 100),
                 lambda: G.gemm_outer_acc(x, w[:1], 100),
                 lambda: G.gemm_chunk3d(x, w[:1], 100),
                 lambda: G.gemm_lanered(x, wt[:, :1], 100),
                 lambda: G.xnor_multiacc(x, w[:1], 100)):
        with pytest.raises(ValueError, match="Kw"):
            call()
    for call in (lambda: G.gemm_outer(x, w, 100, 64, 64),
                 lambda: G.gemm_outer_acc(x, w, 100, 128, 32, 3),
                 lambda: G.gemm_chunk3d(x, w, 100, 128, 128, 16),
                 lambda: G.gemm_lanered(x, wt, 100, 2, 8),
                 lambda: G.xnor_multiacc(x, w, 100, nacc=3)):
        with pytest.raises(ValueError, match="not compiled in"):
            call()
    with pytest.raises(TypeError, match="int32"):
        G.gemm_chunk3d(x, w.to(torch.int64), 100)
    with pytest.raises(ValueError, match="contiguous"):
        G.gemm_lanered(x, w.t(), 100)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        G.gemm_outer_acc(x.to("meta"), w.to("meta"), 100)


def test_cpu_tensors_never_count_launches():
    wrappers = (G.gemm_outer, G.gemm_outer_acc, G.gemm_chunk3d, G.gemm_lanered,
                G.xnor_multiacc)
    for fn in wrappers:
        fn.launches = 0
    x, w = _t(*_case(4, 64, 10))
    for fn in wrappers:
        fn(x, w.t().contiguous() if fn is G.gemm_lanered else w, 64)
    assert [fn.launches for fn in wrappers] == [0] * 5


def test_shootout_on_the_cpu_route():
    """The shootout's plumbing at a small shape: every candidate equal to B,
    the "does not fit" rows, the library row; CPU times are no measurement."""
    rows = gemm_shootout.main(shapes=[("tiny", 40, 4096, 24)], iters=2, repeats=1,
                              device="cpu")
    by_name = {r["candidate"]: r for r in rows}
    assert set(by_name) == set(gemm_shootout.candidates(4096)) | {gemm_shootout.LIBRARY}
    assert not by_name["outer-256x256"]["fits"]
    assert by_name["outer-128x128"]["fits"] and by_name["outer-128x128"]["equal"]
    assert all(np.isfinite(r["ms"]) for r in rows if r["fits"])
    assert by_name[gemm_shootout.LIBRARY]["unit_share"] is None
    # B runs on the single-bit tensor cores: held to their measured rate only
    base = by_name[gemm_shootout.BASELINE]
    assert base["unit_share"] is None and base["int8_share"] is None
    assert base["b1_share"] > 0 and by_name["chunk3d-64x64x4"]["b1_share"] is None
    # F1, F2 and F4 too, F2's and F4's geometries named by their columns,
    # K step and stages
    b1_rows = ["outer-128x128", "outer-128x64"]
    b1_rows += [G.outer_acc_name(*g) for g in G.OUTER_ACC_GEOMETRIES]
    b1_rows += [G.lanered_name(*g) for g in G.LANERED_GEOMETRIES]
    for name in b1_rows:
        row = by_name[name]
        assert row["fits"] and row["b1_share"] > 0
        assert row["unit_share"] is None and row["int8_share"] is None
    # F3 alone stays on the CUDA cores, held to its unit bound (its tree's
    # LOP3, IMAD and POPC on their pipes, its shared-memory bytes), which
    # POPC sets at kc = 4 and 8 and the LOP3 pipe at kc = 16
    for bm, bn, kc in G.CHUNK3D_GEOMETRIES:
        row = by_name[f"chunk3d-{bm}x{bn}x{kc}"]
        assert row["unit_share"] > 0 and row["unit"] == ("int" if kc == 16 else "popc")


def test_experiments_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from qnx_torch.bench import roofline
    from qnx_torch.experiments import vpu_probe, xnor_sol_variants

    for main in (gemm_shootout.main, xnor_sol_variants.main, vpu_probe.main,
                 roofline.main):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            main()


def test_sol_variants_on_the_cpu_route():
    from qnx_torch.experiments import xnor_sol_variants

    rows = xnor_sol_variants.main(m=24, k=160, n=40, iters=2, repeats=1, device="cpu")
    assert {r["variant"] for r in rows} == {"acc1", "acc2", "acc4", "b_tensor_core",
                                            "ternary_tensor_core"}
    for r in rows:
        assert set(r) >= {"variant", "ms", "tmacs", "spread", "vops_per_s_1e12"}
        # CUDA-core integer operations only where a variant runs there: G
        # runs on the single-bit tensor cores as B does, so none is left
        assert r["vops_per_s_1e12"] is None
    assert [r["ms"] for r in rows] == sorted(r["ms"] for r in rows)
