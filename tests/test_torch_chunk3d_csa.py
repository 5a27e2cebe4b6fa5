"""Kernel F3's walk (:func:`qnx_torch.kernels.gemm_formulations.gemm_chunk3d`,
``chunk3d_kernel`` of ``csrc/gemm_formulations.cu``) modelled in torch on
whole operands and held against the JAX body ``_chunk3d_kernel`` of
``experiments/gemm_shootout.py`` (run outside Pallas with numpy arrays
standing in for the refs).  Exact.

The model follows the kernel: x's rows padded to Kw rounded up to 4 words
(``tma_rows``), K in slabs of 32 words through a ring of
``CHUNK3D_RING`` stages that start stale and are refilled one slab ahead of
the slab being read (rows past M, columns past N and words past Kw staged as
0, w transposed); each slab in chunks of kc words, each output's kc XOR
words reduced by the carry-save tree of :func:`chunk3d_tree` (full adders
``a ^ b ^ c`` and ``maj(a, b, c)``), then one popcount a counter word,
shifted by its weight.  The tree's instruction counts
(:func:`chunk3d_issue`) and F3's unit bound
(:func:`qnx_torch.bench.roofline.chunk3d_unit_bound`) are checked here;
``chip_smoke.py`` holds the CUDA kernel against the plain version on the
card, its chunk loop's SASS against :func:`chunk3d_issue` and its ptxas
report against spills (its readers of both are checked here on made-up
text)."""
import functools
import importlib.util
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from qnx_torch.bench.roofline import chunk3d_unit_bound
from qnx_torch.experiments.gemm_shootout import random_words
from qnx_torch.kernels import gemm_formulations as G
from qnx_torch.kernels.xnor_gemm import xnor_gemm_popcount_ref
from qnx_torch.ops.packing import pack_bits_np, popcount

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def _load(name: str, path: Path):
    """A module loaded from its file (registered first: chip_smoke.py's
    dataclasses look their module up)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


SHOOTOUT = _load("jax_experiment_chunk3d_gemm_shootout",
                 ROOT / "experiments" / "gemm_shootout.py")

KCS = (4, 8, 16)
KWS = (1, 2, 3, 9, 17, 33, 128)
GEOMETRY_IDS = ["{}x{}x{}".format(*g) for g in G.CHUNK3D_GEOMETRIES]
# M and N ragged against every geometry (no multiple of 32, 64 or 128), more
# than one block of each
M, N = 70, 130


def full_add(a, b, c):
    return a ^ b ^ c, (a & b) | (c & (a ^ b))


def tree_sum(z: torch.Tensor, kc: int) -> torch.Tensor:
    """Sum of popcounts over the last axis (kc words) through
    :func:`chunk3d_tree`: the full adders in order, then the counters'
    popcounts shifted by their weights."""
    adders, counters = G.chunk3d_tree(kc)
    words = {i: z[..., i] for i in range(kc)}
    for _, a, b, c, s, carry in adders:
        words[s], words[carry] = full_add(words.pop(a), words.pop(b), words.pop(c))
    assert sorted(words) == sorted(i for _, i in counters)
    return sum(popcount(words[i]).to(torch.int64) << w for w, i in counters)


def walk(xp: torch.Tensor, wp: torch.Tensor, k: int, bm: int, bn: int,
         kc: int) -> torch.Tensor:
    """chunk3d_kernel's walk over every block at once (rows and columns
    padded to whole blocks), slab by slab through the ring."""
    slab, stages = G.CHUNK3D_SLAB, G.CHUNK3D_RING
    m, kw = xp.shape
    n = wp.shape[1]
    x = G.tma_rows(xp)
    kw4 = x.shape[1]
    slabs = -(-kw // slab)
    mp, np_ = -(-m // bm) * bm, -(-n // bn) * bn
    ring_x = torch.full((stages, mp, slab), -1, dtype=torch.int32)  # stale
    ring_w = torch.full((stages, np_, slab), -1, dtype=torch.int32)

    def fill(t: int) -> None:
        kw0 = t * slab
        xs = torch.zeros((mp, slab), dtype=torch.int32)
        # 16-byte units of x: a unit is staged whole where it starts below Kw4
        xs[:m, :min(slab, kw4 - kw0)] = x[:, kw0:kw0 + slab]
        ws = torch.zeros((np_, slab), dtype=torch.int32)
        ws[:n, :min(slab, kw - kw0)] = wp[kw0:kw0 + slab].t()
        ring_x[t % stages], ring_w[t % stages] = xs, ws

    for t in range(min(stages - 1, slabs)):
        fill(t)
    acc = torch.zeros((mp, np_), dtype=torch.int64)
    for t in range(slabs):
        ahead = t + stages - 1
        if ahead < slabs:
            # the refill goes into the stage read one slab before, never
            # into the one about to be read
            assert ahead % stages == (t - 1) % stages != t % stages
            fill(ahead)
        xs, ws = ring_x[t % stages], ring_w[t % stages]
        for c0 in range(0, slab, kc):
            z = xs[:, None, c0:c0 + kc] ^ ws[None, :, c0:c0 + kc]
            acc += tree_sum(z, kc)
    return (k - 2 * acc[:m, :n]).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _operands(kw: int, fill: str = ""):
    """Seeded words of (M, k) x (k, N) with zero pad bits, k = 32 Kw - 5
    (32 at Kw = 1); ``fill`` "ones": all-ones against all-ones words (s =
    k), "apart": all-ones against all-zero ones (s = -k)."""
    k = 32 * kw - (5 if kw > 1 else 0)
    if fill:
        xp = pack_bits_np(np.ones((M, k), np.float32), -1)
        wp = pack_bits_np(np.full((k, N), 1.0 if fill == "ones" else -1.0, np.float32), 0)
        return xp, wp, k
    rng = np.random.default_rng(kw)
    return random_words(rng, M, k), random_words(rng, N, k, along_rows=True), k


@functools.lru_cache(maxsize=None)
def _jax_body(kw: int, kc: int, fill: str = "") -> np.ndarray:
    xp, wp, k = _operands(kw, fill)
    out = np.zeros((M, N), np.int32)
    SHOOTOUT._chunk3d_kernel(xp, wp, out, k=k, kw=kw, kc=min(kc, kw))
    return out


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("kw", KWS)
@pytest.mark.parametrize("bm,bn,kc", G.CHUNK3D_GEOMETRIES, ids=GEOMETRY_IDS)
def test_walk_matches_jax_body(bm, bn, kc, kw):
    xp, wp, k = _operands(kw)
    got = walk(*_t(xp, wp), k, bm, bn, kc)
    want = _jax_body(kw, kc)
    np.testing.assert_array_equal(got.numpy(), want)
    # and the wrapper's CPU route, the plain version
    np.testing.assert_array_equal(G.gemm_chunk3d(*_t(xp, wp), k, bm, bn, kc).numpy(), want)


@pytest.mark.parametrize("fill", ["ones", "apart"])
@pytest.mark.parametrize("bm,bn,kc", G.CHUNK3D_GEOMETRIES, ids=GEOMETRY_IDS)
def test_walk_at_full_and_empty_counters(bm, bn, kc, fill):
    """All-ones words against all-ones (every XOR word 0, s = k) and against
    all-zero ones (every bit differs, every counter full, s = -k)."""
    for kw in (9, 33):
        xp, wp, k = _operands(kw, fill)
        got = walk(*_t(xp, wp), k, bm, bn, kc)
        assert torch.equal(got, torch.full((M, N), k if fill == "ones" else -k,
                                           dtype=torch.int32))
        np.testing.assert_array_equal(got.numpy(), _jax_body(kw, kc, fill))


def _words(kind: str, kc: int) -> torch.Tensor:
    """(64, kc) int32 words: seeded, all ones, alternating bit patterns, one
    bit set (a different one in each word), or the first kc - 1 full and the
    last one empty."""
    rng = np.random.default_rng(kc)
    if kind == "seeded":
        w = rng.integers(-2**31, 2**31, (64, kc), dtype=np.int64)
    elif kind == "ones":
        w = np.full((64, kc), -1, np.int64)
    elif kind == "alternating":
        w = np.where(np.arange(kc) % 2, 0x55555555, 0xAAAAAAAA)[None].repeat(64, 0)
    elif kind == "one_bit":
        w = (1 << ((np.arange(64)[:, None] + np.arange(kc)[None]) % 32)).astype(np.int64)
    else:
        w = np.full((64, kc), -1, np.int64)
        w[:, -1] = 0
    return torch.from_numpy(w.astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("kind", ["seeded", "ones", "alternating", "one_bit", "all_but_last"])
@pytest.mark.parametrize("kc", KCS)
def test_counter_identity(kc, kind):
    """sum_c popc(z_c) == sum 2^weight popc(counter), exactly, and at most
    32 kc (every counter full on all-ones words)."""
    z = _words(kind, kc)
    want = popcount(z).to(torch.int64).sum(-1)
    got = tree_sum(z, kc)
    assert torch.equal(got, want)
    if kind == "ones":
        assert torch.equal(got, torch.full((64,), 32 * kc, dtype=torch.int64))


@pytest.mark.parametrize("kc,lop3,popc", [(4, 6, 3), (8, 16, 4), (16, 38, 5)])
def test_chunk3d_issue(kc, lop3, popc):
    """The tree's instructions a chunk an output: kc XORs and two LOP3 a
    full adder; L + 1 POPC (L = floor(log2 kc)), where one a word would
    take kc, each folded by an IMAD; a weight-1 pair and one counter a
    higher weight."""
    assert G.chunk3d_issue(kc) == {"LOP3": lop3, "IMAD": popc, "POPC": popc}
    adders, counters = G.chunk3d_tree(kc)
    assert popc == kc.bit_length() == len(counters)
    assert len(adders) == kc - len(counters)  # each full adder drops one word
    weights = Counter(w for w, _ in counters)
    assert weights[0] == 2 and all(weights[w] == 1 for w in range(1, popc - 1))
    assert 1.5 <= lop3 / kc <= 2.375
    # every adder takes words of its weight that exist when it runs
    made = {i: 0 for i in range(kc)}
    for w, a, b, c, s, carry in adders:
        assert made.pop(a) == made.pop(b) == made.pop(c) == w
        made[s], made[carry] = w, w + 1
    assert sorted(made.items()) == sorted((i, w) for w, i in counters)
    with pytest.raises(ValueError, match="kc"):
        G.chunk3d_tree(2)


def test_unit_bound_at_the_scan_shape():
    """1024 x 4096 x 4096 (536,870,912 word pairs): POPC bounds kc = 4 and
    8 (kc = 8's LOP3 within 3% of it), the LOP3 pipe kc = 16; the IMAD
    pipe, the issue slots and shared memory none; a thread's larger tile
    reads fewer shared-memory bytes a pair."""
    from qnx_torch.bench.roofline import H100_PEAKS

    m, k, n = 1024, 4096, 4096
    pairs = m * n * (k // 32)
    for bm, bn, kc in G.CHUNK3D_GEOMETRIES:
        u = chunk3d_unit_bound(m, k, n, bm, bn, kc)
        assert u["unit"] == ("int" if kc == 16 else "popc")
        assert u["bound_s"] == max(u[f"{unit}_s"] for unit in
                                   ("int", "imad", "popc", "issue", "smem"))
        issue = G.chunk3d_issue(kc)
        assert u["popc_s"] == pytest.approx(pairs / kc * issue["POPC"] / H100_PEAKS["popc_ops"])
        assert u["int_s"] == pytest.approx(pairs / kc * issue["LOP3"] / H100_PEAKS["int_ops"])
        assert u["imad_s"] == pytest.approx(pairs / kc * issue["IMAD"] / H100_PEAKS["imad_ops"])
    kc8 = chunk3d_unit_bound(m, k, n, 64, 128, 8)
    assert kc8["int_s"] == pytest.approx(kc8["popc_s"], rel=0.03)
    assert (kc8["smem_s"] < chunk3d_unit_bound(m, k, n, 64, 64, 8)["smem_s"]
            < chunk3d_unit_bound(m, k, n, 32, 64, 16)["smem_s"])


def test_smem_fits_two_blocks_a_sm():
    for bm, bn, _ in G.CHUNK3D_GEOMETRIES:
        assert 2 * (G.chunk3d_smem_bytes(bm, bn) + 1024) <= 233472
    assert G.chunk3d_smem_bytes(64, 64) == 3 * 128 * 36 * 4


def test_the_rows_the_kernel_reads():
    """x as the kernel's 16-byte copies take it (``tma_rows``): rows of Kw
    rounded up to 4 words, zeros appended, at a 16-byte aligned address;
    on the CPU the wrapper gives B's s for any of them."""
    xp, wp, k = _operands(9)
    x, w = _t(xp, wp)
    padded = G.tma_rows(x)
    assert padded.shape == (M, 12) and not padded[:, 9:].any()
    assert torch.equal(padded[:, :9], x) and padded.data_ptr() % 16 == 0
    want = xnor_gemm_popcount_ref(x, w, k)
    for g in G.CHUNK3D_GEOMETRIES:
        assert torch.equal(G.gemm_chunk3d(x, w, k, *g), want)
    # Kw = 8 at an address 4 bytes past 16-byte alignment: copied, not padded
    base = torch.zeros(M * 8 + 4, dtype=torch.int32)
    start = next(i for i in range(4) if (base.data_ptr() + 4 * i) % 16 == 4)
    rng = np.random.default_rng(8)
    x8 = torch.from_numpy(random_words(rng, M, 256))
    w8 = torch.from_numpy(random_words(rng, N, 256, along_rows=True))
    odd = base[start:start + M * 8].view(M, 8)
    odd.copy_(x8)
    moved = G.tma_rows(odd)
    assert moved.data_ptr() % 16 == 0 and torch.equal(moved, x8)
    assert torch.equal(G.gemm_chunk3d(odd, w8, 256), xnor_gemm_popcount_ref(x8, w8, 256))


CHIP_SMOKE = _load("chip_smoke_for_chunk3d", ROOT / "chip_smoke.py")

_PTXAS = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114chunk3d_kernelILi64ELi64ELi8EEEvPKjS2_Piiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114chunk3d_kernelILi64ELi64ELi8EEEvPKjS2_Piiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 90 registers, used 1 barriers, 380 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN3qnx12_GLOBAL__N_121popcount_outer_kernelILi128ELi128EEEv' for 'sm_90a'
ptxas info    : Function properties for _ZN3qnx12_GLOBAL__N_121popcount_outer_kernelILi128ELi128EEEv
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 126 registers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114chunk3d_kernelILi64ELi128ELi8EEEvPKjS2_Piiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114chunk3d_kernelILi64ELi128ELi8EEEvPKjS2_Piiiii
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 380 bytes cmem[0]
"""


def test_chip_smoke_reads_ptxas_report():
    report = CHIP_SMOKE.ptxas_report(_PTXAS, "chunk3d_kernel")
    assert list(report.values()) == [
        {"stack": 0, "spill_stores": 0, "spill_loads": 0, "registers": 90},
        {"stack": 8, "spill_stores": 4, "spill_loads": 4, "registers": 128}]
    assert CHIP_SMOKE.blocks_per_sm(90, 256, G.chunk3d_smem_bytes(64, 64)) == 2
    assert CHIP_SMOKE.blocks_per_sm(64, 256, G.chunk3d_smem_bytes(64, 64)) == 4
    assert CHIP_SMOKE.blocks_per_sm(129, 256, 0) == 1


def _sass(popc: int, lop3: int) -> list:
    """A made-up chunk3d_kernel<64, 64, 8> body: a slab loop around a chunk
    loop of ``popc`` POPC and ``lop3`` LOP3."""
    lines, addr = [], 0

    def emit(text):
        nonlocal addr
        lines.append(f"        /*{addr:04x}*/                   {text} ;")
        addr += 0x10

    emit("LDS.128 R4, [R2]")
    slab = addr
    emit("BAR.SYNC.DEFER_BLOCKING 0x0")
    chunk = addr
    for _ in range(lop3):
        emit("LOP3.LUT R5, R4, R6, R7, 0x96, !PT")
    for _ in range(popc):
        emit("POPC R8, R5")
    emit("@P0 BRA 0x%x" % chunk)
    emit("@P1 BRA 0x%x" % slab)
    emit("EXIT")
    return lines


def test_chip_smoke_checks_the_chunk_loop(monkeypatch):
    name = "_ZN12_GLOBAL__N_114chunk3d_kernelILi{}ELi{}ELi{}EEEvPKjS2_Piiiii"
    report = {name.format(*g): {"registers": 90, "stack": 0, "spill_stores": 0,
                                "spill_loads": 0} for g in G.CHUNK3D_GEOMETRIES}
    logged = []
    monkeypatch.setattr(CHIP_SMOKE, "log", lambda phase, msg: logged.append(msg))
    # F3 64x64x8: 16 outputs a thread, 16 LOP3 and 4 POPC a chunk an output
    # at most
    functions = {name.format(64, 64, 8): _sass(popc=64, lop3=16 * 16)}
    monkeypatch.setattr(G, "CHUNK3D_GEOMETRIES", ((64, 64, 8),))
    CHIP_SMOKE.check_chunk3d(functions, report)
    assert "'POPC': 4.0" in logged[-1] and "'LOP3': 16.0" in logged[-1]
    for popc, lop3 in ((65, 1), (8, 16 * 16 + 1)):
        with pytest.raises(AssertionError, match="more LOP3 or POPC"):
            CHIP_SMOKE.check_chunk3d({name.format(64, 64, 8): _sass(popc=popc, lop3=lop3)},
                                     report)
    with pytest.raises(AssertionError, match="no LOP3"):
        CHIP_SMOKE.check_chunk3d({name.format(64, 64, 8): _sass(popc=8, lop3=0)}, report)
    spilled = dict(report)
    spilled[name.format(64, 64, 8)] = dict(report[name.format(64, 64, 8)], spill_stores=4)
    with pytest.raises(AssertionError, match="spills"):
        CHIP_SMOKE.check_chunk3d({}, spilled)
    with pytest.raises(AssertionError, match="no report"):
        CHIP_SMOKE.check_chunk3d({}, {})
