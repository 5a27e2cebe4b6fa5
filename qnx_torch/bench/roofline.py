"""Per-kernel roofline report on the card (torch port of
:mod:`qnx.bench.roofline`).

For each hot kernel of the port this measures the marginal time
(:mod:`qnx_torch.bench.microbench`, CUDA events, L2-warm) and holds it
against the least time one H100 could take for the same work: the larger of
its MACs at the rate of the tensor cores it runs on and its bytes (each
input read once, the output written once) at the device-memory rate, the
bound ``chip_smoke.py`` uses.  Every packed kernel's product fits the int8
tensor cores (±1 or level activations against ±1 or ternary weights), so
each is held to that rate, but kernels B, C and G at wide N, which run on
the single-bit tensor cores: B and G one AND-popcount MAC a MAC, C two
(against mask and against mask & sign), at the rate
``qnx_torch.bench.tc_probe`` measured.  A second, labelled column holds a
popcount kernel on the CUDA cores to the popc issue rate that
``qnx_torch.experiments.vpu_probe`` measured; no row here runs there since
G moved to the tensor cores (the shootout's F3 still does).  The fused
dense kernels of A, A' and D (on the int8 tensor cores since they were
redesigned) run in a few microseconds at the served batch of 256, less than
a host launch through their Python wrappers, so they and their library
call are timed as CUDA graph replays; so are B, C and G, whose calls at
1024x4096x4096 take less device time than a host launch.

    python -m qnx_torch.bench.roofline          # table on stdout, JSON rows on stderr

The byte counts are the port's real traffic: its convs gather the 3x3
patches inside the kernel (implicit GEMM), so the JAX count's 9x patch
materialisation is not in them.
"""
from __future__ import annotations

import json
import sys
from dataclasses import dataclass

import numpy as np
import torch

from qnx_torch.bench.microbench import device_label, resolve_device, time_fn_marginal

H100_PEAKS = {
    # NVIDIA H100 SXM data sheet, dense, at the 700 W power limit: 1,979
    # int8 TOP/s and 989 bf16 TFLOP/s on the tensor cores, 3.35 TB/s HBM3
    "int8_macs": 1979e12 / 2,
    "bf16_macs": 989e12 / 2,
    "hbm_bytes": 3.35e12,
    # single-bit MACs (wgmma m64n128k256 .b1.b1.and.popc) per second of the
    # whole card, measured: qnx_torch.bench.tc_probe at 2048 -> 8192
    # iterations on tiles in shared memory, 30,256 a clock a SM at the
    # 1,980 MHz nvidia-smi read, 7.95x the s8 wgmma's 9.943e14 in the same
    # run (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6)
    "b1_macs": 7.9076e15,
    # popc instructions per second of the whole card: 16 a clock an SM,
    # the rate of compute capability 9.0 (CUDA C++ Programming Guide,
    # arithmetic instructions), at the 1,980 MHz SM clock nvidia-smi read x
    # 132 SMs.  Measured: the `pc` mode of qnx_torch.experiments.vpu_probe
    # (kernel H) issued 15.84 a clock an SM (96 against 32 steps) and 15.96
    # (384 against 128) (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6)
    "popc_ops": 16 * 132 * 1.98e9,
    # integer instructions per second of the whole card, measured: kernel H
    # (qnx_torch.experiments.vpu_probe, 384 against 128 steps at 4096 x
    # 1024, the 1,980 MHz SM clock nvidia-smi read, x 132 SMs; NVIDIA H100
    # 80GB HBM3, 700.00 W; PERF.md §6).  `xor` issued 64.90 LOP3 and 64.90
    # VIADD a clock an SM, `mul` 64.78 IMAD and 64.78 IADD3, `csa` 43.50 LOP3
    # and 21.75 IADD3: LOP3 and IADD3 share one pipe (int_ops), IMAD and
    # VIADD issue on another (imad_ops), and every instruction goes through
    # one issue slot a clock a scheduler, 129.8 a clock an SM (issue_ops)
    "int_ops": 64.90 * 132 * 1.98e9,
    "imad_ops": 64.78 * 132 * 1.98e9,
    "issue_ops": 129.80 * 132 * 1.98e9,
    # shared-memory bytes per second of the whole card: 32 banks of 4 bytes
    # a clock an SM (CUDA C++ Programming Guide, shared memory) at 1,980 MHz
    # x 132 SMs
    "smem_bytes": 128 * 132 * 1.98e9,
}

#: the H100_PEAKS rate each SASS opcode's pipe issues at on the CUDA cores,
#: as kernel H measured them (LEA and SHF beside LOP3 and IADD3, as the
#: CUDA C++ Programming Guide lists shifts); every opcode, these and others
#: (shared loads, branches), also takes an issue slot
PIPE_OF = {"LOP3": "int_ops", "IADD3": "int_ops", "LEA": "int_ops", "SHF": "int_ops",
           "IMAD": "imad_ops", "VIADD": "imad_ops", "POPC": "popc_ops"}


def issue_times(counts: dict) -> dict:
    """Seconds the whole card takes to issue ``counts`` ({SASS opcode:
    instructions}) on each pipe of the CUDA cores at its measured rate
    (:data:`PIPE_OF`), and all of them through the issue slots
    (``issue_ops``): {"issue_ops", and "int_ops" | "imad_ops" | "popc_ops"
    for the pipes the counts use: seconds}."""
    times = {"issue_ops": sum(counts.values()) / H100_PEAKS["issue_ops"]}
    for op, c in counts.items():
        if op in PIPE_OF:
            pipe = PIPE_OF[op]
            times[pipe] = times.get(pipe, 0.0) + c / H100_PEAKS[pipe]
    return times


def chunk3d_unit_bound(m: int, k: int, n: int, bm: int, bn: int, kc: int) -> dict:
    """The least time of kernel F3 (``gemm_chunk3d``) at (M, K, N) and its
    geometry on the units it runs on: the instructions its carry-save tree
    issues for the M N Kw word pairs
    (``gemm_formulations.chunk3d_issue``) and its 16-byte shared loads, each
    on its pipe and all through the issue slots (:func:`issue_times`), and
    its shared-memory bytes at
    ``smem_bytes`` (each chunk a thread reads its bm / 16 rows' and bn / 16
    columns' kc words; each block writes its x and w strips once).
    ``{"<unit>_s": seconds, ..., "bound_s", "unit"}``, ``unit`` the one
    that bounds it."""
    from qnx_torch.kernels.gemm_formulations import chunk3d_issue

    kw = -(-k // 32)
    chunks = m * n * kw / kc
    counts = {op: c * chunks for op, c in chunk3d_issue(kc).items()}
    counts["LDS"] = chunks * kc / 4 * (16 / bm + 16 / bn)  # 16-byte shared loads
    times = {unit.removesuffix("_ops"): t for unit, t in issue_times(counts).items()}
    pairs_bytes = 4 * m * n * kw * (16 / bm + 16 / bn)
    fill_bytes = 4 * kw * (m * -(-n // bn) + n * -(-m // bm))
    times["smem"] = (pairs_bytes + fill_bytes) / H100_PEAKS["smem_bytes"]
    unit = max(times, key=times.get)
    return {**{f"{u}_s": t for u, t in times.items()}, "bound_s": times[unit],
            "unit": unit}


@dataclass
class KernelResult:
    name: str
    t_measured_s: float
    macs: int
    bytes_moved: int
    peak_key: str
    ops_per_mac: float = 1.0   # peak-rate operations per MAC
    popc_per_mac: float = 0.0  # popc instructions per MAC; 0: not a popcount kernel

    @property
    def t_compute(self) -> float:
        return self.macs * self.ops_per_mac / H100_PEAKS[self.peak_key]

    @property
    def t_memory(self) -> float:
        return self.bytes_moved / H100_PEAKS["hbm_bytes"]

    @property
    def speed_of_light(self) -> float:
        return max(self.t_compute, self.t_memory)

    @property
    def bound(self) -> str:
        return "compute" if self.t_compute >= self.t_memory else "memory"

    @property
    def t_popc(self) -> float | None:
        """The popc ceiling's time, or None for a kernel that issues none."""
        if not self.popc_per_mac:
            return None
        return self.macs * self.popc_per_mac / H100_PEAKS["popc_ops"]

    def row(self) -> dict:
        t_popc = self.t_popc
        return {
            "kernel": self.name,
            "measured_ms": self.t_measured_s * 1e3,
            "tmacs": self.macs / self.t_measured_s / 1e12,
            "sol_ms": self.speed_of_light * 1e3,
            "sol_fraction": self.speed_of_light / self.t_measured_s,
            "bound": self.bound,
            "popc_ceiling_ms": None if t_popc is None else t_popc * 1e3,
            "popc_fraction": None if t_popc is None else t_popc / self.t_measured_s,
        }


#: (hw, cin, cout, pool, tag) per measured VGG conv layer (width 128)
CONV_SHAPES = [(32, 128, 128, True, "conv2"),
               (16, 256, 256, True, "conv4"),
               (8, 512, 512, True, "conv6")]
#: (K, N, tag) per measured dense layer, at the engine's batch DENSE_BATCH
DENSE_SHAPES = [(4096, 4096, "MNIST hidden"), (8192, 1024, "VGG dense_0")]
DENSE_BATCH = 256


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _measure(results: list, name: str, fn, inputs: list, macs: int, peak_key: str,
             iters, repeats, device, ops_per_mac: float = 1.0,
             popc_per_mac: float = 0.0, graph: bool = False) -> None:
    """Time ``fn()`` (``graph``: as CUDA graph replays) and append its
    :class:`KernelResult`; bytes are the inputs' and the output's."""
    out = fn()
    t = time_fn_marginal(fn, iters=iters, repeats=repeats, device=device,
                         graph=graph)
    results.append(KernelResult(name, t, macs, _nbytes(*inputs, out), peak_key,
                                ops_per_mac=ops_per_mac, popc_per_mac=popc_per_mac))


def measure_kernels(batch: int = 1024, iters: int | None = None,
                    repeats: int = 5, gemm_k: int = 4096, gemm_n: int = 4096,
                    conv_shapes: list | None = None,
                    dense_shapes: list | None = None,
                    dense_batch: int = DENSE_BATCH,
                    device="cuda") -> list[KernelResult]:
    """Measure the port's hot kernels at the JAX report's shapes: kernels
    B and C at ``batch`` x ``gemm_k`` x ``gemm_n`` (on the single-bit
    tensor cores), beside G with one accumulator set (B's schedule through
    the formulations' entry, at the same single-bit bound), E, A and A' at
    ``conv_shapes`` (default :data:`CONV_SHAPES`), beside ``torch._int_mm``
    on the same int8 products (the library GEMM alone, no gather, epilogue
    or pool: the counterpart of the JAX report's XLA rows) and a bf16
    ``torch.matmul`` calibration row at 2 ``batch`` x ``gemm_k`` x
    ``gemm_n`` (the JAX report's 2048 x 4096 x 4096 at the defaults); and
    the fused dense kernels of A, A' and D (two planes, three thresholds)
    at ``dense_batch`` x ``dense_shapes`` (default :data:`DENSE_SHAPES`)
    beside ``torch._int_mm``, all four as CUDA graph replays."""
    from qnx_torch.kernels.gemm_formulations import xnor_multiacc
    from qnx_torch.kernels.i8_conv_fused import i8_conv_fused, k_major
    from qnx_torch.kernels.plane_gemm import plane_dense_fused
    from qnx_torch.kernels.ternary_gemm import ternary_gemm
    from qnx_torch.kernels.xnor_conv import (pack_conv_ternary_np,
                                             pack_conv_weights_np,
                                             padding_correction)
    from qnx_torch.kernels.xnor_conv_fused import (ternary_conv_fused,
                                                   ternary_gemm_fused,
                                                   xnor_conv_fused,
                                                   xnor_gemm_fused)
    from qnx_torch.kernels.xnor_gemm import xnor_gemm_popcount
    from qnx_torch.ops.packing import pack_bits_np, pack_ternary_np

    device = resolve_device(device)
    rng = np.random.default_rng(0)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    pm1 = lambda shape: np.where(rng.random(shape) < 0.5, 1, -1).astype(np.int8)
    timing = dict(iters=iters, repeats=repeats, device=device)
    out: list[KernelResult] = []

    # int8 GEMM (the MLP hidden layer's 4096x4096) and the packed GEMMs on
    # the same ±1 values
    m, k, n = batch, gemm_k, gemm_n
    x8, w8 = pm1((m, k)), pm1((k, n))
    a8, b8t = dev(x8), dev(np.ascontiguousarray(w8.T))  # B column-major
    _measure(out, f"int8 GEMM torch._int_mm {m}x{k}x{n} (library)",
             lambda: torch._int_mm(a8, b8t.t()), [a8, b8t], m * k * n,
             "int8_macs", **timing)
    xp, wp = dev(pack_bits_np(x8, -1)), dev(pack_bits_np(w8, 0))
    # B and C run under a host launch: CUDA graph replays
    _measure(out, f"popcount GEMM B {m}x{k}x{n} [b1 tensor cores]",
             lambda: xnor_gemm_popcount(xp, wp, k), [xp, wp], m * k * n,
             "b1_macs", graph=True, **timing)
    _measure(out, f"popcount GEMM G nacc=1 {m}x{k}x{n} [b1 tensor cores: B's "
             f"schedule]", lambda: xnor_multiacc(xp, wp, k, nacc=1), [xp, wp],
             m * k * n, "b1_macs", graph=True, **timing)
    wt = np.where(rng.random((k, n)) < 0.3, 0, w8).astype(np.float32)
    mask, sign, nnz = map(dev, pack_ternary_np(wt, 0))
    _measure(out, f"ternary two-plane GEMM C {m}x{k}x{n} [b1 tensor cores]",
             lambda: ternary_gemm(xp, mask, sign, nnz), [xp, mask, sign, nnz],
             m * k * n, "b1_macs", ops_per_mac=2, graph=True, **timing)

    # the VGG's convs: the library GEMM alone, then E, A and A' fused
    for hw, cin, cout, pool, tag in CONV_SHAPES if conv_shapes is None else conv_shapes:
        shape = f"{tag} {hw}x{hw} {cin}->{cout}"
        macs = batch * hw * hw * 9 * cin * cout
        pa, pb = dev(pm1((batch * hw * hw, 9 * cin))), dev(pm1((cout, 9 * cin)))
        _measure(out, f"int8 conv GEMM [torch._int_mm, GEMM only] {shape}",
                 lambda: torch._int_mm(pa, pb.t()), [pa, pb], macs, "int8_macs",
                 **timing)
        del pa, pb
        sgn = dev(rng.choice(np.array([-1, 1], np.int32), cout))
        tau = dev(rng.integers(-20, 20, cout).astype(np.int32))
        xc = pm1((batch, hw, hw, cin))
        xi, wc = dev(xc), dev(rng.integers(-1, 2, (3, 3, cin, cout)).astype(np.int8))
        wk = k_major(wc)  # as I8Conv holds them
        _measure(out, f"int8 conv+epilogue [E fused] {shape}",
                 lambda: i8_conv_fused(xi, wc, sgn, tau, encoding="pm1", pool=pool,
                                       wk=wk),
                 [xi, wk, sgn, tau], macs, "int8_macs", **timing)
        xpb = dev(pack_bits_np(xc, -1))
        del xi
        pat = rng.choice(np.array([-1.0, 1.0], np.float32), (3, 3, cin, cout))
        wpb, kb = pack_conv_weights_np(pat)
        wpb, corr = dev(wpb), dev(padding_correction(pat, hw, hw))
        _measure(out, f"xnor conv fused [A] {shape}",
                 lambda: xnor_conv_fused(xpb, wpb, kb, corr, sgn, tau, pool=pool),
                 [xpb, wpb, corr, sgn, tau], macs, "int8_macs", **timing)
        pat = rng.choice(np.array([-1.0, 0.0, 1.0], np.float32), (3, 3, cin, cout))
        tplanes = [dev(a) for a in pack_conv_ternary_np(pat)]
        corr = dev(padding_correction(pat, hw, hw))
        _measure(out, f"ternary conv fused [A'] {shape}",
                 lambda: ternary_conv_fused(xpb, *tplanes, corr, sgn, tau, pool=pool),
                 [xpb, *tplanes, corr, sgn, tau], macs, "int8_macs", **timing)

    # the fused dense layers on the int8 tensor cores and the library GEMM
    # on the same int8 product, as graph replays
    graphed = dict(timing, graph=True)
    m = dense_batch
    for k, n, tag in DENSE_SHAPES if dense_shapes is None else dense_shapes:
        shape, macs = f"{tag} {m}x{k}x{n}", m * k * n
        x8, w8 = pm1((m, k)), pm1((k, n))
        a8, b8t = dev(x8), dev(np.ascontiguousarray(w8.T))
        _measure(out, f"int8 GEMM torch._int_mm {shape} (library)",
                 lambda: torch._int_mm(a8, b8t.t()), [a8, b8t], macs, "int8_macs",
                 **graphed)
        sgn = dev(rng.choice(np.array([-1, 1], np.int32), n))
        tau = dev(rng.integers(-20, 20, n).astype(np.int32))
        xp, wp = dev(pack_bits_np(x8, -1)), dev(pack_bits_np(w8, 0))
        _measure(out, f"xnor dense fused [A] {shape}",
                 lambda: xnor_gemm_fused(xp, wp, k, sgn, tau),
                 [xp, wp, sgn, tau], macs, "int8_macs", **graphed)
        wt = np.where(rng.random((k, n)) < 0.5, 0, w8).astype(np.float32)
        tplanes = [dev(a) for a in pack_ternary_np(wt, 0)]
        _measure(out, f"ternary dense fused [A'] {shape}",
                 lambda: ternary_gemm_fused(xp, *tplanes, sgn, tau),
                 [xp, *tplanes, sgn, tau], macs, "int8_macs", **graphed)
        lvl = rng.integers(0, 4, (m, k))
        planes = dev(np.stack([pack_bits_np((lvl >> j) & 1, -1) for j in range(2)]))
        mask, msign = tplanes[0], tplanes[0] & tplanes[1]
        taus = dev(np.sort(rng.integers(-60, 60, (3, n)), axis=0).astype(np.int32))
        _measure(out, f"plane dense fused [D] P=2 {shape}",
                 lambda: plane_dense_fused(planes, mask, msign, sgn, taus),
                 [planes, mask, msign, sgn, taus], macs, "int8_macs", **graphed)

    # calibration: a bf16 GEMM against the bf16 tensor-core rate
    cm, ck, cn = 2 * batch, gemm_k, gemm_n
    gen = torch.Generator().manual_seed(0)
    xf = torch.randn(cm, ck, generator=gen).to(device, torch.bfloat16)
    wf = torch.randn(ck, cn, generator=gen).to(device, torch.bfloat16)
    _measure(out, f"bf16 GEMM torch.matmul {cm}x{ck}x{cn} (calibration)",
             lambda: torch.matmul(xf, wf), [xf, wf], cm * ck * cn, "bf16_macs",
             **timing)
    return out


def main(device="cuda", **kwargs) -> list[dict]:
    label = device_label(device)
    rows = [r.row() for r in measure_kernels(device=device, **kwargs)]
    width = max(len(r["kernel"]) for r in rows)
    print(f"# {label}; marginal times, L2-warm where the operands fit in 50 MB")
    print(f"{'kernel':<{width}}  {'ms':>9} {'TMAC/s':>8} {'SoL ms':>9} "
          f"{'SoL frac':>8}  {'bound':<7} {'popc ms':>9} {'popc frac':>9}")
    for r in rows:
        popc = ("" if r["popc_ceiling_ms"] is None else
                f"{r['popc_ceiling_ms']:>9.4f} {r['popc_fraction']:>9.3f}")
        print(f"{r['kernel']:<{width}}  {r['measured_ms']:>9.4f} "
              f"{r['tmacs']:>8.2f} {r['sol_ms']:>9.4f} "
              f"{r['sol_fraction']:>8.3f}  {r['bound']:<7} {popc}")
    for r in rows:
        print(json.dumps({"device": label, **r}), file=sys.stderr)
    return rows


if __name__ == "__main__":
    main()
