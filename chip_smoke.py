#!/usr/bin/env python3
"""Bring-up check of the qnx_torch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path — the full-width ``cifar10-bnn`` packed VGG
(width 128, dense 1024, random weights from seed 0) served by
``qnx_torch.serve.ServeEngine`` — through the hand-written CUDA kernels in
``qnx_torch/kernels/csrc/``, which it builds from source first.  Phases:

1. device: the card, torch, CUDA and nvcc versions;
2. build: compile the kernels, with the ptxas register report;
3. kernels: each kernel against its plain PyTorch version on the card at the
   slice's seven layer shapes (batch 32) and ragged cases — packed output
   words must be equal;
4. slice: 600 uint8 requests through the engine; every request answered,
   each layer's words equal to the plain path's, logits equal to the plain
   path's and to the JAX package's committed golden logits, and each
   kernel's launch count equal to layers x batches;
5. times: each kernel against its plain version at batch 256 and the
   end-to-end forward, with CUDA events;
6. stages: each stage of the batch-256 forward alone, its peak memory, and
   the engine's throughput over 40 queued batches.

Any failure raises (non-zero exit).  The last lines are a JSON summary of
the kernels, the card's ``name, power.limit``, and the result object.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "torch_port_golden_cifar10_bnn.npz"

CHECK_BATCH = 32
TIME_BATCH = 256
SERVE_BATCH = 256
ENGINE_BATCHES = 40  # full batches queued for the engine's throughput
CHUNKS = (8, 100, 300, 92, 100)  # 600 requests: one chunk splits, tail pads
# logits: the engine and the plain path run the same float head on equal
# bits; against JAX only the f32 summation order of the first conv and the
# head differ (measured on CPU: 1.9e-6 of a max |logit| of 3.9)
LOGIT_RTOL = 1e-5
LOGIT_ATOL_REL = 1e-4  # times max |logit|
I32_MIN, I32_MAX = -2**31, 2**31 - 1

# (H, W, C_in, N, pool) of conv_1..conv_5 and (K, N) of dense_0, dense_1
CONV_SHAPES = [(32, 32, 128, 128, True), (16, 16, 128, 256, False),
               (16, 16, 256, 256, True), (8, 8, 256, 512, False),
               (8, 8, 512, 512, True)]
DENSE_SHAPES = [(8192, 1024), (1024, 1024)]


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True,
                          timeout=120).stdout.strip()


# ---------------------------------------------------------------- operands

def epilogue(rng, n: int, k: int):
    """Mixed-direction thresholds around the spread of s, with int32-extreme
    channels (the folded gamma == 0 constant bits)."""
    sgn = rng.choice(np.array([1, -1], np.int32), n)
    lim = 2 * int(np.sqrt(k)) + 1
    tau = rng.integers(-lim, lim, n).astype(np.int32)
    tau[0], tau[1], tau[2] = I32_MIN, I32_MAX, I32_MAX
    sgn[1] = -1
    return sgn, tau


def conv_operands(torch, rng, b, h, w, c, n):
    from qnx_torch.kernels.xnor_conv import (pack_conv_weights_np,
                                             padding_correction)
    from qnx_torch.ops.packing import pack_bits_np

    x = np.where(rng.random((b, h, w, c)) < 0.5, 1.0, -1.0).astype(np.float32)
    pattern = np.where(rng.random((3, 3, c, n)) < 0.5, 1.0, -1.0)
    wp, k = pack_conv_weights_np(pattern.astype(np.float32))
    sgn, tau = epilogue(rng, n, k)
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    return (cuda(pack_bits_np(x, -1)), cuda(wp), k,
            cuda(padding_correction(pattern, h, w)), cuda(sgn), cuda(tau))


def dense_operands(torch, rng, m, k, n):
    from qnx_torch.ops.packing import pack_bits_np

    x = np.where(rng.random((m, k)) < 0.5, 1.0, -1.0)
    w = np.where(rng.random((k, n)) < 0.5, 1.0, -1.0)
    sgn, tau = epilogue(rng, n, k)
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    return (cuda(pack_bits_np(x, -1)), cuda(pack_bits_np(w, 0)), k,
            cuda(sgn), cuda(tau))


def word_err(torch, got, want) -> float:
    """Max |difference| of the ±1 codes the two word tensors hold."""
    from qnx_torch.ops.packing import unpack_bits

    kbits = got.shape[-1] * 32
    a = unpack_bits(got, kbits, dtype=torch.float32)
    b = unpack_bits(want, kbits, dtype=torch.float32)
    return float((a - b).abs().max())


# ---------------------------------------------------------------- phases

def phase_device(torch) -> str:
    from qnx_torch.kernels import _build

    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    clocks = run(["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
                  "--format=csv,noheader"]).splitlines()[0]
    nvcc = run([_build._nvcc(), "--version"]).splitlines()[-1]
    print(card, flush=True)
    log("device", f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
        f" | max/current SM clock {clocks} | torch {torch.__version__} "
        f"CUDA {torch.version.cuda} | {nvcc}")
    return card


def phase_build() -> None:
    from qnx_torch.kernels import _build

    fresh = not _build.library_path().exists()
    t0 = time.perf_counter()
    _build.load()
    dt = time.perf_counter() - t0
    log("build", f"{_build.library_path().name} "
        f"{'built' if fresh else 'reused'} in {dt:.2f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("build", line.strip())


def phase_kernels(torch, err: dict) -> None:
    from qnx_torch.kernels import xnor_conv_fused as F

    rng = np.random.default_rng(10)
    cases = [("conv", CHECK_BATCH, s) for s in CONV_SHAPES]
    cases += [("dense", CHECK_BATCH, s) for s in DENSE_SHAPES]
    cases += [("conv", 3, CONV_SHAPES[0]), ("conv", 3, (5, 7, 32, 64, False)),
              ("dense", 3, DENSE_SHAPES[0])]  # ragged batch, odd spatial
    for kind, b, shape in cases:
        if kind == "conv":
            h, w, c, n, pool = shape
            xp, wp, k, corr, sgn, tau = conv_operands(torch, rng, b, h, w, c, n)
            got = F.xnor_conv_fused(xp, wp, k, corr, sgn, tau, pool=pool)
            want = F.xnor_conv_fused_ref(xp, wp, k, corr, sgn, tau, pool=pool)
            name = "xnor_conv3x3_fused"
        else:
            k_in, n = shape
            xp, wp, k, sgn, tau = dense_operands(torch, rng, b, k_in, n)
            got = F.xnor_gemm_fused(xp, wp, k, sgn, tau)
            want = F.xnor_gemm_fused_ref(xp, wp, k, sgn, tau)
            name = "xnor_dense_fused"
        torch.cuda.synchronize()
        e = word_err(torch, got, want)
        err[name] = max(err[name], e)
        ones = float(torch.stack([(want >> j) & 1 for j in range(32)]).float().mean())
        log("kernels", f"{name} batch {b} {shape}: out {tuple(got.shape)}, "
            f"words equal {torch.equal(got, want)}, max_abs_err {e}, "
            f"share of 1 bits {ones:.3f}")
        if not torch.equal(got, want):
            raise AssertionError(f"{name} {b} {shape}: kernel words differ "
                                 "from the plain version's")


def plain_forward(torch, model, x, err: dict):
    """The model's forward with each packed layer run both ways on the same
    input bits: kernel words must equal the plain version's."""
    from qnx_torch.kernels import xnor_conv_fused as F

    bits = model.first(x)
    for i, conv in enumerate(model.convs, 1):
        got = conv(bits)
        bits = F.xnor_conv_fused_ref(bits, conv.wp, conv.k, conv.corr,
                                     conv.sgn, conv.tau, pool=conv.pool)
        err["xnor_conv3x3_fused"] = max(err["xnor_conv3x3_fused"],
                                        word_err(torch, got, bits))
        if not torch.equal(got, bits):
            raise AssertionError(f"conv_{i}: kernel words differ from plain")
    bits = bits.reshape(bits.shape[0], -1)
    for j, dense in enumerate(model.denses):
        got = dense(bits)
        bits = F.xnor_gemm_fused_ref(bits, dense.wp, dense.k, dense.sgn,
                                     dense.tau)
        err["xnor_dense_fused"] = max(err["xnor_dense_fused"],
                                      word_err(torch, got, bits))
        if not torch.equal(got, bits):
            raise AssertionError(f"dense_{j}: kernel words differ from plain")
    return model.head(bits)


def phase_slice(torch, err: dict):
    from qnx_torch.convert.pack_model import pack_vgg
    from qnx_torch.kernels import xnor_conv_fused as F
    from qnx_torch.models.factory import init_variables
    from qnx_torch.serve.engine import ServeEngine, normalize_u8
    from qnx_torch.utils.config import CIFAR10_BNN

    model = pack_vgg(init_variables(CIFAR10_BNN, seed=0), CIFAR10_BNN).to("cuda")
    golden = np.load(GOLDEN)
    images = np.random.default_rng(2).integers(
        0, 256, (sum(CHUNKS), *CIFAR10_BNN.input_shape), dtype=np.uint8)
    images[:len(golden["images"])] = golden["images"]

    engine = ServeEngine(model, batch_size=SERVE_BATCH, max_wait_ms=50.0)
    futs, off = [], 0
    for size in CHUNKS:  # queued before start: the batching is deterministic
        futs += engine.submit_many(images[off:off + size])
        off += size
    F.xnor_conv_fused.launches = 0
    F.xnor_gemm_fused.launches = 0
    engine.start()
    try:
        logits = np.stack([f.result(timeout=600) for f in futs])
    finally:
        engine.stop()
    launches = {"xnor_conv3x3_fused": F.xnor_conv_fused.launches,
                "xnor_dense_fused": F.xnor_gemm_fused.launches}
    stats = engine.stats()
    batches = stats["batches"]
    log("slice", f"engine answered {len(logits)}/{len(images)} requests in "
        f"{batches} batches of {SERVE_BATCH} (pad fraction "
        f"{stats['pad_fraction']:.3f}); launches {launches}")
    if len(logits) != len(images) or not all(f.done() for f in futs):
        raise AssertionError("not every request was answered")
    if logits.shape != (len(images), CIFAR10_BNN.classes) or not np.isfinite(logits).all():
        raise AssertionError(f"bad logits: shape {logits.shape}")
    if launches != {"xnor_conv3x3_fused": 5 * batches, "xnor_dense_fused": 2 * batches}:
        raise AssertionError(f"launch counts {launches} != 5 conv and 2 dense "
                             f"per batch x {batches} batches")

    plain = []
    with torch.inference_mode():
        for s in range(0, len(images), SERVE_BATCH):
            x = normalize_u8(torch.from_numpy(images[s:s + SERVE_BATCH]).cuda())
            plain.append(plain_forward(torch, model, x, err).cpu().numpy())
    plain = np.concatenate(plain)
    d_plain = float(np.abs(logits - plain).max())
    np.testing.assert_allclose(
        logits, plain, rtol=LOGIT_RTOL,
        atol=LOGIT_ATOL_REL * float(np.abs(plain).max()))
    if not (logits.argmax(-1) == plain.argmax(-1)).all():
        raise AssertionError("argmax differs from the plain path")
    gold = golden["logits"]
    ours = logits[:len(gold)]
    d_gold = float(np.abs(ours - gold).max())
    np.testing.assert_allclose(ours, gold, rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL_REL * float(np.abs(gold).max()))
    if not (ours.argmax(-1) == gold.argmax(-1)).all():
        raise AssertionError("argmax differs from the JAX golden")
    log("slice", f"7 layers' words equal to the plain path for all "
        f"{len(images)} images; logits max |engine - plain| {d_plain:.3g}, "
        f"max |engine - JAX golden| {d_gold:.3g} (max |logit| "
        f"{float(np.abs(gold).max()):.3g}); argmax identical")
    return model, launches


def time_ms(torch, fn, iters: int, reps: int = 7) -> list[float]:
    """Per-call ms of ``fn`` from CUDA events around ``iters`` calls, ``reps``
    times, after a warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return out


def fmt(ms: list[float]) -> str:
    return (f"median {statistics.median(ms):.4f} ms "
            f"(min {min(ms):.4f}, max {max(ms):.4f}, n={len(ms)})")


def phase_times(torch, card: str, model) -> dict:
    from qnx_torch.kernels import xnor_conv_fused as F

    rng = np.random.default_rng(11)
    total = {"xnor_conv3x3_fused": [0.0, 0.0], "xnor_dense_fused": [0.0, 0.0]}
    b = TIME_BATCH
    for kind, shape in ([("conv", s) for s in CONV_SHAPES]
                        + [("dense", s) for s in DENSE_SHAPES]):
        if kind == "conv":
            h, w, c, n, pool = shape
            xp, wp, k, corr, sgn, tau = conv_operands(torch, rng, b, h, w, c, n)
            kern = lambda: F.xnor_conv_fused(xp, wp, k, corr, sgn, tau, pool=pool)
            ref = lambda: F.xnor_conv_fused_ref(xp, wp, k, corr, sgn, tau, pool=pool)
            name = "xnor_conv3x3_fused"
        else:
            k_in, n = shape
            xp, wp, k, sgn, tau = dense_operands(torch, rng, b, k_in, n)
            kern = lambda: F.xnor_gemm_fused(xp, wp, k, sgn, tau)
            ref = lambda: F.xnor_gemm_fused_ref(xp, wp, k, sgn, tau)
            name = "xnor_dense_fused"
        # interleaved: plain, kernel, kernel, plain
        p1, k1 = time_ms(torch, ref, 3, 3), time_ms(torch, kern, 20, 4)
        k2, p2 = time_ms(torch, kern, 20, 4), time_ms(torch, ref, 3, 3)
        kt, pt = k1 + k2, p1 + p2
        total[name][0] += statistics.median(kt)
        total[name][1] += statistics.median(pt)
        log("times", f"{card} | {name} batch {b} {shape}: kernel {fmt(kt)}; "
            f"plain {fmt(pt)}")

    x = torch.from_numpy(np.random.default_rng(12).uniform(
        -1, 1, (b, 32, 32, 3)).astype(np.float32)).cuda()
    with torch.inference_mode():
        fwd = time_ms(torch, lambda: model(x), 10)
    med = statistics.median(fwd)
    log("times", f"{card} | end-to-end PackedVGG forward batch {b}: {fmt(fwd)}"
        f" = {b / med * 1e3:.1f} img/s")
    log("times", f"{card} | per forward at batch {b}, summed over the layer "
        f"shapes: " + "; ".join(f"{k} kernel {v[0]:.4f} ms, plain {v[1]:.4f} ms"
                                for k, v in total.items()))
    return total


def phase_stages(torch, card: str, model) -> None:
    """Where the time goes at batch 256: each stage of the forward alone on
    the slice's own activations, the forward's peak memory, and the engine
    over many queued batches (host clock, first dispatch to last answer)."""
    from qnx_torch.ops.packing import pack_bits
    from qnx_torch.serve.engine import ServeEngine, normalize_u8

    b = TIME_BATCH
    rng = np.random.default_rng(13)
    u8 = torch.from_numpy(rng.integers(0, 256, (b, 32, 32, 3),
                                       dtype=np.uint8)).cuda()
    first = model.first
    with torch.inference_mode():
        x = normalize_u8(u8)
        y = first.conv(x)
        z = first._bn(y)
        stages = [("normalize_u8", lambda: normalize_u8(u8)),
                  ("first: cuDNN conv + bias", lambda: first.conv(x)),
                  ("first: BN", lambda: first._bn(y)),
                  ("first: sign + pack_bits", lambda: pack_bits(z, axis=-1))]
        bits = first(x)
        for i, conv in enumerate(model.convs, 1):
            stages.append((f"conv_{i} kernel", lambda l=conv, a=bits: l(a)))
            bits = conv(bits)
        bits = bits.reshape(b, -1)
        for j, dense in enumerate(model.denses):
            stages.append((f"dense_{j} kernel", lambda l=dense, a=bits: l(a)))
            bits = dense(bits)
        stages.append(("head: unpack + sgemm + BN", lambda a=bits: model.head(a)))
        parts = 0.0
        for name, fn in stages:
            ms = time_ms(torch, fn, 20)
            parts += statistics.median(ms)
            log("stages", f"{card} | {name} batch {b}: {fmt(ms)}")
        whole = time_ms(torch, lambda: model(x), 20)
        log("stages", f"{card} | whole forward batch {b}: {fmt(whole)}; sum "
            f"of the stage medians {parts:.4f} ms")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model(x)
        torch.cuda.synchronize()
    weights = sum(t.numel() * t.element_size() for t in model.buffers())
    log("stages", f"{card} | peak device memory allocated over one forward at "
        f"batch {b}: {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
        f"(model buffers {weights / 2**20:.1f} MiB)")

    images = rng.integers(0, 256, (ENGINE_BATCHES * SERVE_BATCH, 32, 32, 3),
                          dtype=np.uint8)
    engine = ServeEngine(model, batch_size=SERVE_BATCH, max_wait_ms=50.0)
    futs = [f for s in range(0, len(images), SERVE_BATCH)
            for f in engine.submit_many(images[s:s + SERVE_BATCH])]
    with engine:  # queued before start: every batch is full
        for f in futs:
            f.result(timeout=600)
    st = engine.stats()
    log("stages", f"{card} | engine, {st['batches']} batches of {SERVE_BATCH} "
        f"queued at once: {st['wall_throughput_ips']:.1f} img/s host clock "
        f"from first dispatch to last answer; {st['throughput_ips']:.1f} img/s "
        f"over the batches' busy time; latency p50 "
        f"{st['latency_ms_p50']:.1f} ms, p99 {st['latency_ms_p99']:.1f} ms "
        f"(queueing included)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: chip_smoke.py "
                           "needs one CUDA card")
    card = phase_device(torch)
    phase_build()
    err = {"xnor_conv3x3_fused": 0.0, "xnor_dense_fused": 0.0}
    phase_kernels(torch, err)
    model, launches = phase_slice(torch, err)
    total = phase_times(torch, card, model)
    phase_stages(torch, card, model)
    if any(m.split(".")[0] in ("jax", "jaxlib", "flax", "qnx") for m in sys.modules):
        raise AssertionError("the port imported jax or the JAX package")

    source = "qnx_torch/kernels/csrc/xnor_fused.cu"
    replaces = "qnx/kernels/xnor_conv_fused.py:54"
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], "max_abs_err": err[name],
         "ms": total[name][0], "plain_ms": total[name][1]}
        for name in ("xnor_conv3x3_fused", "xnor_dense_fused")]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
