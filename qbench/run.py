"""One run of one benchmark cell of ``qnx_torch``, the PyTorch/CUDA port:

    python3 -m qbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The run builds the cell's model from the seed
(random variables, the configuration's packer), loads the program's kernel
library (building it in a checkout's first run), starts ``qnx_torch``'s
``ServeEngine`` at the mix's static batch, warms up that one shape, then
drives the mix through ``ServeEngine.submit_many`` for ``--seconds``.  With
``--trace 0`` it reports the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics (spans over a slice of the window, ``trace.py``).
Once the window has closed and the program is freed, a sample of the served
answers drawn from the seed is held against the plain reference.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and with ``--trace 1``
``breakdown``), ``setup_parts`` (the seconds of each step of set-up, and
whether this run built the kernel library), and last ``checks``, each number
compared with its limit;
the same checks are the last lines of standard error.  Without a CUDA card
(or with fewer than the cell asks for), or with JAX or the JAX package
loaded once the window has closed, the run exits non-zero and prints no
result.
"""
from __future__ import annotations

import os
import time


def _process_age_s() -> float:
    """Seconds since this process started, from /proc (Linux)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, AttributeError):
        return 0.0


_AGE_AT_IMPORT = _process_age_s()
_IMPORTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):  # run as a file: python3 qbench/run.py
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from qbench import checks, registry, traffic  # noqa: E402
from qbench.leasttime import least_s  # noqa: E402

TRACE_AT = 0.3          # the traced slice starts this share into the window
TRACE_SECONDS = 2.0     # and lasts this long, or
TRACE_SHARE_MAX = 0.4   # this share of the window where that is shorter


class Context:
    """What a metric's reader reads: the run's clocks and requests, the
    engine's counters and the traced slice's spans."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def untraced(self) -> dict | None:
        """The growth of the engine's counters over the window, less their
        growth over the profiled slice (from its start to the first batch
        after it stopped), so that host-clock readings of a traced run
        leave the profiler's cost out; where the slice ran to the window's
        close, over the window before it; over the whole window in an
        untraced run."""
        if not self.counters:
            return None
        (a, b), cut = self.counters, self.slice_counters
        if cut is None:
            return {k: b[k] - a[k] for k in a}
        if not a["clock"] < cut[0]["clock"] <= b["clock"]:
            return None
        if cut[1]["clock"] > b["clock"]:
            return {k: cut[0][k] - a[k] for k in a}
        return {k: b[k] - a[k] - (cut[1][k] - cut[0][k]) for k in a}


def program_config(spec: dict):
    """The program's config for the configuration's file: its preset with
    every field the file gives."""
    import dataclasses

    from qnx_torch.utils.config import CONFIGS, Config

    names = {f.name for f in dataclasses.fields(Config)}
    return CONFIGS[spec["preset"]].replace(**{k: v for k, v in spec.items() if k in names})


def engine_counters(engine) -> dict:
    """The engine's own counters (its ``ServeStats``), read at the window's
    ends."""
    s = engine._stats
    return {"batches": s.batches, "images": s.images, "padded": s.padded,
            "total_batch_ms": s.total_batch_ms, "clock": time.perf_counter()}


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             spec_overrides: dict | None = None,
             mix_overrides: dict | None = None, forward=None) -> dict:
    """Run a cell: set-up, the window, the readings, the check.  Returns a
    dict with ``setup_s``, ``setup_parts``, ``log``, ``metrics``,
    ``device``, ``breakdown``, ``checks``, ``correct`` and a few lines of
    ``notes``.
    ``spec_overrides``, ``mix_overrides`` and ``forward`` (a broken
    forward, in place of the model's) are for tests."""
    import torch

    from qnx_torch.convert import pack_model
    from qnx_torch.kernels import _build
    from qnx_torch.serve.engine import ServeEngine
    from qbench.trace import Tracer

    device = torch.device(device)
    spec = {**cell["config"], **(spec_overrides or {})}
    mix = {**cell["traffic"], **(mix_overrides or {})}
    arch = registry.architecture(spec["reference"])
    batch = mix["batch"]

    phases = [("imports", time.perf_counter())]
    variables = arch.make_variables(spec, seed, device)
    phases.append(("variables", time.perf_counter()))
    model = getattr(pack_model, spec["packer"])(variables, program_config(spec),
                                                device=device)
    phases.append(("packer", time.perf_counter()))
    pool = traffic.make_pool(mix, arch.INPUT_SHAPES[spec["dataset"]], seed, device)
    phases.append(("pool", time.perf_counter()))
    built = device.type == "cuda" and not _build.library_path().exists()
    if device.type == "cuda":
        _build.load()
    phases.append(("library", time.perf_counter()))
    tracer = (Tracer(model, device, lambda: engine_counters(engine))
              if trace else None)
    fwd = forward or (tracer.forward if tracer else None)
    engine = ServeEngine(model, batch_size=batch, max_wait_ms=mix["max_wait_ms"],
                         forward=fwd).start()
    try:
        if tracer:
            tracer.warm(engine, pool[:batch])
            tracer.arm(time.perf_counter() + TRACE_AT * seconds,
                       min(TRACE_SECONDS, TRACE_SHARE_MAX * seconds))
        else:
            engine.predict(pool[:batch])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        phases.append(("warm-up", time.perf_counter()))
        counters = [engine_counters(engine)]
        close = lambda: counters.append(engine_counters(engine))  # noqa: E731
        log, t0, end = traffic.run_closed(engine, mix, pool, seed, seconds, close)
        if tracer:
            tracer.finish()
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    finally:
        engine.stop()

    setup_s = _AGE_AT_IMPORT + (t0 - _IMPORTED)
    rows = arch.layer_work(spec)
    traced = tracer.reading() if tracer else {}
    req = log.rows()
    ctx = Context(setup_s=setup_s, seconds=seconds, t0=t0, requests=req,
                  answered=req["ok"] & (req["done"] <= end),
                  least_image_s=least_s(rows, batch) / batch,
                  least_s=lambda stage=None: least_s(rows, batch, stage),
                  stage_ms=traced.get("stage_ms", {}), device=traced,
                  counters=counters if len(counters) == 2 else None,
                  slice_counters=(tracer.edges if tracer and len(tracer.edges) == 2
                                  else None))
    metrics = {}
    for m in cell["per_layer"] if trace else cell["end_to_end"]:
        value = registry.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell["entry"]["chips"], "memory_peak_bytes": int(peak)}
    if tracer and ctx.device:
        dev.update(busy_s=ctx.device["busy_s"], window_s=ctx.device["window_s"])
    notes = _notes(ctx, phases)
    parts = {"imports": _AGE_AT_IMPORT + phases[0][1] - _IMPORTED,
             **{name: b - a for (_, a), (name, b) in zip(phases, phases[1:])},
             "built": built}

    # the program's state goes before the reference runs
    del engine, model, tracer
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = answer_readings(log, pool, arch, spec, variables, device)
    correct, judged = checks.judge(readings, spec["limits"])
    return {"setup_s": setup_s, "setup_parts": parts, "log": log,
            "metrics": metrics, "device": dev,
            "breakdown": ctx.device.get("breakdown"), "checks": judged,
            "correct": correct, "notes": notes}


def sample_images(log, pool) -> np.ndarray:
    """The images of the checked requests that were answered, in row order."""
    rids = sorted(log.answers)
    return np.concatenate([log.images(r, pool) for r in rids]) if rids else pool[:0]


def answer_readings(log, pool, arch, spec, variables, device) -> dict:
    """The numbers compared: requests never answered (or failed), and the
    share of the sampled requests' images whose logits are not the
    reference's."""
    rids = sorted(log.answers)
    served = (np.concatenate([np.stack([f.result() for f in log.answers[r]]) for r in rids])
              if rids else np.zeros((0, spec["classes"])))
    ref = checks.reference_in_blocks(arch, spec, variables, sample_images(log, pool),
                                     device, "exact")
    bad = checks.mismatched(served, ref)
    return {"unanswered": int((~log.rows()["ok"]).sum()),
            "checked_images": int(len(served)),
            "logit_mismatch_share": float(bad.mean()) if len(bad) else 1.0}


def _notes(ctx, phases) -> list[str]:
    req, ans = ctx.requests, ctx.answered
    steps = ", ".join(f"{name} {b - a:.3f}" for (_, a), (name, b) in zip(phases, phases[1:]))
    lines = [f"window {ctx.seconds} s: {len(req['size'])} requests, "
             f"{req['size'].sum()} images; setup {ctx.setup_s:.3f} s, of it "
             f"imports {_AGE_AT_IMPORT + phases[0][1] - _IMPORTED:.3f}, {steps}"]
    per_s = np.bincount((req["done"][ans] - ctx.t0).astype(int), weights=req["size"][ans],
                        minlength=int(ctx.seconds))
    lines.append("images answered in each second of the window: "
                 + " ".join(str(int(v)) for v in per_s[:int(ctx.seconds)]))
    d = ctx.device
    if d:
        lines.append(f"traced slice {d['window_s']:.4f} s, {d['forwards']} forwards; "
                     f"stage ms from {d['stage_source']}: {d['stage_ms']}; CUDA-event "
                     f"spans {d['span_ms']}; busy from {d['busy_source']} "
                     f"({d['device_events']} device, {d['host_events']} host events)")
    return lines


def _power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m qbench.run", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    cell = registry.cell(args.workload)
    chips = cell["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"qbench: {args.workload} needs {chips} CUDA device(s); this "
              f"process sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    found = checks.forbidden_modules(sys.modules)
    if found:
        print(f"qbench: the run loaded {', '.join(found)}; it must not", file=sys.stderr)
        return 3
    limit = _power_limit()
    if limit:
        out["device"]["power_limit"] = limit
    ok = out["log"].rows()["ok"]
    line = {"correct": out["correct"], "attempted": int(len(ok)),
            "failed": int((~ok).sum()), "metrics": out["metrics"],
            "device": out["device"]}
    if args.trace and out["breakdown"]:
        line["breakdown"] = out["breakdown"]
    line["setup_parts"] = out["setup_parts"]
    line["checks"] = out["checks"]
    for note in [f"{args.workload} seed {args.seed} trace {args.trace}: "
                 f"{', '.join(f'{k} {v['value']!r} {v['unit']}' for k, v in out['metrics'].items())}",
                 *out["notes"], f"setup parts {out['setup_parts']}",
                 f"device {out['device']}"]:
        print(note, file=sys.stderr)
    for name, c in out["checks"].items():
        bound = f"limit {c['limit']!r}" if "limit" in c else f"at least {c['least']!r}"
        print(f"check {name} {c['value']!r} {bound}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
