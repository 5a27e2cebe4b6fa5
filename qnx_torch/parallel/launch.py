"""Start a world of ranks, one process each, and run a task in every rank.

    python -m qnx_torch.parallel.launch --init file:///tmp/w/init --rank R \\
        --world N [--mp M] [--device cuda|cpu] [--backend gloo|nccl] \\
        --task NAME --payload IN.pt --out OUT_R.pt

is one rank; :func:`run_world` starts all of them as clean interpreters
(``subprocess``, never ``fork`` of a process that holds CUDA), joined by a
``file://`` rendezvous in a temporary directory, and returns each rank's
result.  The payload (models, requests, variables) is a ``torch.save`` of
CPU objects; each rank moves what it uses to its device.  Several ranks
may share one card (gloo); a rank's device is ``cuda:{rank % cards}``.

A rank's result carries its rank, world, mesh shape, backend, transport
and device; the ``sequence`` task adds the kernel launches each step made
(``qnx_torch.kernels.launch_counters()``), which a caller sums over
ranks.  Tasks
(:data:`TASKS`): ``bringup``, ``serve``, ``overlap``, ``tp_forward``,
``int8_forward`` and ``sequence`` (several of them in one world).
"""
from __future__ import annotations

import argparse
import contextlib
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]

#: seconds every collective may take before it fails (the process group's
#: timeout), and seconds a whole world may run
COLLECTIVE_TIMEOUT = 90.0
WORLD_TIMEOUT = 120.0


def rank_device(device: str, rank: int) -> torch.device:
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card for device='cuda'; pass device='cpu'")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _cuda_ms(device, fn, iters: int) -> tuple[float, float]:
    """(device ms by CUDA events, host ms by the clock) a call of ``fn``,
    over ``iters`` calls after one warm-up; on the CPU both are the host
    clock's."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters, (time.perf_counter() - t0) * 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    return ms, ms


# ---------------------------------------------------------------------------
# tasks: task(mesh, payload, device) -> dict, run in every rank
# ---------------------------------------------------------------------------

def task_bringup(mesh, payload, device):
    from qnx_torch.parallel.bringup import bringup_workloads

    return bringup_workloads(mesh, device=device, **payload)


def task_serve(mesh, payload, device):
    """Serve ``payload["requests"][label]`` through ``ServeEngine(mesh=...)``
    for each ``payload["models"][label]``; rank 0 keeps the logits and the
    stats, after a first engine has served one batch (the one-time loads).
    With ``payload["rate_batches"]``, a second engine then serves that many
    full batches of the requests (cycled), queued as one chunk so that no
    batch waits out ``max_wait_ms``: rank 0 keeps its logits and stats as
    ``rate``, whose wall img/s is the path's.  Then, with
    ``payload["time_iters"]``, every rank runs the engine's forward on one
    static batch that many times: ms a batch on rank 0, CUDA events and the
    host clock.  Launches are counted per label, serving only."""
    from qnx_torch.kernels import launch_counters
    from qnx_torch.serve.engine import ServeEngine

    counters = launch_counters()
    out = {}
    for label, model in payload["models"].items():
        model = model.to(device)
        reqs = payload["requests"][label]
        # a first engine serves one batch: the kernels' and libraries' load
        warm = ServeEngine(model, batch_size=payload["batch_size"], mesh=mesh)
        if warm.leader:
            with warm:
                warm.predict(reqs[:payload["batch_size"]])
        for w in counters.values():
            w.launches = 0
        eng = ServeEngine(model, batch_size=payload["batch_size"], mesh=mesh,
                          max_wait_ms=payload.get("max_wait_ms", 50.0),
                          max_queue=None)
        res = {}
        if eng.leader:  # queued before start: the batching is deterministic
            sizes = payload.get("chunks") or (len(reqs),)
            futs = [f for c in np.split(reqs, np.cumsum(sizes)[:-1])
                    for f in eng.submit_many(c)]
            with eng:
                res["logits"] = np.stack([f.result(timeout=300) for f in futs])
            res["stats"] = eng.stats()
        rate_batches = payload.get("rate_batches", 0)
        if rate_batches:
            rate = ServeEngine(model, batch_size=payload["batch_size"],
                               mesh=mesh, max_queue=None)
            if rate.leader:
                rows = np.arange(rate_batches * payload["batch_size"]) % len(reqs)
                futs = rate.submit_many(reqs[rows])
                with rate:
                    res["rate"] = {"logits": np.stack([f.result(timeout=300)
                                                       for f in futs]),
                                   "stats": rate.stats()}
        res["forward_path"] = eng.forward_path
        res["launches"] = {n: w.launches for n, w in counters.items() if w.launches}
        iters = payload.get("time_iters", 0)
        if iters:
            x = torch.from_numpy(reqs[:payload["batch_size"]])
            res["device_ms"], res["host_ms"] = _cuda_ms(
                device, lambda: eng.route.compute(x), iters)
        out[label] = res
    return out


def task_overlap(mesh, payload, device):
    """The ring GEMMs on this rank's blocks of each case's full x (M, K) and
    w (K, N) in ``payload["cases"]``: ``kind`` float or int8
    (``allgather_gemm_overlapped``) or popcount
    (``allgather_popcount_gemm`` on packed words, with ``k``); this rank's
    (M, N/m) outputs."""
    from qnx_torch.parallel.mesh import MODEL_AXIS, P
    from qnx_torch.parallel.overlap import (allgather_gemm_overlapped,
                                            allgather_popcount_gemm)
    from qnx_torch.parallel.sharding import local_slice

    outs = []
    for case in payload["cases"]:
        x, w = (local_slice(torch.as_tensor(case[a]), P(None, MODEL_AXIS),
                            mesh).to(device) for a in ("x", "w"))
        if case["kind"] == "popcount":
            out = allgather_popcount_gemm(x, w, case["k"], mesh)
        else:
            out = allgather_gemm_overlapped(x, w, mesh)
        outs.append(out.cpu())
    return {"outs": outs}


def task_tp_forward(mesh, payload, device):
    """``make_tp_forward``'s forward of ``payload["model"]`` on
    ``payload["x"]``: every rank's whole-batch logits."""
    from qnx_torch.parallel.tp_forward import make_tp_forward

    model = payload["model"].to(device)
    tp = make_tp_forward(model, mesh)
    if tp is None:
        raise ValueError("the model or the mesh does not take the ring")
    local, fwd = tp
    with torch.inference_mode():
        logits = fwd(local, torch.as_tensor(payload["x"]).to(device))
    return {"logits": logits.cpu()}


def task_int8_forward(mesh, payload, device):
    """The bring-up's TP int8 forward of ``pack_int8(variables, cf)`` on
    ``payload["x"]``: the logits, and with ``time_iters`` ms a forward."""
    from qnx_torch.convert.pack_model import pack_int8
    from qnx_torch.parallel.bringup import shard_int8, tp_int8_forward

    model = shard_int8(pack_int8(payload["variables"], payload["cf"],
                                 device=device), mesh)
    x = torch.as_tensor(payload["x"]).to(device)
    with torch.inference_mode():
        logits = tp_int8_forward(model, x, mesh)
        res = {"logits": logits.cpu()}
        if payload.get("time_iters"):
            res["device_ms"], res["host_ms"] = _cuda_ms(
                device, lambda: tp_int8_forward(model, x, mesh),
                payload["time_iters"])
    return res


def task_sequence(mesh, payload, device):
    """Several tasks in one world, in order (``payload["steps"]``: a list of
    (task name, payload)); each step's result with the launches it made."""
    from qnx_torch.kernels import launch_counters

    counters = launch_counters()
    steps = []
    for name, p in payload["steps"]:
        for w in counters.values():
            w.launches = 0
        res = TASKS[name](mesh, p, device)
        res["step_launches"] = {n: w.launches for n, w in counters.items()
                                if w.launches}
        steps.append(res)
    return {"steps": steps}


TASKS = {"bringup": task_bringup, "serve": task_serve, "overlap": task_overlap,
         "tp_forward": task_tp_forward, "int8_forward": task_int8_forward,
         "sequence": task_sequence}


# ---------------------------------------------------------------------------
# one rank, and the world
# ---------------------------------------------------------------------------

def run_rank(init: str, rank: int, world: int, mp: int | None, device: str,
             backend: str, task: str, payload) -> dict:
    """Join the world, build the mesh, run ``task`` and leave; returns the
    task's result with the rank's figures."""
    import torch.distributed as dist

    from qnx_torch.parallel.mesh import (initialize_distributed, make_mesh,
                                         transport)

    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    initialize_distributed(init, world, rank, backend, COLLECTIVE_TIMEOUT)
    try:
        mesh = make_mesh(world, mp, dev.type)
        result = TASKS[task](mesh, payload, dev)
        result.update(rank=rank, world=world, mesh=list(mesh.shape),
                      backend=backend, transport=transport(None, dev),
                      device=str(dev))
        dist.barrier()
        return result
    finally:
        dist.destroy_process_group()


def run_world(task: str, payload, world: int, mp: int | None = None,
              device: str = "cuda", backend: str = "gloo",
              timeout: float = WORLD_TIMEOUT, threads: int = 1) -> list[dict]:
    """Run ``task`` in ``world`` fresh rank processes; each rank's result,
    by rank.  A rank that fails, or a world that outlives ``timeout``
    seconds, kills every rank and raises with the ranks' stderr."""
    tmp = Path(tempfile.mkdtemp(prefix="qnx_world_"))
    with contextlib.ExitStack() as stack:
        stack.callback(shutil.rmtree, tmp, ignore_errors=True)
        torch.save(payload, tmp / "payload.pt")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])]),
            OMP_NUM_THREADS=str(threads))
        procs, logs = [], []
        for r in range(world):
            log = stack.enter_context(open(tmp / f"rank{r}.log", "w+"))
            logs.append(log)
            cmd = [sys.executable, "-m", "qnx_torch.parallel.launch",
                   "--init", f"file://{tmp / 'init'}", "--rank", str(r),
                   "--world", str(world), "--device", device, "--backend",
                   backend, "--task", task, "--payload", str(tmp / "payload.pt"),
                   "--out", str(tmp / f"out{r}.pt"), "--threads", str(threads)]
            if mp is not None:
                cmd += ["--mp", str(mp)]
            procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                                          stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        failed = None
        while any(p.poll() is None for p in procs):
            failed = next((r for r, p in enumerate(procs)
                           if p.poll() not in (None, 0)), None)
            if failed is not None or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        if failed is None:
            failed = next((r for r, p in enumerate(procs)
                           if p.poll() not in (None, 0)), None)
        running = [p for p in procs if p.poll() is None]
        for p in running:
            p.kill()
        for p in procs:
            p.wait()
        if failed is not None or running:
            what = (f"rank {failed} exited {procs[failed].returncode}"
                    if failed is not None else f"the world outlived {timeout} s")
            text = []
            for r, log in enumerate(logs):
                log.seek(0)
                text.append(f"--- rank {r} ---\n{log.read()[-4000:]}")
            raise RuntimeError(f"{task} on {world} ranks: {what}\n" + "\n".join(text))
        return [torch.load(tmp / f"out{r}.pt", weights_only=False)
                for r in range(world)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m qnx_torch.parallel.launch")
    p.add_argument("--init", required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--mp", type=int, default=None)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    p.add_argument("--task", choices=sorted(TASKS), required=True)
    p.add_argument("--payload", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--threads", type=int, default=1)
    args = p.parse_args(argv)
    torch.set_num_threads(args.threads)
    payload = torch.load(args.payload, weights_only=False)
    result = run_rank(args.init, args.rank, args.world, args.mp, args.device,
                      args.backend, args.task, payload)
    torch.save(result, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
