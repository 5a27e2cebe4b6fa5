"""The readings a cell's limits are set from, in one process:

    python3 -m qbench.calibrate --workload cifar10-tnn-bitplane.backlog \
        --seeds 101,102,... --seconds 4 --control-seeds 3

For each seed, a run of the cell at its own load and batch for a short
window, its check sample widened so that it compares about as many images
as a full window of ``--full-seconds`` does: the program's reading.  For the
first ``--control-seeds`` seeds, the control's reading on the same images:
the reference computed in TF32 (operands rounded to TF32, float32 sums),
the precision one step below the configuration's float32, judged as the
program is, by ``checks.judge`` against the configuration's limits: its
``correct`` has to come out false.  One JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from qbench import checks, registry, traffic
from qbench.run import run_cell, sample_images


def control_reading(cell: dict, seed: int, log, device) -> dict:
    """The control's numbers on the images a run checked, in the run's
    place: ``unanswered`` as the run read it, ``checked_images`` and
    ``logit_mismatch_share`` of the control against the reference."""
    spec, mix = cell["config"], cell["traffic"]
    arch = registry.architecture(spec["reference"])
    variables = arch.make_variables(spec, seed, device)
    pool = traffic.make_pool(mix, arch.INPUT_SHAPES[spec["dataset"]], seed, device)
    images = sample_images(log, pool)
    ref = checks.reference_in_blocks(arch, spec, variables, images, device, "exact")
    ctl = checks.reference_in_blocks(arch, spec, variables, images, device, "tf32")
    bad = checks.mismatched(ctl, ref)
    return {"unanswered": int((~log.rows()["ok"]).sum()),
            "checked_images": len(images),
            "logit_mismatch_share": float(bad.mean()) if len(bad) else 1.0,
            "max_abs_logit_gap": float(np.abs(ctl - ref).max()) if len(bad) else None}


def judge_control(cell: dict, seed: int, log, device) -> dict:
    """The control's readings, each beside its limit, and its verdict."""
    readings = control_reading(cell, seed, log, device)
    correct, judged = checks.judge(readings, cell["config"]["limits"])
    return {"correct": correct, "checks": {k: v["value"] for k, v in judged.items()},
            "max_abs_logit_gap": readings["max_abs_logit_gap"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m qbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--full-seconds", type=float, default=15.0)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = registry.cell(args.workload)
    widen = args.full_seconds / args.seconds
    mix = {"check_share": min(1.0, cell["traffic"]["check_share"] * widen)}
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        out = run_cell(cell, seed, args.seconds, False, args.device, mix_overrides=mix)
        row = {"workload": args.workload, "seed": seed, "correct": out["correct"],
               "program": {k: v["value"] for k, v in out["checks"].items()},
               "metrics": {k: v["value"] for k, v in out["metrics"].items()}}
        if i < args.control_seeds:
            row["control"] = judge_control(cell, seed, out["log"], args.device)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
