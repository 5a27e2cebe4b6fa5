"""Whole runs of the harness on the CPU at a small width (its look for a
card skipped), and with the timed path broken underneath: ``correct`` is
true for the program and false for each fault a serving cell can have."""
import json
import os
import subprocess
import sys

import pytest
import torch

from qbench import calibrate, registry
from qbench.run import Context, run_cell

SMALL = {"width": 16, "dense_units": 32}
MIX = {"batch": 32, "pool_images": 256, "check_share": 0.5}
SEED = 2**31 + 41


CELLS = [w["name"] for w in registry.load_benchmark()["workloads"]]


def _half_left_out(model, x):
    """Half of the batch left out: its rows answered with zeros."""
    half = model(x[: len(x) // 2])
    return torch.cat([half, torch.zeros_like(half)])


def _answer_altered(model, x):
    """An answer altered where it is produced: one logit of each row."""
    out = model(x).clone()
    out[:, 0] += 0.5 * out.abs().amax(dim=1)
    return out


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_sound_run_is_correct(name, trace):
    cell = registry.cell(name)
    out = run_cell(cell, SEED, 1.0, bool(trace), "cpu",
                   spec_overrides=SMALL, mix_overrides=MIX)
    assert out["correct"], out["checks"]
    assert out["checks"]["logit_mismatch_share"]["value"] == 0.0
    want = {m["name"] for m in (cell["per_layer"] if trace else cell["end_to_end"])}
    assert set(out["metrics"]) == want
    assert out["device"]["platform"] == "cpu"
    assert out["setup_parts"]["built"] is False
    assert set(out["setup_parts"]) >= {"imports", "variables", "packer", "library",
                                       "warm-up"}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_half_left_out, _answer_altered])
def test_a_broken_timed_path_is_not_correct(name, fault):
    out = run_cell(registry.cell(name), SEED, 1.0, False, "cpu", spec_overrides=SMALL,
                   mix_overrides=MIX, forward=fault)
    assert not out["correct"]
    assert out["checks"]["logit_mismatch_share"]["value"] > 0.2


@pytest.mark.parametrize("name", CELLS)
def test_the_control_in_the_programs_place_is_not_correct(name):
    """The control (the reference in TF32) judged on a sound run's checked
    images by the configuration's limits, as ``calibrate`` judges it."""
    cell = registry.cell(name)
    out = run_cell(cell, SEED, 1.0, False, "cpu", spec_overrides=SMALL,
                   mix_overrides=MIX)
    cell["config"] = {**cell["config"], **SMALL}
    ctl = calibrate.judge_control(cell, SEED, out["log"], "cpu")
    assert out["correct"] and ctl["correct"] is False
    assert ctl["checks"]["logit_mismatch_share"] > cell["config"]["limits"][
        "logit_mismatch_share"]


def _counters(clock, batches, images, batch_ms):
    return {"batches": batches, "images": images, "padded": 0,
            "total_batch_ms": batch_ms, "clock": clock}


def test_host_readings_leave_the_profiled_slice_out():
    ctx = Context(counters=[_counters(0.0, 0, 0, 0.0), _counters(10.0, 100, 1000, 6000.0)],
                  slice_counters=[_counters(3.0, 30, 300, 1800.0),
                                  _counters(5.0, 40, 400, 3000.0)],
                  least_image_s=1e-4)
    d = ctx.untraced()
    assert (d["clock"], d["batches"], d["images"]) == (8.0, 90, 900)
    assert d["total_batch_ms"] == pytest.approx(4800.0)
    assert registry.reader("engine_gap_ms").read(ctx) == pytest.approx(
        (8.0 - 4.8) / 90 * 1e3)
    assert registry.reader("step_mfu").read(ctx) == pytest.approx(100 * 900 * 1e-4 / 8.0)
    ctx.slice_counters = None  # an untraced run: the whole window
    assert ctx.untraced()["clock"] == 10.0
    # a slice that ran past the window's close: the window before it
    ctx.slice_counters = [_counters(3.0, 30, 300, 1800.0), _counters(11.0, 101, 0, 0.0)]
    assert ctx.untraced() == _counters(3.0, 30, 300, 1800.0)
    ctx.slice_counters = [_counters(12.0, 101, 0, 0.0), _counters(13.0, 102, 0, 0.0)]
    assert ctx.untraced() is None


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "-m", "qbench.run", "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr


@pytest.mark.card
def test_a_cell_on_the_card(card):
    """On the card: a short run of the first cell ends with the result line
    that ``qbench/run.py`` documents, ``checks`` last."""
    out = subprocess.run([sys.executable, "-m", "qbench.run", "--workload",
                          CELLS[0], "--seed", str(SEED), "--seconds",
                          "3", "--trace", "0"], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu"
    assert line["setup_parts"]["library"] >= 0
