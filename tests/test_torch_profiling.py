"""The port's profiling tools on the CPU: ``trace`` writes a Chrome trace
holding the annotated span, ``StepTimer`` logs JSONL."""
import json
import os

import torch

from qnx_torch.utils.metrics import MetricsLogger
from qnx_torch.utils.profiling import TRACE_FILE, StepTimer, annotate, trace


def test_trace_writes_chrome_trace(tmp_path):
    d = str(tmp_path / "trace")
    with trace(d):
        with annotate("unit-test-span"):
            y = torch.ones((8, 8)) @ torch.ones((8, 8))
    assert float(y[0, 0]) == 8.0
    with open(os.path.join(d, TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "unit-test-span" for e in events)


def test_step_timer_jsonl(tmp_path):
    path = str(tmp_path / "m.jsonl")
    logger = MetricsLogger(path)
    timer = StepTimer(logger, name="train_step")
    for i in range(3):
        timer.start()
        y = torch.ones(4) * i
        timer.stop(sync={"y": y, "z": [y]}, batch=i)
    logger.close()
    rows = [json.loads(l) for l in open(path)]
    assert len(rows) == 3
    assert all(r["event"] == "train_step" and r["seconds"] >= 0 for r in rows)
    assert [r["batch"] for r in rows] == [0, 1, 2]
    s = timer.summary()
    assert s["steps"] == 3 and s["p99_s"] >= s["p50_s"]


def test_step_context_manager():
    timer = StepTimer()
    assert timer.summary() == {"steps": 0}
    with timer.step(tag="x"):
        torch.zeros(2)
    assert timer.summary()["steps"] == 1
