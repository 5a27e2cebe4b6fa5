"""The port's profiling tools on the CPU: ``trace`` writes a Chrome trace
holding the annotated span."""
import json
import os

import torch

from qnx_torch.utils.profiling import TRACE_FILE, annotate, trace


def test_trace_writes_chrome_trace(tmp_path):
    d = str(tmp_path / "trace")
    with trace(d):
        with annotate("unit-test-span"):
            y = torch.ones((8, 8)) @ torch.ones((8, 8))
    assert float(y[0, 0]) == 8.0
    with open(os.path.join(d, TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "unit-test-span" for e in events)
