"""Finds what a cell needs by the names ``BENCHMARK.json`` gives it, each in
a file of its own, so that a later change adds a configuration, a traffic
mix, a cell or a metric by adding files and entries alone:

* a configuration: the ``file`` its entry names (``configs/<name>.json``);
* a traffic mix: ``traffic/<traffic>.json``;
* a metric: the reader ``metrics/<name>.py``;
* a reference architecture: ``models/<reference>.py``.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


def load_benchmark(path: Path = BENCHMARK) -> dict:
    return json.loads(Path(path).read_text())


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def _module(path: Path):
    if not path.is_file():
        raise FileNotFoundError(f"no file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(
        f"qbench_{path.parent.name}_{path.stem.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _for_cell(entries: list[dict], cell: str) -> list[dict]:
    """The metrics a cell reports: those that list it, and those that list
    no cells."""
    return [m for m in entries if cell in m.get("workloads", [cell])]


def cell(name: str, bench: dict | None = None) -> dict:
    """Everything a run of cell ``name`` needs: its entry, its
    configuration, its traffic mix and its metrics."""
    bench = bench or load_benchmark()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(work)}")
    entry = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    return {
        "entry": entry,
        "config": _json(ROOT / conf["file"]),
        "traffic": _json(HERE / "traffic" / f"{entry['traffic']}.json"),
        "end_to_end": _for_cell(bench["end_to_end"], name),
        "per_layer": _for_cell(bench["per_layer"], name),
    }


def reader(metric: str):
    """The module whose ``read(ctx)`` gives ``metric``."""
    return _module(HERE / "metrics" / f"{metric}.py")


def architecture(reference: str):
    """The module of a reference architecture: ``make_variables``,
    ``reference_logits``, ``layer_work``."""
    return _module(HERE / "models" / f"{reference}.py")
