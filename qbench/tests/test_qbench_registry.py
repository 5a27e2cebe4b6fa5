"""Lookup by name: every cell of BENCHMARK.json finds its configuration,
its traffic mix, its metrics' readers and its reference; and every
configuration file holds its preset as it is run."""
import dataclasses

import pytest

from qbench import registry

BENCH = registry.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    c = registry.cell(name)
    assert c["entry"]["name"] == name
    assert c["config"]["name"] == c["entry"]["config"]
    assert c["traffic"]["clients"] > 0
    assert c["entry"]["chips"] == 1
    assert any(m["name"] == "setup_s" for m in c["end_to_end"])
    assert len(c["end_to_end"]) >= 2 and c["per_layer"]
    for m in c["end_to_end"] + c["per_layer"]:
        assert callable(registry.reader(m["name"]).read)
    arch = registry.architecture(c["config"]["reference"])
    assert callable(arch.reference_logits) and callable(arch.make_variables)


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError, match="no workload"):
        registry.cell("no-such.cell")


FILES = sorted((registry.HERE / "configs").glob("*.json"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.stem)
def test_config_file_is_its_preset(path):
    """The file holds the configuration as it is run: each field the
    program's config has equals the preset's, but for those the file names
    under ``departs_from_preset`` with the reason; ``reduced`` is empty, as
    in the file's entry of BENCHMARK.json where it has one."""
    from qnx_torch.utils.config import CONFIGS

    spec = registry._json(path)
    assert spec["name"] == path.stem
    preset = dataclasses.asdict(CONFIGS[spec["preset"]])
    departs = spec.get("departs_from_preset", {})
    assert all(isinstance(why, str) and why for why in departs.values())
    assert {k for k in spec if k in preset and spec[k] != preset[k]} == set(departs)
    assert spec["reduced"] == [] and len(spec["source"]) <= 200
    for conf in BENCH["configs"]:
        if conf["name"] == spec["name"]:
            assert registry.ROOT / conf["file"] == path
            assert conf["reduced"] == [] and len(conf["source"]) <= 200
