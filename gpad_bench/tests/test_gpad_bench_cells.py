"""Each cell of BENCHMARK.json resolves to its files by name, and each file
is used by a cell."""

import json

import pytest

from gpad_bench import harness

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_by_name(name):
    cell = harness.load_cell(name)
    w = cell.workload
    assert cell.config["name"] == w["config"]
    assert (harness.BENCH / "drivers" / f"{cell.traffic['driver']}.py").is_file()
    assert (harness.BENCH / "reference" / f"{cell.config['plant']}.py").is_file()
    for m in cell.per_layer:
        reader = harness.load_module(harness.BENCH / "metrics" / f"{m['name']}.py")
        assert callable(reader.read)
    assert set(cell.limits) and all(v > 0 for v in cell.limits.values())


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file_is_under_paths_and_states_its_cut(entry):
    assert entry["file"].startswith("gpad_bench/configs/")
    cfg = json.loads((harness.ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] == []
    assert cfg["solver"]["precision"] == "highest"
    assert cfg["assumed"]


def test_every_file_is_some_cells():
    traffic = {w["traffic"] for w in SPEC["workloads"]}
    assert {p.stem for p in (harness.BENCH / "traffic").glob("*.json")} == traffic
    assert {p.stem for p in (harness.BENCH / "limits").glob("*.json")} == set(CELLS)
    readers = {p.name[:-3] for p in (harness.BENCH / "metrics").glob("*.py")}
    assert readers == {m["name"] for m in SPEC["per_layer"]}
    files = {c["file"] for c in SPEC["configs"]}
    assert {f"gpad_bench/configs/{p.name}"
            for p in (harness.BENCH / "configs").glob("*.json")} == files
