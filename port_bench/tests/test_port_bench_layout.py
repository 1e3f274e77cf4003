"""BENCHMARK.json against the contract, and every name in it resolving to a file."""

import json
import re
from pathlib import Path

import pytest

from port_bench import harness

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"] and BENCH["command"][1] == "port_bench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs)) and all(w["chips"] == 1 for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_files(cell):
    entry = harness.cell_entry(BENCH, cell)
    assert (PKG / "configs" / f"{entry['config']}.json").exists()
    mix = harness.mix(entry["traffic"])
    assert (PKG / "traffic" / f"{mix['driver']}.py").exists()
    assert harness.limits(cell)
    e2e, layer = harness.metrics_of(BENCH, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in layer:
        assert m["moves"] in names, f"{m['name']} moves {m['moves']}, which {cell} does not report"
        assert harness.reader(m["name"])


def test_every_per_layer_metric_names_its_cells_and_one_moved_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["workloads"]
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"] and "\t" not in m["layer"]


@pytest.mark.parametrize("name,published", [("hifigan_v1", "config_v1.json"),
                                            ("hifigan_v2", "config_v2.json")])
def test_config_file_holds_the_published_configuration(name, published):
    cfg = harness.config(name)
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    assert entry["file"] == f"port_bench/configs/{name}.json" and entry["reduced"] == []
    assert cfg["reduced"] == [] and cfg["source"] == entry["source"]
    for key, value in json.loads((ROOT / "configs" / published).read_text()).items():
        assert cfg[key] == value, key
