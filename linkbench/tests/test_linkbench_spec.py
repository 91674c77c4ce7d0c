"""BENCHMARK.json against the contract's shapes, and every file the
harness finds by name."""

import json
import re
from pathlib import Path

import pytest

from linkbench import harness

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert NAME.fullmatch(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.fullmatch(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.fullmatch(e[key])
        for key in e.get("reduced", []):
            assert NAME.fullmatch(key)
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_metric_entries():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m.get("workloads", [])) <= set(CELLS)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = harness.load_cell(cell)
    assert c.workload["name"] == cell
    assert c.workload["config"] == c.entry["config"]
    assert c.workload["traffic"] == c.entry["traffic"]
    assert c.entry["chips"] in (1, 4)
    harness.generator(c)  # the configuration's generator module
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer + c.end_to_end:
        assert callable(harness.metric_reader(m["name"]))
    assert {"setup_s", "train_pairs_per_s"} <= {m["name"] for m in c.end_to_end}
    for name in c.workload["limits"]:
        assert name in ("pairs_gap", "pattern_gap", "gamma_gap", "em_gap")


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    path = REPO / entry["file"]
    assert str(path.relative_to(REPO)).startswith("linkbench/")
    config = json.loads(path.read_text())
    assert config["name"] == entry["name"]
    assert config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"]
    assert (REPO / "linkbench" / "generators" / f"{config['generator']}.py").exists()
