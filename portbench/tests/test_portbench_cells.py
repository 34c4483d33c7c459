"""BENCHMARK.json against the contract's shape and the files it names."""

import json
import re

import pytest

from portbench import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("workload", WORKLOADS)
def test_workload_resolves(workload):
    cell = cells.load_cell(workload)
    assert cell.chips == 1
    assert cells.driver(cell).Driver
    assert "update_gap" in cell.limits and set(cell.limits) <= {"loss_gap", "update_gap",
                                                                "reference_block"}
    assert cell.config["port_family"] and cell.config["reduced"] == []
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer


def _entries():
    for m in BENCH["end_to_end"]:
        yield "end_to_end", m
    for m in BENCH["per_layer"]:
        yield "metrics", m


@pytest.mark.parametrize("kind,entry", list(_entries()), ids=[e["name"] for _, e in _entries()])
def test_metric_file_declares_its_entry(kind, entry):
    mod = cells.reader(kind, entry["name"])
    assert NAME.match(entry["name"]) and UNIT.match(entry["unit"])
    assert mod.UNIT == entry["unit"] and mod.BETTER == entry["better"]
    if kind == "metrics":
        assert mod.LAYER == entry["layer"] and mod.MOVES == entry["moves"]
        assert entry["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert entry["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(entry.get("workloads", WORKLOADS)) <= set(WORKLOADS)
    else:
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25


def test_names_and_one_line_fields():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]
    for e in BENCH["per_layer"]:
        assert 1 <= len(e["layer"]) <= 200
    layers = {}
    for e in BENCH["per_layer"]:
        layers.setdefault(e["name"].split(".")[0], set()).add(e["layer"])


def test_every_config_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files) and all(f.startswith("portbench/") for f in files)
