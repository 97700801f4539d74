"""Every file of the benchmark loads by its name, and ``BENCHMARK.json``
keeps to the contract's shape: names, units, bounds, cells and the budget
of a full check."""

from __future__ import annotations

import json

import pytest

from portbench import check, spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
DIRS = ("configs", "traffic", "workloads")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("kind", DIRS)
def test_every_data_file_loads_by_name(kind):
    files = sorted((spec.HERE / kind).glob("*.json"))
    assert files
    for f in files:
        assert spec.NAME.fullmatch(f.stem), f
        assert isinstance(spec.load_json(kind, f.stem), dict)


def test_every_metric_file_loads_and_agrees_with_benchmark():
    names = {p.stem for p in (spec.HERE / "metrics").glob("*.py") if p.stem != "__init__"}
    assert names == {m["name"] for m in BENCH["per_layer"]}
    for m in BENCH["per_layer"]:
        mod = spec.load_module("metrics", m["name"])
        assert (mod.UNIT, mod.LAYER, mod.SOURCE, mod.MOVES) == (
            m["unit"], m["layer"], m["source"], m["moves"]), m["name"]
        assert callable(mod.read)


@pytest.mark.parametrize("metric", METRICS, ids=[m["name"] for m in METRICS])
def test_names_units_and_sources(metric):
    assert spec.NAME.fullmatch(metric["name"])
    assert spec.UNIT.fullmatch(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    allowed = {"name", "unit", "better", "source", "workloads"}
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        allowed.add("bound")
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert 1 <= len(metric["layer"]) <= 200 and "\t" not in metric["layer"]
        allowed |= {"layer", "moves"}
    assert set(metric) <= allowed
    if metric in BENCH["end_to_end"]:
        assert "workloads" not in metric  # every cell reports every end-to-end metric
    else:
        assert metric["workloads"] and set(metric["workloads"]) <= set(CELLS)


def test_setup_bound_and_run_seconds_budget():
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cells_load_and_report_enough(cell):
    c = spec.load_cell(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert entry["chips"] == 1 and len(entry["why"]) <= 200
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    assert int(c.settings["trace_steps"]) >= 1
    assert set(c.settings["check"]) <= set(check.NUMBERS)
    assert all(0 < v < float("inf") for v in c.settings["check"].values())


def test_configs_are_used_and_their_files_match():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        data = spec.load_json("configs", c["name"])
        assert data["source"] == c["source"] and data["reduced"] == c["reduced"]
        for kind in ("models", "reference"):
            assert (spec.HERE / kind / f"{c['name']}.py").exists()
