"""Every cell, configuration and metric that ``BENCHMARK.json`` names is
found by its name, and the file keeps to the benchmark's contract."""
import json
import re

import pytest

from portbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files_load_by_name(cell):
    wl = spec.workload(cell["name"])
    assert wl["name"] == cell["name"]
    assert wl["config"] == cell["config"] and wl["chips"] == cell["chips"]
    assert wl["traffic"] == cell["traffic"] and wl["why"] == cell["why"]
    cfg = spec.config(cell["config"])
    assert cfg["name"] == cell["config"]
    assert set(wl["kernels"]) >= set(cfg["counts"])
    assert wl["limits"], "a cell compares at least one number"
    assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_load_by_name(cfg):
    data = spec.config(cfg["name"])
    assert cfg["file"] == f"portbench/configs/{cfg['name']}.json"
    assert data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]
    assert (spec.HERE / "drivers" / f"{data['driver']}.py").exists()
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_readers_load_by_name(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert callable(spec.metric(m["name"]).read)


def test_bounds_and_layers():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_every_cell_reports_what_it_must(cell):
    e2e = [m["name"] for m in spec.metrics_of(cell["name"], False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics_of(cell["name"], True)


def test_names_unique_and_pairs_once():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_unknown_names_are_refused():
    with pytest.raises(ValueError):
        spec.workload("../BENCHMARK")
    with pytest.raises(OSError):
        spec.workload("no_such_cell")
