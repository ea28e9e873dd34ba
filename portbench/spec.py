"""Finds a cell's files by the names in ``BENCHMARK.json``: the workload
file, the configuration file, the configuration's driver and each metric's
reader. Adding a cell, a configuration or a metric adds files here and
edits none."""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str) -> str:
    if not _NAME.match(name) or ".." in name:
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    return _json(HERE / "workloads" / f"{_checked(name)}.json")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{_checked(name)}.json")


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{_checked(name)}")


def metric(name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``, whose
    ``read(record)`` gives the number or None."""
    path = HERE / "metrics" / f"{_checked(name)}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def metrics_of(cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones without
    the trace, the per-layer ones with it, each where its ``workloads``
    (if given) names the cell."""
    bench = benchmark()
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]
