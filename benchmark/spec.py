"""Where the harness finds its parts, by name.

``BENCHMARK.json`` (the root of the checkout) names the cells, the
configurations, the traffic mixes and the metrics. Each lives in a file
of its own under ``benchmark/``:

  * ``configs/<config>.json``: a deployment's sizes and physics;
  * ``traffic/<mix>.json``: the parameters the generator
    (``traffic.py``) reads;
  * ``workloads/<cell>.json``: the cell's check (steps, limits);
  * ``metrics/<metric>.py``: a reader with ``read(run)``, returning the
    metric's value or None when it finds nothing to read.

Adding any of them is adding files and entries: nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC_FILE = ROOT / "BENCHMARK.json"


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(path: Path = SPEC_FILE) -> dict:
    return _load(path)


def workload(spec: dict, name: str) -> dict:
    """The ``workloads`` entry of ``name``; ValueError when there is none."""
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise ValueError(f"no workload {name!r} in BENCHMARK.json "
                     f"(known: {[w['name'] for w in spec['workloads']]})")


def config(name: str) -> dict:
    return _load(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _load(HERE / "traffic" / f"{name}.json")


def cell(name: str) -> dict:
    return _load(HERE / "workloads" / f"{name}.json")


def metrics_for(spec: dict, cell_name: str, trace: bool) -> list:
    """The metric entries a run of ``cell_name`` reports: the per-layer
    ones in a traced run, the end-to-end ones otherwise; an entry with a
    ``workloads`` key only in the cells it lists."""
    entries = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in entries
            if "workloads" not in m or cell_name in m["workloads"]]


def metric_reader(name: str) -> ModuleType:
    """``metrics/<name>.py`` loaded as a module (names hold dots, so it
    is loaded by path)."""
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module
