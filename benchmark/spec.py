"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. The configuration's sizes are the JSON file its ``configs`` entry
names; the mix is ``traffic/<traffic>.json``, whose ``entry`` names the
loop module ``loops/<entry>.py``; a per-layer metric is read by
``metrics/<name>.py``. Adding a configuration, a mix or a metric is adding
those files and their entries: nothing here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    root: Path


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: listed in its ``workloads``, or
    every cell where the metric has no such key."""
    return cell in metric.get("workloads", [cell])


def cell(name: str, root: Path = ROOT) -> Cell:
    spec = load(root)
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; known: {', '.join(sorted(work))}")
    w = work[name]
    conf_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / conf_entry["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    per_layer = [m for m in spec["per_layer"] if _reports(m, name)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer, root)


def loop(traffic: dict):
    """The module that drives this mix's entry (``loops/<entry>.py``)."""
    return importlib.import_module(f"benchmark.loops.{traffic['entry']}")


def reader(metric: str, root: Path = ROOT):
    """``read(trace)`` of ``metrics/<metric>.py``."""
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read
