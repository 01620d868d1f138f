"""The benchmark's manifest and the files it names.

``BENCHMARK.json`` at the root of the checkout lists the cells, each a
``<config>.<traffic>`` pair, and the metrics each cell reports.  Every
piece is found by its name: ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``metrics/<metric>.py`` beside this file;
the pieces a configuration or a mix names in turn (operator kinds,
fields, loops, checks) in their own folders (README.md).
"""

from __future__ import annotations

import importlib
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list      # the manifest's end-to-end metric entries
    per_layer: list       # the manifest's per-layer metric entries


def load_manifest(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def load_config(name: str) -> dict:
    with open(HERE / "configs" / f"{name}.json") as f:
        return json.load(f)


def load_traffic(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: every cell when the metric
    names no ``workloads``."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, manifest: dict | None = None) -> Cell:
    """The cell ``name`` of the manifest with its configuration, traffic
    mix and the metrics it reports."""
    manifest = manifest or load_manifest()
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[name]
    return Cell(name=name, config=load_config(w["config"]),
                traffic=load_traffic(w["traffic"]), chips=int(w["chips"]),
                end_to_end=[m for m in manifest["end_to_end"]
                            if reports(m, name)],
                per_layer=[m for m in manifest["per_layer"]
                           if reports(m, name)])


def metric_reader(name: str):
    """The module ``metrics/<name>.py``: ``read(record)`` gives the
    metric's value or None, and ``HOOKS`` the calls it records."""
    return importlib.import_module(f"amgbench.metrics.{name}")
