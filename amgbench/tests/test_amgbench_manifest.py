"""BENCHMARK.json against the rules of the benchmark's contract."""

import importlib
import json
import re
from pathlib import Path

import pytest

from amgbench import spec

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
M = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= M["run_seconds"] <= 51
    assert len(M["command"]) <= 32
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_paths_hold_the_command():
    for p in M["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    for word in M["command"][1:]:
        assert not word.startswith("/") and ".." not in word.split("/")
        if "/" in word:
            assert any(word.startswith(p + "/") for p in M["paths"])
            assert (ROOT / word).is_file()


@pytest.mark.parametrize("entry", M["configs"] + M["workloads"]
                         + M["end_to_end"] + M["per_layer"],
                         ids=lambda e: e["name"])
def test_names_and_lines(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            v = entry[key]
            assert 1 <= len(v) <= 200 and "\n" not in v and "\t" not in v
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")


def test_unique_names():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in M[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize("cfg", M["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"] == f"amgbench/configs/{cfg['name']}.json"
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"] and len(cfg["reduced"]) <= 16
    assert cfg["source"].startswith("https://")
    assert any(w["config"] == cfg["name"] for w in M["workloads"])
    # the tests' size of the configuration, and a module for each piece
    assert isinstance(data["test"], dict)
    for mod in (f"amgbench.operators.{data['operator']['kind']}",
                f"amgbench.reference.{data['operator']['kind']}",
                *(f"amgbench.reference.checks.{c}" for c in data["checks"])):
        importlib.import_module(mod)


@pytest.mark.parametrize("w", M["workloads"], ids=lambda w: w["name"])
def test_cells(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["name"] == f"{w['config']}.{w['traffic']}"
    assert w["chips"] in (1, 4)
    assert (ROOT / "amgbench" / "traffic" / f"{w['traffic']}.json").is_file()
    cell = spec.load_cell(w["name"], M)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer


def test_pairs_once_and_four_chip_share():
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)


def test_end_to_end_bounds():
    names = {m["name"] for m in M["end_to_end"]}
    assert "setup_s" in names
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert callable(spec.metric_reader(m["name"]).read)


@pytest.mark.parametrize("m", M["per_layer"], ids=lambda m: m["name"])
def test_per_layer(m):
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}
    assert m["source"] in ("device_trace", "program_span",
                           "program_counter", "host_clock")
    cells = {w["name"] for w in M["workloads"]}
    moved = next(e for e in M["end_to_end"] if e["name"] == m["moves"])
    for c in m.get("workloads", cells):
        assert c in cells
        assert spec.reports(moved, c)
    reader = spec.metric_reader(m["name"])
    assert callable(reader.read)
    if "roofline" in m["name"]:
        assert m["name"].endswith("_roofline") and m["unit"] == "%"
        assert m["better"] == "higher"


def test_layers_named_alike():
    """Metrics of one layer name it letter for letter."""
    layers = {m["layer"] for m in M["per_layer"]}
    assert all(layer == layer.strip() for layer in layers)


def test_run_seconds_fit_the_full_check():
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (M["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200
