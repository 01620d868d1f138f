"""Fixtures of the benchmark's tests: the cells cut to a size the CPU
holds, and the card where a test needs one."""

import copy
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def merged(base: dict, over: dict) -> dict:
    """``base`` with the entries of ``over`` put in, dictionaries merged
    key by key."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merged(base.get(k, {}), v) if isinstance(v, dict) else v
    return out


def manifest_cells():
    from amgbench import spec

    return [w["name"] for w in spec.load_manifest()["workloads"]]


def tiny_cell(name):
    """The cell ``name`` (``<config>.<traffic>``) at the test size its
    configuration gives under ``test`` (entries that replace its own): a
    cell of BENCHMARK.json, or a configuration and traffic mix on file
    that no cell names yet."""
    from amgbench import spec

    if name in manifest_cells():
        cell = spec.load_cell(name)
    else:
        config, traffic = name.split(".")
        cell = spec.Cell(name, spec.load_config(config),
                         spec.load_traffic(traffic), 1, [], [])
    cell.config = merged(copy.deepcopy(cell.config), cell.config["test"])
    return cell


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
