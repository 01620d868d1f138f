"""A run with the timed path or the hierarchy broken underneath comes out
not correct, and the controls (the program's float32 path; the
reference's bfloat16 product in place of the coarse operators) fail the
comparison.

These drive the whole of a run but the look for a card, on the CPU at
test size."""

import importlib
import time

import pytest
import torch

from amgbench import harness
from amgbench.reference.checks import galerkin
from pyamg_tpu_torch.multilevel import MultilevelSolver

from conftest import manifest_cells, tiny_cell

CELLS = manifest_cells()
# configurations and traffic mixes on file that no cell names yet
DRAFTS = ["hpcg27_104.rhs_stream", "poisson2d_4096.matrix_stream"]
SEED = 2 ** 31 + 4242


def run(cell, device="cpu", trace=False, **kw):
    return harness.run_cell(cell, SEED, 0.3, trace, time.perf_counter(),
                            device=device, **kw)


@pytest.mark.parametrize("name", CELLS + DRAFTS)
def test_sound_run_is_correct(name):
    cell = tiny_cell(name)
    res = run(cell)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    assert res["checks"]["relres_max"]["value"] <= 1e-10
    assert res["checks"]["galerkin_max"]["value"] < 1e-5
    assert res["checks"]["transpose_max"]["value"] < 1e-12
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}


def unchanged(self, b, **kw):
    """A solve whose state never leaves x0 = 0."""
    x = torch.zeros_like(torch.as_tensor(b, dtype=torch.float64))
    return x, {"rounds": 1, "inner_iterations": 1}


def altered(real):
    def solve_mp(self, b, **kw):
        x, info = real(self, b, **kw)
        x = x.clone()
        x[x.numel() // 2] += 1e-3 * float(x.abs().max())
        return x, info
    return solve_mp


def raising_after_warm_up(real):
    """A solve that answers the warm request and raises after it."""
    calls = {"n": 0}

    def solve_mp(self, b, **kw):
        calls["n"] += 1
        if calls["n"] > 1:
            raise RuntimeError("no answer")
        return real(self, b, **kw)
    return solve_mp


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "altered", "raising"])
def test_broken_solve_is_not_correct(name, fault, monkeypatch):
    real = MultilevelSolver.solve_mp
    broken = {"unchanged": unchanged, "altered": altered(real),
              "raising": raising_after_warm_up(real)}[fault]
    monkeypatch.setattr(MultilevelSolver, "solve_mp", broken)
    res = run(tiny_cell(name))
    assert not res["correct"]
    if fault == "raising":
        assert res["failed"] == res["attempted"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = tiny_cell(name)
    res = run(cell, solve_entry=cell.config["control"])
    assert not res["correct"]
    assert res["checks"]["relres_max"]["value"] > 3 * 1e-10


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_the_per_layer_metrics(name):
    cell = tiny_cell(name)
    res = run(cell, trace=True)
    assert res["correct"]
    # requests before the traced stretch, and the whole stretch
    assert res["attempted"] > cell.traffic["traced_requests"]
    assert "inner_iters" in res["metrics"] and "amg_setup_s" in res["metrics"]
    assert "breakdown" in res and "window_s" in res["device"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name, cuda_device):
    res = run(tiny_cell(name), device=cuda_device, trace=True)
    assert res["correct"]
    assert res["device"]["platform"] == "gpu"
    assert res["metrics"]["launches_per_solve"]["value"] > 0


def _values(op):
    """The tensor of a program matrix's stored values."""
    return op.diags if hasattr(op, "diags") else op.data


def altered_hierarchy(monkeypatch, config, part):
    """Wrap the configuration's constructor: its largest stored value of
    level 1's ``A`` (``part="A"``), or of the last factor of level 0's
    ``R``, grows by 1%."""
    c = config["constructor"]
    mod = importlib.import_module(c["module"])
    real = getattr(mod, c["function"])

    def build(*a, **kw):
        built = real(*a, **kw)
        attr = config.get("solver_attribute")
        levels = (getattr(built, attr) if attr else built).levels
        op = levels[1].A if part == "A" else levels[0].R
        op = getattr(op, "ops", (op,))[-1]
        t = _values(op).view(-1)
        t[t.abs().argmax()] *= 1.01
        return built
    monkeypatch.setattr(mod, c["function"], build)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("part,number", [("A", "galerkin_max"),
                                         ("R", "transpose_max")])
def test_altered_hierarchy_is_not_correct(name, part, number, monkeypatch):
    cell = tiny_cell(name)
    altered_hierarchy(monkeypatch, cell.config, part)
    res = run(cell)
    assert not res["correct"]
    check = res["checks"][number]
    assert check["value"] > 3 * check["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_bfloat16_control_fails_the_hierarchy_check(name):
    cell = tiny_cell(name)
    reqs = harness.Requests(cell.config, cell.traffic, SEED, "cpu")
    solver, _ = harness.build_solver(cell.config, reqs.op, "cpu")
    h = harness.read_hierarchy(solver)
    params = cell.config["checks"]["galerkin"]
    prog = galerkin.readings(h, SEED, params["probes"])
    ctrl = galerkin.readings(h, SEED, params["probes"], control=True)
    assert prog[0] <= params["limit"] and prog[1] <= params["transpose_limit"]
    assert ctrl[0] > 3 * params["limit"]
    assert ctrl[1] > 3 * params["transpose_limit"]
