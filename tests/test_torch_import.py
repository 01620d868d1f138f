"""The port stands alone: importing it loads neither JAX nor pyamg_tpu, and
no file of it (or chip_smoke.py, which drives it on the card) imports
them.  Its public constructors put their tensors on the card unless the
caller asks for another device."""

import inspect
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "pyamg_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(r"^\s*(import\s+(jax|pyamg_tpu)\b(?!_torch)"
                       r"|from\s+(jax|pyamg_tpu)\b(?!_torch))", re.M)


def test_import_leaves_jax_and_pyamg_tpu_unloaded():
    code = ("import sys, pyamg_tpu_torch\n"
            "bad = [m for m in ('jax', 'jaxlib', 'pyamg_tpu') "
            "if m in sys.modules]\n"
            "print(pyamg_tpu_torch.__version__, bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_port_file_imports_jax_or_pyamg_tpu(path):
    assert not FORBIDDEN.search(path.read_text()), path


def test_public_surface():
    import pyamg_tpu_torch

    assert sorted(pyamg_tpu_torch.__all__) == sorted(
        ["gallery", "parallel", "smoothed_aggregation_solver",
         "MultilevelSolver", "coarse_grid_solver", "SparseDIA", "SparseELL",
         "__version__"])
    from pyamg_tpu_torch import aggregation, relaxation, sparse, strength

    for module, names in (
            (aggregation, ["parallel_aggregation", "standard_aggregation",
                           "jacobi_prolongation_smoother",
                           "richardson_prolongation_smoother"]),
            (relaxation, ["relaxation", "rho_block_D_inv_A",
                          "change_smoothers"]),
            (relaxation.relaxation, ["gauss_seidel", "sor", "jacobi",
                                     "polynomial", "block_jacobi",
                                     "block_gauss_seidel",
                                     "gauss_seidel_indexed", "make_system"]),
            (sparse, ["CptProlongOp", "CptRestrictOp",
                      "embedded_dia_transfers", "root_embedded_transfers"]),
            (strength, ["classical_strength_of_connection",
                        "symmetric_strength_of_connection"])):
        assert set(names) <= set(module.__all__), module.__name__


def _entry_points():
    import pyamg_tpu_torch
    from pyamg_tpu_torch.parallel import general_sa_setup_sharded
    from pyamg_tpu_torch.sparse import (device_operator,
                                        embedded_dia_transfers,
                                        root_embedded_transfers)
    from pyamg_tpu_torch.sparse.spgemm_device import pattern_spgemm

    return {"MultilevelSolver": pyamg_tpu_torch.MultilevelSolver,
            "SparseDIA.from_scipy": pyamg_tpu_torch.SparseDIA.from_scipy,
            "SparseELL.from_scipy": pyamg_tpu_torch.SparseELL.from_scipy,
            "device_operator": device_operator,
            "pattern_spgemm": pattern_spgemm,
            "embedded_dia_transfers": embedded_dia_transfers,
            "root_embedded_transfers": root_embedded_transfers,
            "smoothed_aggregation_solver":
                pyamg_tpu_torch.smoothed_aggregation_solver,
            "general_sa_setup_sharded": general_sa_setup_sharded}


@pytest.mark.parametrize("name", ["MultilevelSolver", "SparseDIA.from_scipy",
                                  "SparseELL.from_scipy", "device_operator",
                                  "pattern_spgemm",
                                  "embedded_dia_transfers",
                                  "root_embedded_transfers",
                                  "smoothed_aggregation_solver",
                                  "general_sa_setup_sharded"])
def test_entry_points_default_to_the_card(name):
    param = inspect.signature(_entry_points()[name]).parameters["device"]
    assert param.default == "cuda"


def test_smoother_data_takes_its_device_from_the_caller():
    from pyamg_tpu_torch.relaxation import make_smoother_data

    param = inspect.signature(make_smoother_data).parameters["device"]
    assert param.default is inspect.Parameter.empty
