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
        ["aggregation", "amg_core", "classical", "complexity", "gallery",
         "graph", "krylov", "parallel", "relaxation", "sparse", "strength",
         "util", "vis", "classical_strength_of_connection",
         "symmetric_strength_of_connection",
         "evolution_strength_of_connection",
         "smoothed_aggregation_solver", "rootnode_solver",
         "adaptive_sa_solver", "solve", "solver", "solver_configuration",
         "setup_complexity", "cycle_complexity", "ruge_stuben_solver",
         "MultilevelSolver", "MultilevelSolverSet", "multilevel_solver",
         "multilevel_solver_set", "coarse_grid_solver", "SparseDIA",
         "SparseELL", "SparseBDIA", "BlockELL", "__version__"])
    from pyamg_tpu_torch import (aggregation, amg_core, blackbox, classical,
                                 complexity, gallery, graph, krylov,
                                 parallel, relaxation, sparse, strength, util,
                                 vis)
    from pyamg_tpu_torch.aggregation import (adaptive, new_adaptive,
                                             rootnode_nii, tentative)
    from pyamg_tpu_torch.util import linalg, profiling, utils
    from pyamg_tpu_torch.classical import split
    from pyamg_tpu_torch.relaxation import device

    for module, names in (
            (aggregation, ["asa_solver", "tl_sa_solver", "newideal_solver",
                           "ben_ideal_interpolation"]),
            (new_adaptive, ["asa_solver", "tl_sa_solver",
                            "global_ritz_process", "local_ritz_process",
                            "A_norm", "my_rand"]),
            (rootnode_nii, ["newideal_solver", "ben_ideal_interpolation"]),
            (tentative, ["fit_candidates", "ben_ideal_interpolation"]),
            (graph, ["breadth_first_search", "connected_components",
                     "pseudo_peripheral_node", "symmetric_rcm"]),
            (sparse, ["count_diagonals", "spgemm", "rap", "transpose"]),
            (util, ["profiling", "profile_cycles", "hierarchy_spectrum",
                    "diag_sparse", "profile_solver"]),
            (profiling, ["trace", "profile_cycles", "solve_timings",
                         "hierarchy_spectrum"]),
            (vis, ["write_vtu", "write_basic_mesh", "vis_aggregate_groups",
                   "vis_splitting"]),
            (aggregation, ["rootnode_solver", "adaptive_sa_solver",
                           "parallel_aggregation", "standard_aggregation",
                           "jacobi_prolongation_smoother",
                           "richardson_prolongation_smoother",
                           "energy_prolongation_smoother",
                           "fit_candidates"]),
            (relaxation, ["relaxation", "rho_block_D_inv_A",
                          "change_smoothers"]),
            (relaxation.relaxation, ["gauss_seidel", "sor", "jacobi",
                                     "polynomial", "block_jacobi",
                                     "block_gauss_seidel",
                                     "gauss_seidel_indexed", "make_system"]),
            (sparse, ["CptProlongOp", "CptRestrictOp",
                      "embedded_dia_transfers", "root_embedded_transfers",
                      "SparseBDIA", "BlockELL"]),
            (strength, ["classical_strength_of_connection",
                        "symmetric_strength_of_connection",
                        "evolution_strength_of_connection",
                        "energy_based_strength_of_connection",
                        "distance_strength_of_connection",
                        "affinity_distance", "algebraic_distance",
                        "relaxation_vectors", "apply_distance_filter",
                        "apply_absolute_distance_filter",
                        "ode_strength_of_connection"]),
            (classical, ["ruge_stuben_solver", "direct_interpolation",
                         "standard_interpolation", "CR", "binormalize",
                         "split", "cr"]),
            (split, ["RS", "PMIS", "PMISc", "CLJP", "CLJPc", "MIS",
                     "grid_splitting", "preprocess_strength"]),
            (parallel, ["classical_setup_sharded",
                        "general_sa_setup_sharded"]),
            (device, ["batched_tridiag_pcr", "line_relaxation_step"]),
            (relaxation.relaxation, ["zebra", "line_gauss_seidel",
                                     "line_jacobi"]),
            (amg_core, ["have_native", "standard_aggregation_native",
                        "naive_aggregation_native",
                        "first_fit_coloring_native",
                        "gauss_seidel_sweeps_native",
                        "gauss_seidel_indexed_native",
                        "identity_minus_rowscaled_native",
                        "weak_axis_filter_native",
                        "classical_strength_native", "csr_to_dia_native",
                        "bsr_gauss_seidel_native", "masked_spgemm_native",
                        "constraint_project_native", "pattern_gram_native",
                        "masked_spgemm_bsr_native",
                        "constraint_project_bsr_native",
                        "pattern_gram_bsr_native", "rs_cf_splitting",
                        "identity_minus_scaled_native",
                        "identity_minus_colscaled_native",
                        "pattern_values_native", "evolution_nulldim1_native",
                        "distance_filter_native",
                        "evolution_epilogue_native",
                        "direct_interpolation_native",
                        "standard_interpolation_native",
                        "thomas_lines_native"]),
            (krylov, KRYLOV),
            (gallery, ["gauge_laplacian", "diffusion_stencil_2d",
                       "linear_elasticity", "regular_triangle_mesh",
                       "sprand", "load_example", "demo"]),
            (blackbox, ["solve", "solver", "solver_configuration",
                        "make_csr"]),
            (complexity, ["setup_complexity", "cycle_complexity"]),
            (adaptive, ["adaptive_sa_solver", "eliminate_local_candidates",
                        "initial_setup_stage"]),
            (linalg, ["norm", "infinity_norm", "residual_norm", "condest",
                      "cond", "ishermitian"]),
            (utils, ["scale_T", "get_Cpt_params", "filter_operator",
                     "truncate_rows", "filter_matrix_columns",
                     "symmetric_rescaling", "diag_sparse", "profile_solver",
                     "to_type", "type_prep", "symmetric_rescaling_sa",
                     "print_table", "Coord2RBM", "UnAmal",
                     "hierarchy_spectrum"])):
        assert set(names) <= set(module.__all__), module.__name__


KRYLOV = ["cg", "cr", "cgne", "cgnr", "bicgstab", "steepest_descent",
          "minimal_residual", "gmres", "gmres_mgs", "gmres_householder",
          "fgmres"]


def _entry_points():
    import pyamg_tpu_torch
    from pyamg_tpu_torch import krylov
    from pyamg_tpu_torch.krylov import _common
    from pyamg_tpu_torch.parallel import (classical_setup_sharded,
                                          general_sa_setup_sharded)
    from pyamg_tpu_torch.sparse import (device_operator,
                                        embedded_dia_transfers,
                                        root_embedded_transfers)
    from pyamg_tpu_torch.sparse.spgemm_device import pattern_spgemm

    return {**{f"krylov.{name}": getattr(krylov, name) for name in KRYLOV},
            "krylov.prepare": _common.prepare,
            "krylov.make_matvec": _common.make_matvec,
            "gallery.demo": pyamg_tpu_torch.gallery.demo,
            "MultilevelSolver": pyamg_tpu_torch.MultilevelSolver,
            "SparseDIA.from_scipy": pyamg_tpu_torch.SparseDIA.from_scipy,
            "SparseELL.from_scipy": pyamg_tpu_torch.SparseELL.from_scipy,
            "device_operator": device_operator,
            "pattern_spgemm": pattern_spgemm,
            "embedded_dia_transfers": embedded_dia_transfers,
            "root_embedded_transfers": root_embedded_transfers,
            "smoothed_aggregation_solver":
                pyamg_tpu_torch.smoothed_aggregation_solver,
            "general_sa_setup_sharded": general_sa_setup_sharded,
            "ruge_stuben_solver": pyamg_tpu_torch.ruge_stuben_solver,
            "classical_setup_sharded": classical_setup_sharded,
            "rootnode_solver": pyamg_tpu_torch.rootnode_solver,
            "adaptive_sa_solver": pyamg_tpu_torch.adaptive_sa_solver,
            "solve": pyamg_tpu_torch.solve,
            "solver": pyamg_tpu_torch.solver,
            "newideal_solver": pyamg_tpu_torch.aggregation.newideal_solver,
            "asa_solver": pyamg_tpu_torch.aggregation.asa_solver,
            "tl_sa_solver": pyamg_tpu_torch.aggregation.tl_sa_solver,
            "sparse.spgemm": pyamg_tpu_torch.sparse.spgemm,
            "sparse.rap": pyamg_tpu_torch.sparse.rap,
            "sparse.transpose": pyamg_tpu_torch.sparse.transpose}


@pytest.mark.parametrize("name", ["MultilevelSolver", "SparseDIA.from_scipy",
                                  "SparseELL.from_scipy", "device_operator",
                                  "pattern_spgemm",
                                  "embedded_dia_transfers",
                                  "root_embedded_transfers",
                                  "smoothed_aggregation_solver",
                                  "general_sa_setup_sharded",
                                  "ruge_stuben_solver",
                                  "classical_setup_sharded",
                                  "rootnode_solver", "adaptive_sa_solver",
                                  "solve", "solver", "newideal_solver",
                                  "asa_solver", "tl_sa_solver",
                                  "sparse.spgemm", "sparse.rap",
                                  "sparse.transpose", "krylov.prepare", "krylov.make_matvec",
                                  "gallery.demo"]
                         + [f"krylov.{name}" for name in KRYLOV])
def test_entry_points_default_to_the_card(name):
    param = inspect.signature(_entry_points()[name]).parameters["device"]
    assert param.default == "cuda"


def test_smoother_data_takes_its_device_from_the_caller():
    from pyamg_tpu_torch.relaxation import make_smoother_data

    param = inspect.signature(make_smoother_data).parameters["device"]
    assert param.default is inspect.Parameter.empty
