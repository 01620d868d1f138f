"""pyamg_tpu_torch -- the PyTorch and CUDA port of pyamg_tpu.

Algebraic multigrid on an NVIDIA GPU.  This package imports neither JAX
nor pyamg_tpu, the JAX package it is ported from and checked against.
What is ported:

* ``smoothed_aggregation_solver(A)`` with its default arguments and most of
  its options, for symmetric problems, scalar (CSR) or blocked (BSR), with
  any number of near-nullspace candidates: the setup runs on the host in
  numpy/scipy (on a 2-D grid matrix, or a grid of any dimension with
  ``aggregate=("grid", ...)``, the structured path of grid-block
  aggregates, semicoarsened under anisotropy with line smoothers;
  otherwise strength, aggregation, tentative and Jacobi- or
  energy-smoothed prolongators and Galerkin products, with standard,
  Lloyd or pairwise (matching) aggregation; blocked levels in BSR
  blocks); the other symmetric SA front doors ``rootnode_solver``
  (root-node energy minimization, root-embedded transfers) and
  ``adaptive_sa_solver`` (candidates found by relaxation), and in
  ``aggregation`` the recursive adaptive SA ``asa_solver`` (Ritz-filtered
  targets) and ``newideal_solver`` (local least-squares ideal
  interpolation, batched); the black-box
  ``solve``, ``solver`` and ``solver_configuration`` for a Hermitian
  matrix; the work models ``setup_complexity`` and ``cycle_complexity``;
  and every DIA sparse matvec of the solve -- DIA levels, the DIA
  smoothers of grid transfers, root-embedded DIA transfers -- runs a
  hand-written CUDA kernel (``csrc/dia_matvec.cu``); multicolor
  Gauss-Seidel, SOR, Jacobi, block, Chebyshev, line (zebra, also on
  levels of several dofs a node), normal-equation, Krylov and overlapping
  Schwarz smoothers; V, W, F and AMLI
  cycles; dense and host-iterative coarse solvers; stand-alone cycling,
  every Krylov method of ``krylov`` as accelerator, the mixed-precision
  ``solve_mp``, ``aspreconditioner`` and ``MultilevelSolverSet``; real and
  complex Hermitian operators;
* the setup's sequential host stages (aggregation, first-fit coloring,
  Gauss-Seidel sweeps, classical strength, CSR to DIA, the energy CG's
  masked products and projections, Bellman-Ford, the Drake matching) in a
  compiled
  library (``amg_core``, built from ``csrc/amg_core.cpp`` with g++ at first
  use), with Python forms that serve where no compiler is found;
* the Krylov suite (``krylov``: CG, CR, CGNE, CGNR, BiCGStab, steepest
  descent, minimal residual, GMRES with modified Gram-Schmidt or Householder
  orthogonalization, flexible GMRES) and the problem gallery;
* the general smoothed-aggregation setup with its numeric phase on the
  device (``parallel.general_sa_setup_sharded``): the host builds the
  aggregates, colorings and product patterns, and the Galerkin products
  run on two hand-written masked-SpGEMM kernels
  (``csrc/masked_spgemm.cu``); multicolor Gauss-Seidel V-cycles and CG on
  padded-ELL levels;
* classical (Ruge-Stuben) AMG, ``ruge_stuben_solver(A)``: every strength
  measure (classical, symmetric, evolution, energy-based, distance,
  affinity, algebraic distance), the C/F splittings RS, PMIS, PMISc,
  CLJP, CLJPc, MIS, CR and grid, direct and standard interpolation, on the
  host (the RS splitting, both interpolations and the evolution measure's
  steps compiled in ``amg_core``); DIA levels and C-point-embedded DIA
  transfers on the DIA kernel; multicolor Gauss-Seidel, zebra and line
  Jacobi smoothers (every line of a grid solved at once by parallel cyclic
  reduction); and ``parallel.classical_setup_sharded``, its setup with the
  interpolation values, the evolution squarings and the Galerkin products
  on the masked-SpGEMM kernels;
* the DIA SpMV benchmark with two more hand-written DIA kernels
  (``benchmarks.dia_spmv_bench``);
* the graph orderings (breadth-first search, components, reverse
  Cuthill-McKee), the host structural products ``sparse.spgemm``/``rap``/
  ``transpose``, profiling (``util.profiling``: a ``torch.profiler``
  trace, cycle and solve timings, level spectra) and VTK export
  (``vis``).
"""

from . import (aggregation, amg_core, classical, complexity, gallery, graph,
               krylov, parallel, relaxation, sparse, strength, util, vis)
from .aggregation import (adaptive_sa_solver, rootnode_solver,
                          smoothed_aggregation_solver)
from .blackbox import solve, solver, solver_configuration
from .classical import ruge_stuben_solver
from .complexity import cycle_complexity, setup_complexity
from .multilevel import (MultilevelSolver, MultilevelSolverSet,
                         coarse_grid_solver, multilevel_solver,
                         multilevel_solver_set)
from .sparse import BlockELL, SparseBDIA, SparseDIA, SparseELL
from .strength import (classical_strength_of_connection,
                       evolution_strength_of_connection,
                       symmetric_strength_of_connection)

__version__ = "0.1.0"

__all__ = ["aggregation", "amg_core", "classical", "complexity", "gallery",
           "graph", "krylov", "parallel", "relaxation", "sparse", "strength",
           "util", "vis", "smoothed_aggregation_solver", "rootnode_solver",
           "adaptive_sa_solver", "solve", "solver", "solver_configuration",
           "setup_complexity", "cycle_complexity", "ruge_stuben_solver",
           "MultilevelSolver", "MultilevelSolverSet", "multilevel_solver",
           "multilevel_solver_set", "coarse_grid_solver",
           "classical_strength_of_connection",
           "symmetric_strength_of_connection",
           "evolution_strength_of_connection", "SparseDIA", "SparseELL",
           "SparseBDIA", "BlockELL", "__version__"]
