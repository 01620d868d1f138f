"""pyamg_tpu_torch -- the PyTorch and CUDA port of pyamg_tpu.

Algebraic multigrid on an NVIDIA GPU.  This package imports neither JAX
nor pyamg_tpu, the JAX package it is ported from and checked against.
What is ported:

* ``smoothed_aggregation_solver(A)`` with its default arguments and most of
  its options, for scalar symmetric problems with one near-nullspace
  candidate: the setup runs on the host in numpy/scipy (on a 2-D grid
  matrix the structured path of grid-block aggregates, otherwise strength,
  aggregation, tentative and smoothed prolongators and Galerkin products),
  and every DIA sparse matvec of the solve -- DIA levels, the DIA
  smoothers of grid transfers, root-embedded DIA transfers -- runs a
  hand-written CUDA kernel (``csrc/dia_matvec.cu``); multicolor
  Gauss-Seidel, SOR, Jacobi, block, Chebyshev smoothers; V, W, F and AMLI
  cycles; dense and host-iterative coarse solvers; stand-alone cycling,
  every Krylov method of ``krylov`` as accelerator, the mixed-precision
  ``solve_mp``, ``aspreconditioner`` and ``MultilevelSolverSet``; real and
  complex Hermitian operators;
* the setup's sequential host stages (aggregation, first-fit coloring,
  Gauss-Seidel sweeps, classical strength, CSR to DIA) in a compiled
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
* the DIA SpMV benchmark with two more hand-written DIA kernels
  (``benchmarks.dia_spmv_bench``).
"""

from . import gallery, krylov, parallel
from .aggregation import smoothed_aggregation_solver
from .multilevel import (MultilevelSolver, MultilevelSolverSet,
                         coarse_grid_solver, multilevel_solver,
                         multilevel_solver_set)
from .sparse import SparseDIA, SparseELL

__version__ = "0.1.0"

__all__ = ["gallery", "krylov", "parallel", "smoothed_aggregation_solver",
           "MultilevelSolver", "MultilevelSolverSet", "multilevel_solver",
           "multilevel_solver_set", "coarse_grid_solver", "SparseDIA",
           "SparseELL", "__version__"]
