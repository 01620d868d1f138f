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
  CG, the mixed-precision ``solve_mp`` and ``aspreconditioner``;
* the general smoothed-aggregation setup with its numeric phase on the
  device (``parallel.general_sa_setup_sharded``): the host builds the
  aggregates, colorings and product patterns, and the Galerkin products
  run on two hand-written masked-SpGEMM kernels
  (``csrc/masked_spgemm.cu``); multicolor Gauss-Seidel V-cycles and CG on
  padded-ELL levels;
* the DIA SpMV benchmark with two more hand-written DIA kernels
  (``benchmarks.dia_spmv_bench``).
"""

from . import gallery, parallel
from .aggregation import smoothed_aggregation_solver
from .multilevel import MultilevelSolver, coarse_grid_solver
from .sparse import SparseDIA, SparseELL

__version__ = "0.1.0"

__all__ = ["gallery", "parallel", "smoothed_aggregation_solver",
           "MultilevelSolver", "coarse_grid_solver", "SparseDIA",
           "SparseELL", "__version__"]
