"""pyamg_tpu_torch -- the PyTorch and CUDA port of pyamg_tpu.

Algebraic multigrid on an NVIDIA GPU.  This package imports neither JAX
nor pyamg_tpu, the JAX package it is ported from and checked against.
Two paths are ported:

* the structured smoothed-aggregation path (``smoothed_aggregation_solver``
  on 2-D grid Poisson): the setup runs on the host in numpy/scipy, and
  every DIA sparse matvec of the solve runs a hand-written CUDA kernel
  (``csrc/dia_matvec.cu``); Chebyshev or Jacobi smoothing, V-cycles, CG
  and the mixed-precision ``solve_mp``;
* the general smoothed-aggregation setup with its numeric phase on the
  device (``parallel.general_sa_setup_sharded``): the host builds the
  aggregates, colorings and product patterns, and the Galerkin products
  run on two hand-written masked-SpGEMM kernels
  (``csrc/masked_spgemm.cu``); multicolor Gauss-Seidel V-cycles and CG on
  padded-ELL levels.
"""

from . import gallery, parallel
from .aggregation import smoothed_aggregation_solver
from .multilevel import MultilevelSolver
from .sparse import SparseDIA, SparseELL

__version__ = "0.1.0"

__all__ = ["gallery", "parallel", "smoothed_aggregation_solver",
           "MultilevelSolver", "SparseDIA", "SparseELL", "__version__"]
