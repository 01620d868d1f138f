"""pyamg_tpu_torch -- the PyTorch and CUDA port of pyamg_tpu.

Algebraic multigrid on an NVIDIA GPU: the setup runs on the host in
numpy/scipy, the hierarchy lives on a torch device, and every DIA sparse
matvec of the solve runs a hand-written CUDA kernel
(``csrc/dia_matvec.cu``).  This package imports neither JAX nor pyamg_tpu,
the JAX package it is ported from and checked against.

The first slice covers the structured smoothed-aggregation path: 2-D grid
Poisson, Chebyshev or Jacobi smoothing, V-cycles, CG and the
mixed-precision ``solve_mp``.
"""

from . import gallery
from .aggregation import smoothed_aggregation_solver
from .multilevel import MultilevelSolver
from .sparse import SparseDIA

__version__ = "0.1.0"

__all__ = ["gallery", "smoothed_aggregation_solver", "MultilevelSolver",
           "SparseDIA", "__version__"]
