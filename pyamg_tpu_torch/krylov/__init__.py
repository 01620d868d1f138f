"""Krylov solvers with the uniform (A, b, ...) -> (x, info) contract, on
tensors: each runs on its operator's device in its dtype, real or complex.

Port of ``pyamg_tpu/krylov``.
"""

from ._cg import cg
from ._cgs_family import (bicgstab, cgne, cgnr, cr, minimal_residual,
                          steepest_descent)
from ._gmres import fgmres, gmres, gmres_householder, gmres_mgs

__all__ = ["cg", "cr", "cgne", "cgnr", "bicgstab", "gmres", "gmres_mgs",
           "gmres_householder", "fgmres", "steepest_descent",
           "minimal_residual"]
