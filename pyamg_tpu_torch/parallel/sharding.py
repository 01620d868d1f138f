"""Sharded hierarchies and their solvers, on one device.

Port of the one-device part of ``pyamg_tpu/parallel/sharding.py``:

* the padded sizes, ELL padding, and ``ShardedSolver`` as the general
  setups return it (``from_sharded_levels``), with the coarsest level's
  pseudoinverse padded to the level's padded size;
* ``StructuredShardedSolver`` and ``shard_structured_solver`` for the
  structured (DIA and grid-operator) hierarchies.

On one device every padded size is the level's own, there is nothing to
re-place, and the JAX package's ``'pack'`` halo exchange has nothing to
exchange, so none of that is carried over.  Row sharding over several
cards and ``shard_solver`` are not ported yet (ROADMAP.md, Queue 1: the
distributed path).
"""

from __future__ import annotations

import numpy as np
import torch

from ..multilevel import MultilevelSolver
from ..sparse.ell import SparseELL
from ..util.utils import not_ported

__all__ = ["ShardedSolver", "StructuredShardedSolver",
           "shard_structured_solver", "pad_to"]

_STRUCTURED_ACCELS = ("cg", "bicgstab", "gmres", "fgmres", None)


def pad_to(n: int, k: int) -> int:
    """n rounded up to a multiple of k."""
    return -(-n // k) * k


def _pad_ell(E: SparseELL, n_rows_pad: int, n_cols_pad: int) -> SparseELL:
    """E with structurally empty rows and columns appended: padding rows
    hold data 0 and column 0, so SpMV gives 0 there and gathers stay in
    bounds."""
    n, w = E.shape[0], E.width
    data = E.data.new_zeros((n_rows_pad, w))
    cols = E.cols.new_zeros((n_rows_pad, w))
    nnz = E.row_nnz.new_zeros((n_rows_pad,))
    data[:n], cols[:n], nnz[:n] = E.data, E.cols, E.row_nnz
    return SparseELL(data, cols, nnz, (n_rows_pad, n_cols_pad))


class ShardedSolver:
    """A :class:`MultilevelSolver` over padded-ELL levels.

    ``solve`` pads the right-hand side to the padded size of level 0, runs
    the inner solver's cycle and Krylov loop, and returns the solution's
    first ``n_orig`` entries, as a tensor on the hierarchy's device."""

    @classmethod
    def from_sharded_levels(cls, levels, sizes, n_orig, device, coarse=None):
        """Assemble from levels whose operators are already padded and on
        ``device``.  ``coarse``: the coarsest level's padded pseudoinverse
        (a tensor); by default it is computed from that level's
        ``A_csr``."""
        self = object.__new__(cls)
        self.sizes, self.n_orig = list(sizes), int(n_orig)
        self.device = torch.device(device)
        self._finalize(levels, coarse)
        return self

    def _finalize(self, levels, coarse):
        self.inner = MultilevelSolver(levels, device=self.device)
        if coarse is None:
            A_c = levels[-1].A_csr
            nc = A_c.shape[0]
            pinv = np.zeros((self.sizes[-1],) * 2, dtype=A_c.dtype)
            pinv[:nc, :nc] = np.linalg.pinv(A_c.toarray())
            coarse = torch.as_tensor(pinv, device=self.device)
        self.inner._coarse_mat = coarse

    @property
    def levels(self):
        return self.inner.levels

    def _pad_vec(self, b):
        b = torch.as_tensor(b, device=self.device).reshape(-1)
        out = b.new_zeros(self.sizes[0])
        out[:self.n_orig] = b
        return out

    def solve(self, b, **kw):
        """``MultilevelSolver.solve`` on the padded system; same keyword
        arguments.  Returns x (or ``(x, info)`` with ``return_info``)."""
        out = self.inner.solve(self._pad_vec(b), **kw)
        if isinstance(out, tuple):
            return (out[0][:self.n_orig],) + tuple(out[1:])
        return out[:self.n_orig]

    def __repr__(self):
        return f"ShardedSolver(devices=1, levels={len(self.levels)})\n" \
            + repr(self.inner)


class StructuredShardedSolver:
    """A structured (DIA and grid-operator) hierarchy ready to solve.

    The JAX package re-places the hierarchy's arrays row-sharded over a
    mesh; on one device there is nothing to re-place, so this wraps the
    hierarchy's :class:`MultilevelSolver` and solves on its device.
    ``min_shard_rows`` (the smallest level the JAX package shards) is
    accepted and ignored.  ``mesh`` other than None, or ``n_devices``
    other than None or 1, is not ported."""

    def __init__(self, ml: MultilevelSolver, mesh=None, n_devices=None,
                 axis_name: str = "rows", min_shard_rows: int = 4096):
        if mesh is not None or n_devices not in (None, 1):
            raise not_ported("StructuredShardedSolver over a mesh of "
                             "several devices", "the distributed path")
        self.mesh = None
        self.axis = axis_name
        self.ml = ml
        self.n = ml.levels[0].A.shape[0]

    @property
    def levels(self):
        return self.ml.levels

    def solve(self, b, tol=1e-8, maxiter=100, cycle="V", accel="cg",
              residuals=None):
        """Solve A x = b to relative residual ``tol``: stand-alone cycles
        (``accel=None``) or CG, BiCGStab, GMRES or FGMRES with one cycle
        as preconditioner.  ``residuals`` gets the iteration's residual
        norms (one more than the iterations).  Returns x as a tensor on
        the hierarchy's device."""
        if accel not in _STRUCTURED_ACCELS:
            raise ValueError("StructuredShardedSolver supports accel in "
                             "('cg', 'bicgstab', 'gmres', 'fgmres', None)")
        return self.ml.solve(b, tol=tol, maxiter=maxiter, cycle=cycle,
                             accel=accel, residuals=residuals)

    def __repr__(self):
        return "StructuredShardedSolver(devices=1)\n" + repr(self.ml)


def shard_structured_solver(ml, mesh=None, n_devices=None,
                            axis_name: str = "rows",
                            min_shard_rows: int = 4096):
    """A :class:`StructuredShardedSolver` of a structured hierarchy (on
    one device: the hierarchy as it is)."""
    return StructuredShardedSolver(ml, mesh=mesh, n_devices=n_devices,
                                   axis_name=axis_name,
                                   min_shard_rows=min_shard_rows)
