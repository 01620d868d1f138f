"""Operators on a row-major grid in plain numpy, applied by slicing a
zero-padded grid; the stencil kinds (``stencil.py``, ``diffusion_fv.py``)
write their terms from their definitions."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


class StencilOperator:
    """``terms``: (delta, value grid) pairs, value zero where node + delta
    leaves the grid; applied as y = sum value * x[node + delta]."""

    def __init__(self, grid, terms):
        self.grid = tuple(grid)
        self.terms = terms

    @property
    def n(self):
        return int(np.prod(self.grid))

    def matvec(self, x):
        g = self.grid
        xp = np.pad(np.asarray(x, dtype=np.float64).reshape(g), 1)
        y = np.zeros(g)
        for delta, vals in self.terms:
            sl = tuple(slice(1 + dd, 1 + dd + gg) for dd, gg in zip(delta, g))
            y += vals * xp[sl]
        return y.reshape(-1)

    def to_csr(self):
        """The operator as a scipy CSR matrix of its in-grid entries."""
        idx = np.arange(self.n).reshape(self.grid)
        rows, cols, vals = [], [], []
        for delta, v in self.terms:
            ok = inside(delta, self.grid)
            nb = np.roll(idx, [-dd for dd in delta], axis=range(len(delta)))
            rows.append(idx[ok])
            cols.append(nb[ok])
            vals.append(np.broadcast_to(v, self.grid)[ok])
        return sp.csr_matrix((np.concatenate(vals),
                              (np.concatenate(rows), np.concatenate(cols))),
                             shape=(self.n, self.n))


def inside(delta, grid):
    ok = np.ones(grid, dtype=bool)
    for axis, (dd, g) in enumerate(zip(delta, grid)):
        c = np.arange(g)
        shape = [1] * len(grid)
        shape[axis] = g
        ok &= ((c + dd >= 0) & (c + dd < g)).reshape(shape)
    return ok
