"""Host forms of the matrices read back from the program's hierarchy.

The harness reads each matrix as ``("rows", diags, offsets, shape)``
(``diags[k, i]`` couples row i with column ``i + offsets[k]``) or as
``("csr", matrix)``, values in float64; :func:`host` wraps either in a
:class:`Matrix` that multiplies in plain numpy or scipy.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def to_bfloat16(a):
    """``a`` rounded to bfloat16 (to nearest, ties to even), as float64."""
    u = np.asarray(a, dtype=np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


class Matrix:
    """``matvec``, ``rmatvec`` (the transpose), and ``map(f)``: the same
    pattern with ``f`` applied to the values (``np.abs``,
    :func:`to_bfloat16`)."""

    def __init__(self, shape, diags=None, offsets=None, csr=None):
        self.shape = tuple(int(s) for s in shape)
        self.diags, self.offsets, self.csr = diags, offsets, csr

    def _spans(self):
        n, m = self.shape
        for k, off in enumerate(self.offsets):
            i0, i1 = max(0, -off), min(n, m - off)
            if i1 > i0:
                yield k, off, i0, i1

    def matvec(self, x):
        if self.csr is not None:
            return self.csr @ x
        y = np.zeros(self.shape[0])
        for k, off, i0, i1 in self._spans():
            y[i0:i1] += self.diags[k, i0:i1] * x[i0 + off:i1 + off]
        return y

    def rmatvec(self, y):
        if self.csr is not None:
            return self.csr.T @ y
        x = np.zeros(self.shape[1])
        for k, off, i0, i1 in self._spans():
            x[i0 + off:i1 + off] += self.diags[k, i0:i1] * y[i0:i1]
        return x

    def map(self, f):
        if self.csr is not None:
            c = self.csr.copy()
            c.data = f(c.data)
            return Matrix(self.shape, csr=c)
        return Matrix(self.shape, diags=f(self.diags), offsets=self.offsets)


def host(item) -> Matrix:
    """A :class:`Matrix` of one read-back item."""
    if item[0] == "rows":
        _, diags, offsets, shape = item
        return Matrix(shape, diags=np.asarray(diags, dtype=np.float64),
                      offsets=tuple(int(o) for o in offsets))
    if item[0] == "csr":
        c = sp.csr_matrix(item[1], dtype=np.float64)
        return Matrix(c.shape, csr=c)
    raise ValueError(f"unknown matrix form {item[0]!r}")


class Product:
    """``factors[0] @ factors[1] @ ...``, applied right to left."""

    def __init__(self, factors):
        self.factors = list(factors)
        self.shape = (self.factors[0].shape[0], self.factors[-1].shape[1])

    def matvec(self, x):
        for f in reversed(self.factors):
            x = f.matvec(x)
        return x

    def rmatvec(self, y):
        for f in self.factors:
            y = f.rmatvec(y)
        return y

    def map(self, f):
        return Product([g.map(f) for g in self.factors])
