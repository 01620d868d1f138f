"""The operators the benchmark builds and hands to the program.

A configuration's ``operator`` is ``{"kind": <name>, ...}``; the kind is
the module ``operators/<name>.py`` here, whose ``build(spec, dtype,
device, field)`` returns the operator on the device, and the module
``reference/<name>.py`` beside the plain reference, which writes the same
operator again in numpy.  ``FIELD`` in the module says whether the kind
takes a coefficient field from the traffic mix (``coefficients``).  A new
kind of operator is a new file in each of the two places.

An operator has ``n``, ``grid`` (None without one), ``matvec(x)`` (y = A x
in float64, to make right-hand sides) and ``program_input(form, dtype)``:
the operator as the program takes it, a copy of its own so that the
program cannot alter the benchmark's.  :class:`GridOperator` serves the
stencils on a row-major grid.
"""

from __future__ import annotations

import importlib
import itertools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F


def kind_module(op_spec: dict):
    return importlib.import_module(f"amgbench.operators.{op_spec['kind']}")


def build(op_spec: dict, dtype, device, field=None):
    """The configuration's operator (``field``: its coefficient grid,
    for the kinds that take one)."""
    return kind_module(op_spec).build(op_spec, dtype, device, field)


def takes_field(op_spec: dict) -> bool:
    return bool(getattr(kind_module(op_spec), "FIELD", False))


def stencil_offsets(d: int, shape: str):
    """The neighbour offset vectors of a ``box`` or ``cross`` stencil,
    centre included, in lexicographic order."""
    offs = list(itertools.product((-1, 0, 1), repeat=d))
    if shape == "cross":
        offs = [o for o in offs if sum(abs(c) for c in o) <= 1]
    elif shape != "box":
        raise ValueError(f"unknown stencil shape {shape!r}")
    return offs


def _flat(delta, grid) -> int:
    strides = [int(np.prod(grid[k + 1:])) for k in range(len(grid))]
    return sum(int(dd) * s for dd, s in zip(delta, strides))


def inside(delta, grid, device) -> torch.Tensor:
    """Where node + delta lies in the grid, as a boolean grid."""
    mask = torch.ones(grid, dtype=torch.bool, device=device)
    for axis, (dd, g) in enumerate(zip(delta, grid)):
        c = torch.arange(g, device=device)
        ok = (c + dd >= 0) & (c + dd < g)
        shape = [1] * len(grid)
        shape[axis] = g
        mask = mask & ok.view(shape)
    return mask


@dataclass
class GridOperator:
    """A stencil operator: ``diags[j, i]`` couples node i with node
    ``i + offsets[j]`` (offsets ascending), zero outside the grid, in the
    configuration's type; ``valid`` (host) marks the in-grid couplings."""
    grid: tuple
    offsets: tuple
    diags: torch.Tensor       # (K, n), the configuration's type
    valid: np.ndarray         # (K, n) bool

    @property
    def n(self) -> int:
        return int(self.diags.shape[1])

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x in float64, by shifted products of a padded x."""
        lo, hi = -min(self.offsets), max(self.offsets)
        xp = F.pad(x, (lo, hi))
        y = torch.zeros_like(x)
        for j, o in enumerate(self.offsets):
            y += self.diags[j].double() * xp[lo + o:lo + o + self.n]
        return y

    def program_input(self, form: str, dtype):
        """``"dia"``: a SparseDIA of a copy of the diagonals on their
        device; ``"csr"``: a host scipy CSR matrix of the in-grid
        entries."""
        if form == "dia":
            from pyamg_tpu_torch.sparse import SparseDIA

            return SparseDIA(self.diags.to(dtype).clone().contiguous(),
                             self.offsets, (self.n, self.n))
        if form == "csr":
            import scipy.sparse as sp

            valid = self.valid.T
            vals = self.diags.T.to(dtype).cpu().numpy()
            rows = np.arange(self.n, dtype=np.int64)[:, None]
            cols = rows + np.asarray(self.offsets, dtype=np.int64)[None, :]
            indptr = np.concatenate([[0], np.cumsum(valid.sum(axis=1))])
            return sp.csr_matrix((vals[valid], cols[valid].astype(np.int32),
                                  indptr), shape=(self.n, self.n))
        raise ValueError(f"unknown input form {form!r}")


def assemble(grid, deltas, values, dtype, device) -> GridOperator:
    """A GridOperator from one float64 value grid a neighbour offset."""
    order = sorted(range(len(deltas)), key=lambda j: _flat(deltas[j], grid))
    diags, valid = [], []
    for j in order:
        ok = inside(deltas[j], grid, device)
        v = torch.where(ok, values[j], torch.zeros((), dtype=torch.float64,
                                                   device=device))
        diags.append(v.to(dtype).reshape(-1))
        valid.append(ok.reshape(-1).cpu().numpy())
    return GridOperator(tuple(grid),
                        tuple(_flat(deltas[j], grid) for j in order),
                        torch.stack(diags), np.stack(valid))
