"""-div(k grad u) by finite volumes on the cells of a grid: face
coefficient 2 k_i k_j / (k_i + k_j) between neighbours, k_i on a
boundary face; the diagonal sums the cell's faces axis by axis, the
lower neighbour first.  Values rounded to the configuration's type."""

import numpy as np

from .grid import StencilOperator, inside


def diffusion(grid, k, dtype="float32"):
    grid = tuple(int(g) for g in grid)
    k = np.asarray(k, dtype=np.float64).reshape(grid)
    rnd = np.dtype(dtype)
    diag = np.zeros(grid)
    terms = []
    for axis in range(len(grid)):
        for step in (-1, 1):
            delta = tuple(step if a == axis else 0 for a in range(len(grid)))
            nb = np.roll(k, -step, axis=axis)
            face = 2.0 * k * nb / (k + nb)
            ok = inside(delta, grid)
            diag += np.where(ok, face, k)
            vals = np.where(ok, -face, 0.0)
            terms.append((delta, vals.astype(rnd).astype(np.float64)))
    terms.append(((0,) * len(grid), diag.astype(rnd).astype(np.float64)))
    return StencilOperator(grid, terms)


def operator(op_spec, dtype, field):
    return diffusion(op_spec["grid"], field, dtype)
