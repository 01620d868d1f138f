"""A constant stencil: every neighbour within distance 1 (``box``) or
along one axis (``cross``), values rounded to the configuration's type."""

import itertools

import numpy as np

from .grid import StencilOperator, inside


def stencil(grid, shape, center, neighbor, dtype="float32"):
    grid = tuple(int(g) for g in grid)
    rnd = np.dtype(dtype).type
    terms = []
    for delta in itertools.product((-1, 0, 1), repeat=len(grid)):
        if shape == "cross" and sum(map(abs, delta)) > 1:
            continue
        v = float(rnd(center if not any(delta) else neighbor))
        terms.append((delta, np.where(inside(delta, grid), v, 0.0)))
    return StencilOperator(grid, terms)


def operator(op_spec, dtype, field=None):
    return stencil(op_spec["grid"], op_spec["shape"], op_spec["center"],
                   op_spec["neighbor"], dtype)
