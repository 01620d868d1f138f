"""Poisson-problem discretizations on regular grids.

Port of ``poisson`` from ``pyamg_tpu/gallery/laplacian.py`` (numpy,
unchanged).
"""

from __future__ import annotations

import numpy as np

from .stencil import stencil_grid

__all__ = ["poisson"]


def poisson(grid, spacing=None, dtype=float, format=None, type="FD"):
    """N-dimensional Poisson problem, unit spacing, Dirichlet boundaries.

    FD: standard 2N+1-point stencil (e.g. [-1, 2, -1] in 1D, 5-point in 2D).
    FE: Q1 finite elements -- all-(-1) stencil with center ``3**N - 1``.

    Examples
    --------
    >>> poisson((4,)).toarray()
    array([[ 2., -1.,  0.,  0.],
           [-1.,  2., -1.,  0.],
           [ 0., -1.,  2., -1.],
           [ 0.,  0., -1.,  2.]])
    """
    grid = tuple(grid)
    N = len(grid)
    if N < 1 or min(grid) < 1:
        raise ValueError(f"invalid grid shape: {grid}")

    if type == "FD":
        stencil = np.zeros((3,) * N, dtype=dtype)
        center = (1,) * N
        stencil[center] = 2 * N
        for d in range(N):
            for s in (0, 2):
                idx = list(center)
                idx[d] = s
                stencil[tuple(idx)] = -1
    elif type == "FE":
        stencil = -np.ones((3,) * N, dtype=dtype)
        stencil[(1,) * N] = 3**N - 1
    else:
        raise ValueError(f"unknown discretization type {type!r}")

    return stencil_grid(stencil, grid, format=format)
