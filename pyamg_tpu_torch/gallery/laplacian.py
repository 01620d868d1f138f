"""Poisson-problem discretizations on regular grids.

Port of ``poisson`` and ``gauge_laplacian`` from
``pyamg_tpu/gallery/laplacian.py`` (numpy, unchanged).
"""

from __future__ import annotations

import numpy as np

from .stencil import stencil_grid

__all__ = ["poisson", "gauge_laplacian"]


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


def gauge_laplacian(npts, spacing=1.0, beta=0.1, seed=None):
    """Gauge Laplacian from quantum chromodynamics on a 2D periodic grid.

    Hermitian positive definite for beta > 0; the 5-point Laplacian structure
    with random U(1) phases on the links, drawn from ``seed``.
    """
    import scipy.sparse as sp

    N = int(npts)
    rng = np.random.default_rng(seed)

    # random link phases as a function of 1-D position
    alpha_x = 1.0j * 2.0 * np.pi * beta * rng.standard_normal(N * N)
    alpha_y = 1.0j * 2.0 * np.pi * beta * rng.standard_normal(N * N)

    idx = np.arange(N * N)
    ix, iy = idx // N, idx % N

    rows, cols, vals = [idx], [idx], [np.full(N * N, 4.0 + 0j)]

    # x-direction links (non-periodic truncation like the Dirichlet Poisson)
    has_xp = ix + 1 < N
    r = idx[has_xp]
    rows += [r, r + N]
    cols += [r + N, r]
    phase = np.exp(alpha_x[r])
    vals += [-phase, -np.conj(phase)]

    has_yp = iy + 1 < N
    r = idx[has_yp]
    rows += [r, r + 1]
    cols += [r + 1, r]
    phase = np.exp(alpha_y[r])
    vals += [-phase, -np.conj(phase)]

    A = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(N * N, N * N),
    ).tocsr()
    A = A * (1.0 / spacing**2)
    return A
