"""Aggregation on structured grids.

Port of ``grid_aggregation`` and ``fit_aggop`` from
``pyamg_tpu/aggregation/aggregate.py`` (numpy, unchanged).  The
strength-based aggregations of the unstructured path are not ported yet.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["grid_aggregation", "fit_aggop"]


def grid_aggregation(grid, block=None):
    """Block aggregation on a structured grid: aggregate (i1//b1, ...,
    id//bd).  The coarse grid is again a row-major grid, so every Galerkin
    coarse operator stays a fixed-offset stencil matrix (DIA format) and
    the transfers are reshape/repeat operators.

    Returns (AggOp, roots, coarse_grid)."""
    grid = tuple(int(g) for g in grid)
    d = len(grid)
    if block is None:
        block = (3,) * d
    block = tuple(int(b) for b in block)
    cgrid = tuple(-(-g // b) for g, b in zip(grid, block))
    N = int(np.prod(grid))
    coords = np.unravel_index(np.arange(N), grid)
    labels = np.ravel_multi_index(
        tuple(c // b for c, b in zip(coords, block)), cgrid)
    AggOp = fit_aggop(labels, int(np.prod(cgrid)))
    # root of each aggregate: the member nearest the block center
    ccoords = np.unravel_index(np.arange(int(np.prod(cgrid))), cgrid)
    root_coords = tuple(
        np.minimum(cc * b + b // 2, g - 1)
        for cc, b, g in zip(ccoords, block, grid))
    roots = np.ravel_multi_index(root_coords, grid)
    return AggOp, roots, cgrid


def fit_aggop(labels, n_agg=None):
    """CSR aggregate-indicator operator from a label vector
    (-1 = unaggregated)."""
    labels = np.asarray(labels, dtype=np.int64)
    n = labels.shape[0]
    if n_agg is None:
        n_agg = int(labels.max()) + 1 if (labels >= 0).any() else 0
    rows = np.flatnonzero(labels >= 0)
    return sp.coo_matrix((np.ones(rows.size), (rows, labels[rows])),
                         shape=(n, n_agg)).tocsr()
