"""Aggregation: block aggregation on structured grids, and the greedy
standard and naive aggregations over a strength graph.

Port of ``grid_aggregation``, ``fit_aggop``, ``standard_aggregation``,
``naive_aggregation`` and ``parallel_aggregation`` from
``pyamg_tpu/aggregation/aggregate.py``.  The greedy passes are the JAX
package's pure-Python ones (equal to its native ``amg_core`` kernels), run
over Python lists rather than numpy scalars.  The Lloyd and pairwise
aggregations are not ported yet.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..util.utils import to_csr

__all__ = ["grid_aggregation", "fit_aggop", "standard_aggregation",
           "naive_aggregation", "parallel_aggregation"]


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


def standard_aggregation(C):
    """Three-pass greedy aggregation over the strength graph C.

    Pass 1: a node whose neighbours are all unaggregated seeds an aggregate
    of itself and them.  Pass 2: each unaggregated node joins the aggregate
    of its first aggregated neighbour.  Pass 3: the leftovers seed
    aggregates with their unaggregated neighbours.  Isolated nodes (no
    neighbour but themselves) stay unaggregated: a zero row of AggOp.

    Returns ``(AggOp, roots)``."""
    C = to_csr(C)
    n = C.shape[0]
    indptr, indices = C.indptr.tolist(), C.indices.tolist()
    isolated = -2
    labels = [-1] * n
    roots = []
    nxt = 0

    for i in range(n):                                  # pass 1
        if labels[i] != -1:
            continue
        nbrs = [j for j in indices[indptr[i]:indptr[i + 1]] if j != i]
        if not nbrs:
            labels[i] = isolated
            continue
        if all(labels[j] == -1 for j in nbrs):
            labels[i] = nxt
            for j in nbrs:
                labels[j] = nxt
            roots.append(i)
            nxt += 1

    join = {}                                           # pass 2
    for i in range(n):
        if labels[i] != -1:
            continue
        for j in indices[indptr[i]:indptr[i + 1]]:
            if labels[j] >= 0:
                join[i] = labels[j]
                break
    for i, agg in join.items():
        labels[i] = agg

    for i in range(n):                                  # pass 3
        if labels[i] != -1:
            continue
        labels[i] = nxt
        roots.append(i)
        for j in indices[indptr[i]:indptr[i + 1]]:
            if j != i and labels[j] == -1:
                labels[j] = nxt
        nxt += 1

    labels = np.array(labels, dtype=np.int64)
    labels[labels == isolated] = -1
    return fit_aggop(labels, nxt), np.array(roots, dtype=np.int64)


def naive_aggregation(C):
    """Single-pass greedy aggregation: each unaggregated node seeds an
    aggregate of itself and its unaggregated neighbours.

    Returns ``(AggOp, roots)``."""
    C = to_csr(C)
    n = C.shape[0]
    indptr, indices = C.indptr.tolist(), C.indices.tolist()
    labels = [-1] * n
    roots = []
    for i in range(n):
        if labels[i] != -1:
            continue
        agg = len(roots)
        labels[i] = agg
        roots.append(i)
        for j in indices[indptr[i]:indptr[i + 1]]:
            if labels[j] == -1:
                labels[j] = agg
    return (fit_aggop(np.array(labels, dtype=np.int64), len(roots)),
            np.array(roots, dtype=np.int64))


def parallel_aggregation(C, seed=0):
    """Round-based aggregation in whole-graph vectorized passes: distance-2
    independent roots by weighted Luby rounds (weights from ``seed``), two
    sweeps that attach nodes to the neighbouring aggregate of largest
    weight, then the leftovers as aggregates of their own.

    The aggregates have the shape of :func:`standard_aggregation`'s (roots
    mutually non-adjacent, every node within distance 2 of its root) but
    not its order.  Returns ``(AggOp, roots)``."""
    C = to_csr(C)
    n = C.shape[0]
    G = C.copy()
    G.data = np.ones_like(G.data, dtype=np.float64)
    G.setdiag(0)
    G.eliminate_zeros()
    rows = np.repeat(np.arange(n), np.diff(G.indptr))
    cols = G.indices
    iso = np.diff(G.indptr) == 0

    weight = np.random.default_rng(seed).random(n)
    tie = weight + np.arange(n) * 1e-12
    state = np.zeros(n, dtype=np.int8)      # 0 undecided, 1 root, -1 covered
    state[iso] = -1
    labels = np.full(n, -1, dtype=np.int64)

    while (state == 0).any():
        active = state == 0
        w = np.where(active, tie, -np.inf)
        # a winner is the strict maximum of its neighbourhood and the weak
        # maximum of every neighbour's: with distinct weights, a distance-2
        # independent set
        nbr1 = np.full(n, -np.inf)
        m = active[rows] & active[cols]
        np.maximum.at(nbr1, rows[m], w[cols[m]])
        nbr2 = np.full(n, -np.inf)
        np.maximum.at(nbr2, rows[m], nbr1[cols[m]])
        winners = active & (w > nbr1) & (w >= nbr2)
        if not winners.any():
            winners = np.zeros(n, dtype=bool)
            winners[int(np.argmax(w))] = True
        state[winners] = 1
        cov1 = np.zeros(n, dtype=bool)
        cov1[cols[winners[rows]]] = True
        cov2 = np.zeros(n, dtype=bool)
        cov2[cols[cov1[rows]]] = True
        state[(cov1 | cov2) & (state == 0)] = -1

    roots = np.flatnonzero(state == 1)
    labels[roots] = np.arange(roots.size)

    for _ in range(2):
        unass = labels < 0
        m = unass[cols] & (labels[rows] >= 0)
        if not m.any():
            break
        er, ec = rows[m], cols[m]
        best_w = np.full(n, -np.inf)
        np.maximum.at(best_w, ec, tie[er])
        win = tie[er] == best_w[ec]
        pick = np.full(n, -1, dtype=np.int64)
        pick[ec[win]] = labels[er[win]]
        newly = unass & (pick >= 0)
        labels[newly] = pick[newly]

    left = np.flatnonzero((labels < 0) & ~iso)
    if left.size:
        labels[left] = np.arange(left.size) + roots.size
        roots = np.concatenate([roots, left])
    return fit_aggop(labels, roots.size), roots
