"""Graph algorithms of the setup (host, numpy).

Port of ``vertex_coloring``, ``maximal_independent_set``, ``bellman_ford``
and ``lloyd_cluster`` from ``pyamg_tpu/graph.py``.  Colorings: greedy
first-fit (the compiled ``amg_core`` pass where the library loaded, else
the same loop over Python lists) and Jones-Plassmann rounds.  Independent
sets: greedy in node order, Luby rounds, and distance k through a power of
the graph.  Bellman-Ford from a seed set runs compiled where the library
loaded; Lloyd clustering alternates it with a recentering on the farthest
node of each cluster.  The rest of the JAX package's graph module is not
ported yet.
"""

from __future__ import annotations

import numpy as np

from .amg_core import bellman_ford_native, first_fit_coloring_native
from .util.utils import not_ported, row_reduce, to_csr

__all__ = ["vertex_coloring", "maximal_independent_set", "bellman_ford",
           "lloyd_cluster"]


def _graph_csr(G):
    G = to_csr(G)
    if G.shape[0] != G.shape[1]:
        raise ValueError("expected square matrix")
    return G


def _off_diagonal_pattern(G):
    """G's pattern with unit values and no diagonal."""
    G1 = G.copy()
    G1.data = np.ones_like(G1.data, dtype=np.float64)
    G1.setdiag(0)
    G1.eliminate_zeros()
    return G1


def maximal_independent_set(G, algo="parallel", k=None, seed=0):
    """Maximal independent set of G's graph: int32 flags, 1 in the set.

    ``algo="serial"``: greedy in node order; ``"parallel"``: Luby rounds
    with random weights from ``seed`` (each round, every undecided node
    whose weight beats all its undecided neighbours' joins, and its
    neighbours leave).  ``k`` > 1: a distance-k set, through the k-th
    power of the graph.

    Examples
    --------
    >>> from pyamg_tpu_torch.gallery import poisson
    >>> mis = maximal_independent_set(poisson((8, 8), format='csr'))
    >>> bool(0 < mis.sum() < 64)
    True
    """
    G = _graph_csr(G)
    n = G.shape[0]
    if k is not None and k > 1:
        Gk = G.copy()
        Gk.data = np.ones_like(Gk.data)
        P = Gk
        for _ in range(k - 1):
            P = (P @ Gk).tocsr()
        G = P
    if algo == "serial":
        indptr, indices = G.indptr.tolist(), G.indices.tolist()
        mis = np.zeros(n, dtype=np.int32)
        excluded = [False] * n
        for i in range(n):
            if not excluded[i]:
                mis[i] = 1
                excluded[i] = True
                for j in indices[indptr[i]:indptr[i + 1]]:
                    excluded[j] = True
        return mis
    if algo == "parallel":
        weight = np.random.default_rng(seed).random(n)
        state = np.zeros(n, dtype=np.int8)     # 0 undecided, 1 in, -1 out
        G1 = _off_diagonal_pattern(G)
        rows = np.repeat(np.arange(n), np.diff(G1.indptr))
        cols = G1.indices
        while (state == 0).any():
            active = state == 0
            w = np.where(active, weight + np.arange(n) * 1e-12, -np.inf)
            nbr_max = np.full(n, -np.inf)
            np.maximum.at(nbr_max, rows, w[cols])
            winners = active & (w > nbr_max)
            if not winners.any():
                winners = np.zeros(n, dtype=bool)
                winners[int(np.argmax(np.where(active, w, -np.inf)))] = True
            state[winners] = 1
            excl = np.zeros(n, dtype=bool)
            excl[cols[winners[rows]]] = True
            state[excl & (state == 0)] = -1
        return (state == 1).astype(np.int32)
    raise ValueError(f"unknown algo {algo!r}")


def bellman_ford(G, seeds, maxiter=None):
    """Shortest distances over the edge weights |G| from a seed set:
    ``(distances, nearest)``, nearest the seed each node's path starts at
    (-1, at distance inf, where none reaches).  Compiled where the library
    loaded; else rounds of relaxing every edge at once (at most
    ``maxiter``, default n), a node that improved taking the nearest seed
    of its first edge in CSR order that reaches the new distance."""
    G = _graph_csr(G)
    n = G.shape[0]
    seeds = np.asarray(seeds, dtype=np.int64)
    native = bellman_ford_native(G, seeds)
    if native is not None:
        return native
    dist = np.full(n, np.inf)
    nearest = np.full(n, -1, dtype=np.int64)
    dist[seeds] = 0
    nearest[seeds] = seeds
    rows = np.repeat(np.arange(n), np.diff(G.indptr))
    cols = G.indices
    w = np.abs(G.data)
    # each column's edges in CSR order
    by_col = np.argsort(cols, kind="stable")
    col_ptr = np.concatenate([[0], np.cumsum(np.bincount(cols,
                                                         minlength=n))])
    for _ in range(maxiter if maxiter is not None else n):
        cand = dist[rows] + w
        if not (cand < dist[cols]).any():
            break
        new_dist = dist.copy()
        np.minimum.at(new_dist, cols, cand)
        for c in np.flatnonzero(new_dist < dist):
            e = by_col[col_ptr[c]:col_ptr[c + 1]]
            e = e[np.isclose(cand[e], new_dist[c])]
            if e.size:
                nearest[c] = nearest[rows[e[0]]]
        dist = new_dist
    return dist, nearest


def _seed_to_cluster(nearest, seeds):
    """The cluster (the index of its seed in ``seeds``) of each node, -1
    where no seed reaches."""
    lookup = -np.ones(int(max(nearest.max(), seeds.max())) + 1,
                      dtype=np.int64)
    lookup[seeds] = np.arange(seeds.size)
    return np.where(nearest >= 0, lookup[np.maximum(nearest, 0)], -1)


def _recenter(dist, clusters, seeds):
    """Each cluster's new seed: its member farthest from the current seed,
    the smallest node index among equally far ones; an empty cluster keeps
    its seed."""
    n = dist.shape[0]
    nodes = np.flatnonzero(clusters >= 0)
    c, d = clusters[nodes], dist[nodes]
    far_d = np.full(seeds.size, -np.inf)
    np.maximum.at(far_d, c, d)
    at_far = d == far_d[c]
    far = np.full(seeds.size, n, dtype=np.int64)
    np.minimum.at(far, c[at_far], nodes[at_far])
    return np.where(far < n, far, seeds)


def lloyd_cluster(G, seeds, maxiter=10):
    """Lloyd clustering on a graph: Bellman-Ford from the seeds, then each
    seed moves to the farthest node of its cluster, until the seeds stay
    or ``maxiter`` rounds.  ``seeds``: the seed nodes, or their number
    (drawn from ``default_rng(0)``).  Returns ``(distances, clusters,
    seeds)``, clusters -1 where no seed reaches."""
    G = _graph_csr(G)
    n = G.shape[0]
    if np.isscalar(seeds):
        seeds = np.random.default_rng(0).choice(n, size=int(seeds),
                                                replace=False)
    seeds = np.asarray(seeds, dtype=np.int64).copy()
    for _ in range(maxiter):
        dist, nearest = bellman_ford(G, seeds)
        new_seeds = _recenter(dist, _seed_to_cluster(nearest, seeds), seeds)
        if np.array_equal(new_seeds, seeds):
            break
        seeds = new_seeds
    dist, nearest = bellman_ford(G, seeds)
    return dist, _seed_to_cluster(nearest, seeds), seeds


def vertex_coloring(G, method="JP", seed=0):
    """Vertex coloring of the graph of G (diagonal ignored); returns an
    int32 array of colors 0, 1, ...

    ``method``: ``"FF"``/``"first-fit"``, greedy in node order, each node
    taking the smallest color none of its neighbours holds;
    ``"JP"``/``"MIS"``, Jones-Plassmann rounds with random weights from
    ``seed``.

    Examples
    --------
    >>> from pyamg_tpu_torch.gallery import poisson
    >>> c = vertex_coloring(poisson((8, 8), format='csr'), "FF")
    >>> int(c.max()) + 1
    2
    """
    G = _graph_csr(G)
    n = G.shape[0]
    G1 = _off_diagonal_pattern(G)

    if method in ("FF", "first-fit"):
        native = first_fit_coloring_native(G1)
        if native is not None:
            return native
        indptr, indices = G1.indptr.tolist(), G1.indices.tolist()
        colors = [-1] * n
        for i in range(n):
            taken = {colors[j] for j in indices[indptr[i]:indptr[i + 1]]}
            c = 0
            while c in taken:
                c += 1
            colors[i] = c
        return np.array(colors, dtype=np.int32)

    if method in ("JP", "MIS"):
        indptr, indices = G1.indptr, G1.indices
        tie = np.random.default_rng(seed).random(n) + np.arange(n) * 1e-12
        colors = np.full(n, -1, dtype=np.int32)
        color = 0
        remaining = np.ones(n, dtype=bool)
        while remaining.any():
            w = np.where(remaining, tie, -np.inf)
            # largest weight among the still-uncolored neighbours
            wj = np.where(remaining[indices], w[indices], -np.inf)
            nbr_max = row_reduce(wj, indptr, np.maximum, -np.inf)
            winners = remaining & (w > nbr_max)
            if not winners.any():
                winners = np.zeros(n, dtype=bool)
                winners[int(np.argmax(w))] = True
            colors[winners] = color
            color += 1
            remaining &= ~winners
        return colors
    if method == "LDF":
        raise not_ported("vertex_coloring method 'LDF'",
                         "the other constructors")
    raise ValueError(f"unknown coloring method {method!r}")
