"""Graph colorings for the multicolor smoothers (host, numpy).

Port of ``vertex_coloring`` from ``pyamg_tpu/graph.py``: greedy first-fit
(the compiled ``amg_core`` pass where the library loaded, else the same
loop over Python lists) and Jones-Plassmann rounds.  The other
graph algorithms are not ported yet.
"""

from __future__ import annotations

import numpy as np

from .amg_core import first_fit_coloring_native
from .util.utils import not_ported, row_reduce, to_csr

__all__ = ["vertex_coloring"]


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
    G = to_csr(G)
    n = G.shape[0]
    if G.shape[1] != n:
        raise ValueError("expected square matrix")
    G1 = G.copy()
    G1.data = np.ones_like(G1.data, dtype=np.float64)
    G1.setdiag(0)
    G1.eliminate_zeros()

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
