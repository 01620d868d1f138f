"""C/F splittings of classical AMG (host, numpy).

Port of ``pyamg_tpu/classical/split.py``: the Ruge-Stuben splitting ``RS``
(the compiled ``amg_core`` form where the library loaded, else its
interval-list Python form, which moves node for node with it), the
round-based ``PMIS``/``PMISc`` and ``CLJP``/``CLJPc`` (random or
coloring-based weights), ``MIS`` and the geometric ``grid_splitting``.
Every splitting is an int32 array, 1 at C points and 0 at F points.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..amg_core import rs_cf_splitting
from ..util.utils import to_csr

__all__ = ["RS", "PMIS", "PMISc", "CLJP", "CLJPc", "MIS", "grid_splitting",
           "preprocess_strength"]

F_NODE, C_NODE, U_NODE = 0, 1, -1


def grid_splitting(grid):
    """Red-black coarsening of a structured grid: C points where the sum
    of the coordinates is even.  Returns ``(splitting, None)``: the C set
    is a rotated lattice, not a rectangular grid."""
    grid = tuple(int(g) for g in grid)
    coords = np.unravel_index(np.arange(int(np.prod(grid))), grid)
    parity = np.zeros(int(np.prod(grid)), dtype=np.int64)
    for c in coords:
        parity += c
    return ((parity % 2) == 0).astype(np.int32), None


def preprocess_strength(S):
    """``(S2, S2.T)``: the strength pattern without its diagonal (1-byte
    placeholder values; the order of the entries in each row kept, since
    the RS traversal observes it) and its transpose."""
    S = to_csr(S)
    n = S.shape[0]
    rows = np.repeat(np.arange(n, dtype=S.indices.dtype), np.diff(S.indptr))
    offd = S.indices != rows
    removed = np.bincount(rows[~offd], minlength=n)
    indptr = (S.indptr - np.concatenate([[0], np.cumsum(removed)])).astype(
        S.indptr.dtype, copy=False)
    S2 = sp.csr_matrix((np.ones(int(offd.sum()), dtype=np.uint8),
                        S.indices[offd], indptr), shape=S.shape)
    if S.has_sorted_indices:
        S2.has_sorted_indices = True
    return S2, S2.T.tocsr()


def RS(S):
    """Ruge-Stuben first-pass splitting: the undecided node of largest
    weight (its count of undecided and F dependants) becomes C, the
    undecided nodes depending on it become F and each of their undecided
    dependencies gains weight, its own undecided dependencies lose one.

    Examples
    --------
    >>> import numpy as np
    >>> from pyamg_tpu_torch.gallery import poisson
    >>> from pyamg_tpu_torch.strength import classical_strength_of_connection
    >>> S = classical_strength_of_connection(poisson((8, 8), format='csr'),
    ...                                      theta=0.25)
    >>> sorted(np.unique(RS(S)).tolist())
    [0, 1]
    """
    S, T = preprocess_strength(S)
    native = rs_cf_splitting(S, T)
    if native is not None:
        return native
    # the compiled form's interval lists, move for move: the order of the
    # ties and of the re-weighted nodes shapes the deeper coarse grids
    n = S.shape[0]
    Sp, Sj = S.indptr, S.indices
    Tp, Tj = T.indptr, T.indices
    lam = np.diff(T.indptr).astype(np.int64)

    ivl_start = np.zeros(n + 2, dtype=np.int64)
    ivl_len = np.zeros(n + 2, dtype=np.int64)
    at_pos = np.empty(n, dtype=np.int64)
    pos_of = np.empty(n, dtype=np.int64)
    np.add.at(ivl_len, lam, 1)
    acc = 0
    for v in range(n + 1):
        ivl_start[v] = acc
        acc += ivl_len[v]
        ivl_len[v] = 0
    for i in range(n):
        p = ivl_start[lam[i]] + ivl_len[lam[i]]
        ivl_len[lam[i]] += 1
        at_pos[p] = i
        pos_of[i] = p

    splitting = np.full(n, U_NODE, dtype=np.int32)
    splitting[lam == 0] = F_NODE

    def swap_nodes(pa, pb):
        pos_of[at_pos[pa]] = pb
        pos_of[at_pos[pb]] = pa
        at_pos[pa], at_pos[pb] = at_pos[pb], at_pos[pa]

    for scan in range(n - 1, -1, -1):
        i = at_pos[scan]
        ivl_len[lam[i]] -= 1
        if splitting[i] == F_NODE:
            continue
        splitting[i] = C_NODE
        for j in Tj[Tp[i]:Tp[i + 1]]:
            if splitting[j] != U_NODE:
                continue
            splitting[j] = F_NODE
            for k in Sj[Sp[j]:Sp[j + 1]]:
                if splitting[k] != U_NODE or lam[k] >= n - 1:
                    continue
                lv = lam[k]
                tail = ivl_start[lv] + ivl_len[lv] - 1
                swap_nodes(pos_of[k], tail)
                ivl_len[lv] -= 1
                ivl_len[lv + 1] += 1
                ivl_start[lv + 1] = tail
                lam[k] += 1
        for j in Sj[Sp[i]:Sp[i + 1]]:
            if splitting[j] != U_NODE or lam[j] == 0:
                continue
            lv = lam[j]
            head = ivl_start[lv]
            swap_nodes(pos_of[j], head)
            ivl_len[lv] -= 1
            ivl_len[lv - 1] += 1
            ivl_start[lv] += 1
            ivl_start[lv - 1] = ivl_start[lv] - ivl_len[lv - 1]
            lam[j] -= 1

    return (splitting == C_NODE).astype(np.int32)


def _edges(S):
    return np.repeat(np.arange(S.shape[0]), np.diff(S.indptr)), S.indices


def PMIS(S, seed=0):
    """Parallel modified independent set splitting: weights
    ``lambda + U[0, 1)`` from ``seed``."""
    S, T = preprocess_strength(S)
    weights = np.diff(T.indptr).astype(np.float64) \
        + np.random.default_rng(seed).random(S.shape[0])
    return _weighted_mis_splitting(S, T, weights)


def PMISc(S, method="JP"):
    """PMIS with deterministic weights from a vertex coloring."""
    from ..graph import vertex_coloring

    S, T = preprocess_strength(S)
    coloring = vertex_coloring(S, method=method)
    weights = np.diff(T.indptr).astype(np.float64) \
        + (coloring + 1) / (coloring.max() + 2.0)
    return _weighted_mis_splitting(S, T, weights)


def _weighted_mis_splitting(S, T, weights):
    """Rounds over the symmetrized strength graph: an undecided node
    heavier than all its undecided neighbours becomes C (the heaviest one
    when no node is), then the undecided neighbours of new C points become
    F.  Nodes without any strong connection are F."""
    n = S.shape[0]
    state = np.full(n, U_NODE, dtype=np.int32)
    state[(np.diff(S.indptr) == 0) & (np.diff(T.indptr) == 0)] = F_NODE
    rs, cs = _edges(S)
    rt, ct = _edges(T)
    rows = np.concatenate([rs, rt])
    cols = np.concatenate([cs, ct])
    while (state == U_NODE).any():
        active = state == U_NODE
        w = np.where(active, weights, -np.inf)
        nbr_max = np.full(n, -np.inf)
        emask = active[rows] & active[cols]
        np.maximum.at(nbr_max, rows[emask], w[cols[emask]])
        winners = active & (w > nbr_max)
        if not winners.any():
            winners = np.zeros(n, dtype=bool)
            winners[int(np.argmax(np.where(active, w, -np.inf)))] = True
        state[winners] = C_NODE
        newF = np.zeros(n, dtype=bool)
        newF[cols[winners[rows]]] = True
        state[newF & (state == U_NODE)] = F_NODE
    return (state == C_NODE).astype(np.int32)


def CLJP(S, color=False, seed=2448422):
    """Cleary-Luby-Jones-Plassmann splitting: rounds of independent sets
    of the heaviest undecided nodes (weights ``U[0, 1)`` from ``seed``, or
    a coloring's with ``color``, plus the number of dependants); each new C
    point takes a unit of weight from the undecided nodes it depends on and
    from those that share a dependant with it, and a node below weight 1
    becomes F."""
    S, T = preprocess_strength(S)
    n = S.shape[0]
    Sp, Sj = S.indptr, S.indices
    Tp, Tj = T.indptr, T.indices

    rng = np.random.default_rng(seed)
    if color:
        from ..graph import vertex_coloring

        coloring = vertex_coloring(S, method="JP")
        weight = coloring.astype(np.float64) / (coloring.max() + 1)
    else:
        weight = rng.random(n)
    weight = weight + np.diff(Tp)

    splitting = np.full(n, U_NODE, dtype=np.int32)
    edgemark = np.ones(S.nnz, dtype=bool)
    rows_S, cols_S = _edges(S)
    c_dep = np.full(n, -1, dtype=np.int64)

    unassigned = n
    while unassigned > 0:
        active = splitting == U_NODE
        w = np.where(active, weight, -np.inf)
        nbr_max = np.full(n, -np.inf)
        for rows, cols in ((rows_S, cols_S), _edges(T)):
            m = active[rows] & active[cols]
            np.maximum.at(nbr_max, rows[m], w[cols[m]])
        D = active & (w > nbr_max)
        if not D.any():
            D = np.zeros(n, dtype=bool)
            D[int(np.argmax(np.where(active, w, -np.inf)))] = True
        Dlist = np.flatnonzero(D)
        splitting[Dlist] = C_NODE
        unassigned -= Dlist.size

        # undecided j that a new C point depends on lose weight
        for c in Dlist:
            for jj in range(Sp[c], Sp[c + 1]):
                j = Sj[jj]
                if splitting[j] == U_NODE and edgemark[jj]:
                    edgemark[jj] = False
                    weight[j] -= 1
                    if weight[j] < 1:
                        splitting[j] = F_NODE
                        unassigned -= 1

        # j and k both depend on c and j depends on k: k loses weight
        for c in Dlist:
            dep = Tj[Tp[c]:Tp[c + 1]]
            c_dep[dep[splitting[dep] == U_NODE]] = c
            for j in dep:
                for kk in range(Sp[j], Sp[j + 1]):
                    k = Sj[kk]
                    if (splitting[k] == U_NODE and edgemark[kk]
                            and c_dep[k] == c):
                        edgemark[kk] = False
                        weight[k] -= 1
                        if weight[k] < 1:
                            splitting[k] = F_NODE
                            unassigned -= 1

    splitting[splitting == U_NODE] = F_NODE
    return splitting.astype(np.int32)


def CLJPc(S):
    """CLJP with deterministic weights from a vertex coloring."""
    return CLJP(S, color=True)


def MIS(S, weights=None, seed=0):
    """Maximal independent set splitting, by ``weights`` (default:
    ``lambda + U[0, 1)`` from ``seed``)."""
    S, T = preprocess_strength(S)
    if weights is None:
        weights = np.diff(T.indptr) \
            + np.random.default_rng(seed).random(S.shape[0])
    return _weighted_mis_splitting(S, T, np.asarray(weights, dtype=float))
