"""Weighted graph matchings of pairwise aggregation (host).

Port of ``pyamg_tpu/aggregation/matching.py``: the Drake-Hougardy
path-growing matching (compiled in ``amg_core`` where the library loaded),
Preis's locally heaviest edges and Notay's strongest negative couplings,
with the JAX package's visiting orders and tie rules.  Each returns the
partner of every node, -1 where unmatched.

Examples
--------
>>> import numpy as np
>>> from pyamg_tpu_torch.gallery import poisson
>>> p = drake_matching(poisson((6, 6), format='csr'))
>>> bool(((p == -1) | (p[p] == np.arange(p.size))).all())
True
"""

from __future__ import annotations

import numpy as np

from ..amg_core import drake_matching_native
from ..util.utils import to_csr

__all__ = ["drake_matching", "preis_matching", "notay_matching",
           "preis_matching_1999", "notay_matching_2010"]


def drake_matching(A, weights=None, **kwargs):
    """Drake and Hougardy's path-growing 1/2-approximation: from each
    unused node in turn, walk along the heaviest edge to an unused node,
    taking every other edge; of the covers grown from the nodes in
    ascending and in descending order, the heavier.  Weights default to
    |A|."""
    A = to_csr(A)
    native = drake_matching_native(A, weights)
    if native is not None:
        return native
    n = A.shape[0]
    indptr, indices = A.indptr.tolist(), A.indices.tolist()
    w = (np.abs(A.data) if weights is None else np.asarray(weights)).tolist()

    def grow(start_order):
        used = [False] * n
        match = np.full(n, -1, dtype=np.int64)
        total = 0.0
        for s in start_order:
            if used[s]:
                continue
            x, take = s, True
            while True:
                used[x] = True
                best_j, best_w = -1, -1.0
                for k in range(indptr[x], indptr[x + 1]):
                    j = indices[k]
                    if j != x and not used[j] and w[k] > best_w:
                        best_j, best_w = j, w[k]
                if best_j < 0:
                    break
                if take:
                    match[x], match[best_j] = best_j, x
                    total += best_w
                take = not take
                x = best_j
        return match, total

    m1, t1 = grow(range(n))
    m2, t2 = grow(range(n - 1, -1, -1))
    return m1 if t1 >= t2 else m2


def preis_matching(A, weights=None, **kwargs):
    """Preis's locally heaviest 1/2-approximation: the edges in the order
    of ``np.argsort(-w)``, each taken when both its ends are free.
    Weights default to |A|."""
    A = to_csr(A)
    n = A.shape[0]
    w = np.abs(A.data) if weights is None else np.asarray(weights)
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    order = np.argsort(-w)
    match = np.full(n, -1, dtype=np.int64)
    matched = [False] * n
    for i, j in zip(rows[order].tolist(), A.indices[order].tolist()):
        if i == j or matched[i] or matched[j]:
            continue
        match[i], match[j] = j, i
        matched[i] = matched[j] = True
    return match


def notay_matching(A, beta=0.25, **kwargs):
    """Notay's pairwise aggregation by strong negative couplings: the
    nodes in the order of ``np.argsort`` of their row lengths, each free
    node pairing with its most negative free neighbour among those below
    ``beta`` times its most negative coupling."""
    A = to_csr(A)
    n = A.shape[0]
    indptr, indices = A.indptr.tolist(), A.indices.tolist()
    data = np.real(A.data).tolist()
    match = np.full(n, -1, dtype=np.int64)
    matched = [False] * n
    for i in np.argsort(np.diff(A.indptr)).tolist():
        if matched[i]:
            continue
        row = range(indptr[i], indptr[i + 1])
        neg_min = min([0.0] + [data[k] for k in row if indices[k] != i])
        best_j, best_v = -1, 0.0
        for k in row:
            j = indices[k]
            if j == i or matched[j]:
                continue
            v = data[k]
            if v < beta * neg_min and v < best_v:
                best_j, best_v = j, v
        if best_j >= 0:
            match[i], match[best_j] = best_j, i
            matched[best_j] = True
        matched[i] = True
    return match


# the reference's names
preis_matching_1999 = preis_matching
notay_matching_2010 = notay_matching
