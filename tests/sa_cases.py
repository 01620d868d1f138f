"""Operators and comparisons shared by the tests of the port's default
smoothed-aggregation path (``test_torch_relaxation.py``,
``test_torch_default_sa.py``, ``test_torch_cycles.py``)."""

import numpy as np
import scipy.sparse as sp
from scipy.spatial import cKDTree


def unstructured(n=400, seed=0, radius=0.09):
    """Graph Laplacian (plus a small shift) of a random geometric graph in
    the unit square: an unstructured mesh-like operator."""
    pts = np.random.default_rng(seed).random((n, 2))
    pairs = cKDTree(pts).query_pairs(radius, output_type="ndarray")
    W = sp.coo_matrix((np.ones(len(pairs)), (pairs[:, 0], pairs[:, 1])),
                      shape=(n, n))
    W = (W + W.T).tocsr()
    L = sp.csr_matrix(sp.diags(np.asarray(W.sum(axis=1)).ravel() + 0.01) - W)
    L.sort_indices()
    return L


def blocked(n_nodes=40, seed=1):
    """A 2x2-blocked SPD operator: the Kronecker product of a graph
    Laplacian with a small SPD block, plus a random block diagonal."""
    L = unstructured(n_nodes, seed, radius=0.3)
    rng = np.random.default_rng(seed)
    A = sp.kron(L, np.array([[2.0, 0.5], [0.5, 1.0]])).tolil()
    for i in range(n_nodes):
        M = rng.standard_normal((2, 2))
        A[2 * i:2 * i + 2, 2 * i:2 * i + 2] += M @ M.T
    A = sp.csr_matrix(A)
    A.sort_indices()
    return A


ARRAYS = ("dinv", "color_masks", "block_dinv", "color_rows", "color_cols",
          "color_data")


def assert_same_smoother(sm, jsm):
    assert (sm.kind, sm.sweep, sm.iterations, sm.blocksize) == \
        (jsm.kind, jsm.sweep, jsm.iterations, jsm.blocksize)
    np.testing.assert_allclose(sm.omega, jsm.omega, rtol=1e-12)
    np.testing.assert_allclose(sm.coefficients, jsm.coefficients, rtol=1e-12)
    for name in ARRAYS:
        a, ja = getattr(sm, name), getattr(jsm, name)
        assert (a is None) == (ja is None), name
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-12,
                                       err_msg=name)
