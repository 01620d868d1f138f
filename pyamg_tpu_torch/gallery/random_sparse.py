"""Random sparse matrices.  Port of ``pyamg_tpu/gallery/random_sparse.py``
(numpy, unchanged)."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["sprand"]


def sprand(m, n, density, format="csr", seed=None):
    """Random sparse matrix with approximately ``density`` fill fraction and
    uniform [0,1) values."""
    m, n = int(m), int(n)
    if density < 0 or density > 1:
        raise ValueError("density must be in [0, 1]")
    rng = np.random.default_rng(seed)
    nnz = int(round(density * m * n))
    rows = rng.integers(0, m, size=nnz)
    cols = rng.integers(0, n, size=nnz)
    vals = rng.random(nnz)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(m, n))
    A.sum_duplicates()
    return A.asformat(format)
