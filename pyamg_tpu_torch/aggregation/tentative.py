"""Tentative prolongator: per-aggregate normalization of the near-nullspace.

Port of the single-candidate branch of ``fit_candidates``
(``pyamg_tpu/aggregation/tentative.py``): with one candidate and one dof per
node, the per-aggregate QR is a column normalization done by one bincount.
Multi-candidate and node-blocked inputs are not ported yet.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..util.utils import not_ported

__all__ = ["fit_candidates"]


def fit_candidates(AggOp, B, tol=1e-10):
    """Fit the near-nullspace candidate B into the aggregate structure.

    Returns (T, coarse_B): T (n_dof, n_agg) has unit-norm columns and
    ``T @ coarse_B`` reproduces B on aggregated rows.

    Examples
    --------
    >>> import numpy as np
    >>> import scipy.sparse as sp
    >>> AggOp = sp.csr_matrix(np.array([[1., 0], [1, 0], [0, 1], [0, 1]]))
    >>> T, Bc = fit_candidates(AggOp, np.ones((4, 1)))
    >>> bool(np.allclose(T @ Bc, 1.0))
    True
    """
    AggOp = sp.csr_matrix(AggOp)
    B = np.asarray(B)
    if B.ndim == 1:
        B = B[:, None]
    n_nodes, n_agg = AggOp.shape
    nnz_row = np.diff(AggOp.indptr)
    if B.shape != (n_nodes, 1) or nnz_row.max(initial=0) > 1:
        raise not_ported("fit_candidates beyond one candidate, one dof per "
                         "node and disjoint aggregates",
                         "the unstructured SA chain")
    agg_of = AggOp.indices
    vals = np.ravel(B)[nnz_row.astype(bool)]
    nrm = np.sqrt(np.bincount(agg_of, weights=np.abs(vals) ** 2,
                              minlength=n_agg))
    keep = nrm > tol * max(nrm.max(initial=0.0), 1e-300)
    safe = np.where(keep, nrm, 1.0)
    data = vals / safe[agg_of] * keep[agg_of]
    T = sp.csr_matrix((data.astype(B.dtype), AggOp.indices, AggOp.indptr),
                      shape=(n_nodes, n_agg))
    Bc = (nrm * keep).astype(B.dtype)[:, None]
    return T, Bc
