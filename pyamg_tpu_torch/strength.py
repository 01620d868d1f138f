"""Strength of connection (host, numpy/scipy).

Port of ``symmetric_strength_of_connection`` from ``pyamg_tpu/strength.py``
for scalar (CSR) operators.  The block (BSR) form and the classical,
evolution, energy, distance and algebraic measures are not ported yet.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .util.utils import not_ported, scale_rows_by_largest_entry, to_csr

__all__ = ["symmetric_strength_of_connection"]


def symmetric_strength_of_connection(A, theta=0):
    """Keep ``|A_ij| >= theta * sqrt(|A_ii| |A_jj|)`` and the diagonal;
    returns ``|A|`` on that pattern with each row scaled so that its
    largest entry is 1.

    Examples
    --------
    >>> from pyamg_tpu_torch.gallery import poisson
    >>> S = symmetric_strength_of_connection(poisson((4, 4), format='csr'))
    >>> S.nnz
    64
    """
    if theta < 0:
        raise ValueError("expected a positive theta")
    if sp.issparse(A) and A.format == "bsr" and A.blocksize[0] > 1:
        raise not_ported("symmetric strength of a block (BSR) operator",
                         "the unstructured SA chain")
    A = to_csr(A)
    n = A.shape[0]
    d = np.abs(A.diagonal())
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    thresh = theta * np.sqrt(d[rows] * d[A.indices])
    keep = (rows == A.indices) | (np.abs(A.data) >= thresh)
    S = A.copy()
    S.data = np.where(keep, A.data, 0)
    S.eliminate_zeros()
    S.data = np.abs(S.data)
    return scale_rows_by_largest_entry(S)
