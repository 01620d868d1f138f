"""Strength of connection (host, numpy/scipy).

Port of ``symmetric_strength_of_connection`` and
``classical_strength_of_connection`` from ``pyamg_tpu/strength.py`` for
scalar (CSR) operators.  The block (BSR) forms and the evolution, energy,
distance and algebraic measures are not ported yet.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .amg_core import classical_strength_native
from .util.utils import (not_ported, row_reduce,
                         scale_rows_by_largest_entry, to_csr)

__all__ = ["symmetric_strength_of_connection",
           "classical_strength_of_connection"]


def _scalar_csr(A, what):
    if sp.issparse(A) and A.format == "bsr" and A.blocksize[0] > 1:
        raise not_ported(f"{what} strength of a block (BSR) operator",
                         "the unstructured SA chain")
    return to_csr(A)


def classical_strength_of_connection(A, theta=0.0):
    """Keep ``|A_ij| >= theta * max_{k != i} |A_ik|`` and the diagonal;
    returns ``|A|`` on that pattern with each row scaled so that its
    largest entry is 1.

    Examples
    --------
    >>> from pyamg_tpu_torch.gallery import poisson
    >>> A = poisson((4, 4), format='csr')
    >>> classical_strength_of_connection(A, theta=0.25).nnz == A.nnz
    True
    """
    if theta < 0 or theta > 1:
        raise ValueError("expected theta in [0,1]")
    A = _scalar_csr(A, "classical")
    A.sort_indices()
    S = classical_strength_native(A, theta)
    if S is not None:
        return S
    n = A.shape[0]
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    offdiag = rows != A.indices
    rowmax = row_reduce(np.abs(A.data) * offdiag, A.indptr, np.maximum, 0.0)
    keep = (~offdiag) | (np.abs(A.data) >= theta * rowmax[rows])
    S = A.copy()
    S.data = np.where(keep, A.data, 0)
    S.eliminate_zeros()
    S.data = np.abs(S.data)
    return scale_rows_by_largest_entry(S)


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
    A = _scalar_csr(A, "symmetric")
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
