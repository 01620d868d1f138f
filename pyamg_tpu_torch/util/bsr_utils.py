"""BSR row access helpers: read or overwrite the stored entries of one
scalar row of a scipy BSR matrix.

Port of ``pyamg_tpu/util/bsr_utils.py``.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["bsr_get_row", "bsr_row_write_scalar", "bsr_row_write_vector",
           "BSR_Get_Row", "BSR_Row_WriteScalar", "BSR_Row_WriteVect"]


def _row_block(A, i):
    if not (sp.issparse(A) and A.format == "bsr"):
        raise TypeError("expected BSR matrix")
    bs = A.blocksize[0]
    brow = i // bs
    return brow, i % bs, A.indptr[brow], A.indptr[brow + 1]


def bsr_get_row(A, i):
    """``(values, col_indices)`` of the nonzero entries of scalar row i of
    the BSR matrix A."""
    _brow, local, s, e = _row_block(A, i)
    bsc = A.blocksize[1]
    vals = A.data[s:e, local, :].reshape(-1)
    cols = (A.indices[s:e][:, None] * bsc +
            np.arange(bsc)[None, :]).reshape(-1)
    nz = vals != 0
    return vals[nz], cols[nz]


def bsr_row_write_scalar(A, i, value):
    """Set every stored entry of scalar row i to ``value`` (in place)."""
    _brow, local, s, e = _row_block(A, i)
    A.data[s:e, local, :] = value
    return A


def bsr_row_write_vector(A, i, values):
    """Overwrite the stored entries of scalar row i with ``values`` (one per
    stored scalar entry of the row), in place."""
    _brow, local, s, e = _row_block(A, i)
    A.data[s:e, local, :] = np.asarray(values).reshape(e - s,
                                                       A.blocksize[1])
    return A


# the reference's names
BSR_Get_Row = bsr_get_row
BSR_Row_WriteScalar = bsr_row_write_scalar
BSR_Row_WriteVect = bsr_row_write_vector
