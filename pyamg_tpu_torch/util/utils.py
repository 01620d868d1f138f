"""Setup utilities (host side): option decoding and diagonal extraction.

Port of the parts of ``pyamg_tpu/util/utils.py`` that the structured SA
path uses, plus the numpy/torch dtype conversions the port needs.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

__all__ = ["unpack_arg", "to_csr", "get_diagonal", "row_reduce",
           "scale_rows_by_largest_entry",
           "levelize_strength_or_aggregation",
           "levelize_smooth_or_improve_candidates", "numpy_dtype",
           "torch_dtype", "not_ported"]


def not_ported(what, item):
    """The error raised where a setup or solve leaves the ported slice;
    ``item`` names the ROADMAP.md Queue 1 entry that ports it."""
    return NotImplementedError(
        f"{what} is not ported to pyamg_tpu_torch yet (ROADMAP.md, Queue 1: "
        f"{item})")


def numpy_dtype(dtype):
    """numpy dtype of a numpy or torch dtype (None stays None)."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def torch_dtype(dtype):
    """torch dtype of a numpy or torch dtype (None stays None)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype


def unpack_arg(v):
    """Decode the ``(name, kwargs)`` option pattern used throughout the
    API."""
    if isinstance(v, tuple):
        return v[0], dict(v[1])
    return v, {}


def to_csr(A):
    """Coerce a scipy matrix (any format) or a dense array to CSR."""
    if sp.issparse(A):
        return A.tocsr()
    return sp.csr_matrix(np.asarray(A))


def get_diagonal(A, inv=False):
    """Diagonal of A, optionally inverted with zeros preserved."""
    d = np.asarray(to_csr(A).diagonal()).ravel()
    if inv:
        mask = d != 0
        dinv = np.zeros_like(d)
        dinv[mask] = 1.0 / d[mask]
        return dinv
    return d


def row_reduce(vals, indptr, ufunc, empty=0.0):
    """Per-CSR-row reduction of ``vals`` (length nnz) with ``ufunc``
    (e.g. ``np.maximum``); rows with no entries get ``empty``."""
    n = len(indptr) - 1
    out = np.full(n, empty, dtype=vals.dtype)
    if vals.size and n:
        nz = np.diff(indptr) > 0
        out[nz] = ufunc.reduceat(vals, indptr[:-1][nz])
    return out


def scale_rows_by_largest_entry(A):
    """Scale each row of A so that its largest-magnitude entry is 1."""
    A = to_csr(A).copy()
    rowmax = row_reduce(np.abs(A.data), A.indptr, np.maximum, 0.0)
    scale = np.where(rowmax != 0, 1.0 / np.where(rowmax != 0, rowmax, 1), 0.0)
    A.data = A.data * np.repeat(scale, np.diff(A.indptr))
    return A


def _is_single_option(v):
    """True when v is one (name, kwargs) option rather than a per-level
    sequence."""
    if isinstance(v, str) or v is None:
        return True
    return (isinstance(v, tuple) and len(v) == 2 and isinstance(v[0], str)
            and isinstance(v[1], dict))


def levelize_strength_or_aggregation(to_levelize, max_levels, max_coarse):
    """Expand a strength/aggregation option into a per-level list."""
    if _is_single_option(to_levelize):
        return max_levels, max_coarse, [to_levelize] * max(max_levels - 1, 1)
    if isinstance(to_levelize, (list, tuple)):
        to_levelize = list(to_levelize)
        if len(to_levelize) < max_levels - 1:
            to_levelize = to_levelize + \
                [to_levelize[-1]] * (max_levels - 1 - len(to_levelize))
        return max_levels, max_coarse, to_levelize
    raise ValueError(f"invalid option {to_levelize!r}")


def levelize_smooth_or_improve_candidates(to_levelize, max_levels):
    """Expand a smoother/improve_candidates option into a per-level list."""
    if _is_single_option(to_levelize):
        return [to_levelize] * max_levels
    if isinstance(to_levelize, (list, tuple)):
        to_levelize = list(to_levelize)
        if len(to_levelize) < max_levels:
            to_levelize = to_levelize + \
                [to_levelize[-1]] * (max_levels - len(to_levelize))
        return to_levelize
    raise ValueError(f"invalid option {to_levelize!r}")
