"""Setup utilities (host side): option decoding, diagonal and block-diagonal
extraction, row filters and the relaxation-as-operator wrapper.

Port of the parts of ``pyamg_tpu/util/utils.py`` that the smoothed
aggregation setups use, plus the numpy/torch dtype conversions the port
needs.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

__all__ = ["unpack_arg", "to_csr", "get_diagonal", "get_block_diag",
           "amalgamate", "scale_rows", "row_reduce",
           "scale_rows_by_largest_entry", "filter_matrix_rows", "coord2rbm",
           "eliminate_diag_dom_nodes", "relaxation_as_linear_operator",
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


def get_block_diag(A, blocksize, inv_flag=True):
    """(n/bs, bs, bs) array of the diagonal blocks of A, pseudo-inverted
    block by block when ``inv_flag``.  A BSR input of that blocksize is
    used as it is."""
    n = A.shape[0]
    bs = int(blocksize)
    if n % bs:
        raise ValueError("matrix dimension must be divisible by blocksize")
    nb = n // bs
    if sp.issparse(A) and A.format == "bsr" and A.blocksize == (bs, bs):
        B = A
    else:
        B = sp.bsr_matrix(to_csr(A), blocksize=(bs, bs))
    blocks = np.zeros((nb, bs, bs), dtype=A.dtype)
    brows = np.repeat(np.arange(nb), np.diff(B.indptr))
    isdiag = B.indices == brows
    # add.at: a non-canonical BSR may store the same block twice
    np.add.at(blocks, brows[isdiag], B.data[isdiag])
    if inv_flag:
        from .linalg import pinv_array

        return pinv_array(blocks)
    return blocks


def amalgamate(A, blocksize):
    """The block-connectivity graph of a blocked matrix: one unit entry per
    nonzero block."""
    if blocksize == 1:
        return to_csr(A)
    B = sp.bsr_matrix(to_csr(A), blocksize=(blocksize, blocksize))
    nb = B.shape[0] // blocksize
    data = np.ones(B.indices.shape[0], dtype=A.dtype)
    return sp.csr_matrix((data, B.indices.copy(), B.indptr.copy()),
                         shape=(nb, nb))


def scale_rows(A, v, copy=True):
    """diag(v) A as CSR."""
    A = A.tocsr() if sp.issparse(A) else sp.csr_matrix(A)
    if copy:
        A = A.copy()
    A.data *= np.repeat(np.asarray(v).ravel(), np.diff(A.indptr))
    return A


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


def coord2rbm(coords, numPDEs=None):
    """Rigid body modes from node coordinates.

    2D -> 3 modes (2 translations + 1 rotation), 3D -> 6 modes.
    """
    coords = np.asarray(coords, dtype=float)
    n, d = coords.shape
    if numPDEs is None:
        numPDEs = d
    if d == 1 or numPDEs == 1:
        return np.ones((n * numPDEs, 1))
    if d == 2:
        B = np.zeros((2 * n, 3))
        B[0::2, 0] = 1
        B[1::2, 1] = 1
        B[0::2, 2] = -coords[:, 1]
        B[1::2, 2] = coords[:, 0]
        return B
    if d == 3:
        B = np.zeros((3 * n, 6))
        for k in range(3):
            B[k::3, k] = 1
        x, y, z = coords[:, 0], coords[:, 1], coords[:, 2]
        # rotations about z, y, x
        B[0::3, 3], B[1::3, 3] = -y, x
        B[0::3, 4], B[2::3, 4] = z, -x
        B[1::3, 5], B[2::3, 5] = -z, y
        return B
    raise ValueError("coords must be (n, 1|2|3)")


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


def filter_matrix_rows(A, theta, diagonal=False, lump=False):
    """Drop entries with ``|A_ij| < theta * max_k |A_ik|`` (the maximum over
    off-diagonal entries); with ``lump`` the dropped mass goes onto the
    diagonal, so that row sums stay."""
    A = to_csr(A).copy()
    n = A.shape[0]
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    offdiag = rows != A.indices
    rowmax = row_reduce(np.abs(A.data) * offdiag, A.indptr, np.maximum, 0.0)
    keep = (np.abs(A.data) >= theta * rowmax[rows]) | (rows == A.indices)
    if not diagonal:
        keep |= ~offdiag
    dropped = A.data * (~keep)
    A.data = np.where(keep, A.data, 0)
    if lump:
        lumped = row_reduce(dropped, A.indptr, np.add, 0.0)
        A = (A + sp.dia_matrix((lumped[None, :], [0]),
                               shape=A.shape)).tocsr()
    A.eliminate_zeros()
    return A


def eliminate_diag_dom_nodes(A, C, theta=1.02):
    """Isolate strongly diagonally dominant rows in the strength graph C
    (they need no coarse representation): their rows and columns are
    zeroed, their diagonal kept."""
    A = to_csr(A)
    C = to_csr(C).copy()
    n = A.shape[0]
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    offdiag_sum = row_reduce(np.abs(A.data) * (rows != A.indices),
                             A.indptr, np.add, 0.0)
    dom = np.abs(A.diagonal()) > theta * offdiag_sum
    if not dom.any():
        return C
    crows = np.repeat(np.arange(n), np.diff(C.indptr))
    keep = ~(dom[crows] | dom[C.indices]) | (crows == C.indices)
    C.data = np.where(keep, C.data, 0)
    C.eliminate_zeros()
    return C


def relaxation_as_linear_operator(method, A, b):
    """A scipy ``LinearOperator`` that applies one pass of a host
    relaxation method (``relaxation.relaxation``) on ``A x = b`` from the
    given x.  ``improve_candidates`` applies it to B, which relaxes each
    candidate against ``A x = 0``.  A name the host module does not have
    (a device-only smoother) means symmetric Gauss-Seidel."""
    from scipy.sparse.linalg import LinearOperator

    from ..relaxation import relaxation as rel

    fn_name, kwargs = unpack_arg(method)
    if not hasattr(rel, fn_name):
        fn_name, kwargs = "gauss_seidel", {"sweep": "symmetric"}
    fn = getattr(rel, fn_name)
    b = np.asarray(b)

    def matvec(x):
        x = np.array(x, dtype=A.dtype, copy=True)
        fn(A, x, b, **kwargs)
        return x

    return LinearOperator(A.shape, matvec, dtype=A.dtype)
