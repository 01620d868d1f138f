"""Setup utilities (host side): option decoding, diagonal and block-diagonal
extraction, row filters and the relaxation-as-operator wrapper.

Port of the parts of ``pyamg_tpu/util/utils.py`` that the smoothed
aggregation, root-node and adaptive setups use (among them the root-node
bookkeeping ``get_Cpt_params`` and ``scale_T``, and the filters of energy
smoothing), plus the numpy/torch dtype conversions the port needs.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

__all__ = ["unpack_arg", "to_csr", "get_diagonal", "get_block_diag",
           "amalgamate", "unamal", "blocksize", "compute_BtBinv",
           "scale_rows", "scale_columns", "symmetric_rescaling",
           "row_reduce", "scale_rows_by_largest_entry", "filter_matrix_rows",
           "filter_matrix_columns", "truncate_rows", "filter_operator",
           "scale_T", "get_Cpt_params", "coord2rbm",
           "eliminate_diag_dom_nodes", "host_relaxation",
           "relaxation_as_linear_operator",
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
    """Coerce a scipy matrix (any format), a dense array, or a block device
    operator (``SparseBDIA``, ``BlockELL``) to CSR."""
    from ..sparse import BlockELL, SparseBDIA

    if isinstance(A, (BlockELL, SparseBDIA)):
        return A.to_scipy().tocsr()
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


def unamal(A, rows, cols):
    """Expand each stored entry of A into a (rows, cols) block of ones (the
    structure only)."""
    A = to_csr(A)
    blocks = np.ones((A.nnz, rows, cols))
    return sp.bsr_matrix((blocks, A.indices, A.indptr),
                         shape=(A.shape[0] * rows,
                                A.shape[1] * cols)).tocsr()


def blocksize(A):
    """Block size of a BSR matrix (1 for anything else)."""
    return A.blocksize[0] if sp.issparse(A) and A.format == "bsr" else 1


def compute_BtBinv(B, sparsity):
    """Per-row Gram pseudo-inverses: for each row i of the sparsity
    pattern, ``pinv(B[cols(i)]^H B[cols(i)])``, shape (n, k, k).  The Grams
    come from the compiled library for real float64 B, else from one padded
    batched einsum."""
    from ..amg_core import pattern_gram_native
    from .linalg import pinv_array

    S = to_csr(sparsity)
    B = np.asarray(B)
    k = B.shape[1]
    n = S.shape[0]
    nnz_row = np.diff(S.indptr)
    L = int(nnz_row.max()) if n else 0
    if L == 0:
        return np.zeros((n, k, k), dtype=B.dtype)
    if B.dtype == np.float64:
        gram = pattern_gram_native(S.indptr, S.indices, B)
        if gram is not None:
            return pinv_array(gram)
    rows = np.repeat(np.arange(n), nnz_row)
    offs = np.arange(S.nnz) - np.repeat(S.indptr[:-1], nnz_row)
    cols = np.zeros((n, L), dtype=np.int64)
    valid = np.zeros((n, L), dtype=bool)
    cols[rows, offs] = S.indices
    valid[rows, offs] = True
    Bp = B[cols] * valid[:, :, None]            # (n, L, k)
    gram = np.einsum("nlj,nlk->njk", Bp.conj(), Bp)
    return pinv_array(gram)


def scale_rows(A, v, copy=True):
    """diag(v) A as CSR."""
    A = A.tocsr() if sp.issparse(A) else sp.csr_matrix(A)
    if copy:
        A = A.copy()
    A.data *= np.repeat(np.asarray(v).ravel(), np.diff(A.indptr))
    return A


def scale_columns(A, v, copy=True):
    """A diag(v) as CSR."""
    A = A.tocsr() if sp.issparse(A) else sp.csr_matrix(A)
    if copy:
        A = A.copy()
    A.data *= np.asarray(v).ravel()[A.indices]
    return A


def symmetric_rescaling(A, copy=True):
    """``(D_sqrt, D_sqrt_inv, D^-1/2 A D^-1/2)`` with ``D = |diag(A)|``;
    the row and column of a zero diagonal entry become zero (its
    ``D_sqrt_inv`` entry is 0)."""
    d = np.asarray(A.diagonal()).ravel()
    mask = d != 0
    d_sqrt = np.sqrt(np.abs(d))
    d_sqrt_inv = np.zeros_like(d_sqrt)
    d_sqrt_inv[mask] = 1.0 / d_sqrt[mask]
    DAD = scale_rows(scale_columns(A, d_sqrt_inv, copy=copy), d_sqrt_inv,
                     copy=False)
    return d_sqrt, d_sqrt_inv, DAD


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


def filter_matrix_columns(A, theta):
    """The column form of :func:`filter_matrix_rows`."""
    return filter_matrix_rows(to_csr(A).T.tocsr(), theta).T.tocsr()


def truncate_rows(A, nz_per_row):
    """Keep the ``nz_per_row`` entries of largest magnitude in each row."""
    A = to_csr(A).copy()
    indptr = A.indptr
    keep = np.zeros(A.nnz, dtype=bool)
    for i in range(A.shape[0]):
        s, e = indptr[i], indptr[i + 1]
        if e - s <= nz_per_row:
            keep[s:e] = True
        else:
            # the same partition as the JAX package's, so that ties fall
            # the same way
            idx = np.argpartition(np.abs(A.data[s:e]), e - s - nz_per_row)
            keep[s + idx[e - s - nz_per_row:]] = True
    A.data = np.where(keep, A.data, 0)
    A.eliminate_zeros()
    return A


def filter_operator(A, C, B, Bf, BtBinv=None):
    """A restricted to the pattern of C, then corrected row by row (the
    least-norm correction on the row's kept entries) so that ``A @ B ==
    Bf`` still holds.  A, C sparse (n, m); B (m, k); Bf (n, k)."""
    A = to_csr(A)
    C = to_csr(C)
    B = np.asarray(B)
    Bf = np.asarray(Bf)
    pattern = C.copy()
    pattern.data = np.ones_like(pattern.data)
    Anew = A.multiply(pattern).tocsr()
    Anew.sort_indices()
    defect = Bf - Anew @ B
    rows_out, cols_out, vals_out = [], [], []
    for i in range(A.shape[0]):
        cols = Anew.indices[Anew.indptr[i]:Anew.indptr[i + 1]]
        if cols.size == 0:
            continue
        u = np.linalg.lstsq(B[cols].conj().T, defect[i], rcond=None)[0]
        rows_out.append(np.full(cols.size, i))
        cols_out.append(cols)
        vals_out.append(u)
    if rows_out:
        U = sp.coo_matrix(
            (np.concatenate(vals_out),
             (np.concatenate(rows_out), np.concatenate(cols_out))),
            shape=Anew.shape).tocsr()
        Anew = (Anew + U).tocsr()
    Anew.eliminate_zeros()
    return Anew


def scale_T(T, P_I, I_F, blocksize=1):
    """Root-node scaling of the tentative prolongator: ``T <- I_F T S +
    P_I`` with ``S`` the block-by-block pseudo-inverse of ``P_I^T T``
    (block diagonal in (blocksize, blocksize) blocks), so that every root
    row of T is a row of the identity."""
    T = to_csr(T)
    P_I = to_csr(P_I)
    I_F = to_csr(I_F)
    root_block = (P_I.T @ T).tocsr()
    nc = root_block.shape[0]
    bs = int(blocksize) if nc % max(int(blocksize), 1) == 0 else 1
    blocks = np.ascontiguousarray(get_block_diag(root_block, bs,
                                                 inv_flag=True))
    S = sp.bsr_matrix((blocks, np.arange(nc // bs),
                       np.arange(nc // bs + 1)), shape=(nc, nc)).tocsr()
    return (I_F @ T @ S + P_I).tocsr()


def get_Cpt_params(A, Cnodes, AggOp, T):
    """The root-node bookkeeping of an aggregation: ``Cpts`` and ``Fpts``
    (the root dofs and the rest), ``P_I`` (coarse dof j to its fine root
    dof) and the 0/1 diagonal masks ``I_F`` and ``I_C``."""
    A = to_csr(A)
    T = to_csr(T)
    Cnodes = np.asarray(Cnodes, dtype=np.int64)
    bs = A.shape[0] // AggOp.shape[0]
    Cpts = (bs * Cnodes[:, None] + np.arange(bs)[None, :]).ravel()
    mask = np.zeros(A.shape[0], dtype=bool)
    mask[Cpts] = True
    Fpts = np.flatnonzero(~mask)
    n_fine, n_coarse = T.shape
    if Cpts.size == n_coarse:
        # coarse dof j is fine root dof Cpts[j]: the dofs of aggregate a's
        # root pair with its coarse columns a*bs .. a*bs+bs-1 in order
        P_I = sp.coo_matrix(
            (np.ones(n_coarse), (Cpts, np.arange(n_coarse))),
            shape=(n_fine, n_coarse)).tocsr()
    else:
        # an aggregation that dropped empty aggregates: each root dof maps
        # to the first coarse column its row of T stores
        has_entry = np.diff(T.indptr) > 0
        first_col = np.zeros(n_fine, dtype=np.int64)
        first_col[has_entry] = T.indices[T.indptr[:-1][has_entry]]
        sel = Cpts[has_entry[Cpts]]
        P_I = sp.coo_matrix((np.ones(sel.size), (sel, first_col[sel])),
                            shape=(n_fine, n_coarse)).tocsr()

    def diag_mask(idx):
        d = np.zeros(n_fine)
        d[idx] = 1.0
        return sp.dia_matrix((d[None, :], [0]),
                             shape=(n_fine, n_fine)).tocsr()

    return {"Cpts": Cpts, "Fpts": Fpts, "P_I": P_I,
            "I_F": diag_mask(Fpts), "I_C": diag_mask(Cpts)}


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


# the host relaxations of the JAX package's relaxation.relaxation module;
# a smoother name outside it (a device-only one) relaxes on the host as
# symmetric Gauss-Seidel, in both packages
_HOST_RELAXATIONS = frozenset([
    "gauss_seidel", "zebra", "line_gauss_seidel", "line_jacobi", "sor",
    "jacobi", "polynomial", "block_jacobi", "block_gauss_seidel",
    "gauss_seidel_indexed", "jacobi_ne", "gauss_seidel_ne",
    "gauss_seidel_nr", "schwarz"])


def host_relaxation(method):
    """``(function, kwargs)`` of a smoother option on the host
    (``relaxation.relaxation``): a name the JAX package has no host
    relaxation for means symmetric Gauss-Seidel, as there."""
    from ..relaxation import relaxation as rel

    fn_name, kwargs = unpack_arg(method)
    if fn_name not in _HOST_RELAXATIONS:
        fn_name, kwargs = "gauss_seidel", {"sweep": "symmetric"}
    return getattr(rel, fn_name), dict(kwargs)


def relaxation_as_linear_operator(method, A, b):
    """A scipy ``LinearOperator`` that applies one pass of a host
    relaxation method (:func:`host_relaxation`) on ``A x = b`` from the
    given x.  ``improve_candidates`` applies it to B, which relaxes each
    candidate against ``A x = 0``."""
    from scipy.sparse.linalg import LinearOperator

    fn, kwargs = host_relaxation(method)
    b = np.asarray(b)

    def matvec(x):
        x = np.array(x, dtype=A.dtype, copy=True)
        fn(A, x, b, **kwargs)
        return x

    return LinearOperator(A.shape, matvec, dtype=A.dtype)
