"""Interpolation of classical AMG (host, numpy/scipy).

Port of ``pyamg_tpu/classical/interpolate.py``: direct interpolation and
standard (distance-two) interpolation from a C/F splitting, each in one
pass of the compiled ``amg_core`` library where it loaded, else in numpy
over all rows at once (standard interpolation's two pair quantities as
pattern-restricted products).  ``_standard_interpolation_loop`` is the
per-row form that the vectorized one is held against.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..amg_core import (direct_interpolation_native, masked_spgemm_native,
                        pattern_values_native, standard_interpolation_native)
from ..util.utils import row_reduce, to_csr

__all__ = ["direct_interpolation", "standard_interpolation"]


def _coarse_map(splitting):
    """The coarse index of each point (meaningful at C points) and the
    number of C points."""
    return np.cumsum(splitting) - splitting, int(splitting.sum())


def direct_interpolation(A, C, splitting):
    """Direct interpolation P from the C/F splitting: a C row is the
    identity; an F row i takes ``P_ij = -(alpha or beta) / d_i * a_ij`` over
    its strong C neighbours j, alpha (beta) the sum of all negative
    (positive) off-diagonal entries over the strong ones, and the positive
    mass lumped into ``d_i`` when no strong neighbour is positive.

    Examples
    --------
    >>> import numpy as np
    >>> from pyamg_tpu_torch.gallery import poisson
    >>> A = poisson((5,), format='csr')
    >>> P = direct_interpolation(A, A, np.array([1, 0, 1, 0, 1], 'int32'))
    >>> P.toarray()
    array([[1. , 0. , 0. ],
           [0.5, 0.5, 0. ],
           [0. , 1. , 0. ],
           [0. , 0.5, 0.5],
           [0. , 0. , 1. ]])
    """
    A = to_csr(A)
    C = to_csr(C)
    splitting = np.asarray(splitting, dtype=np.int32)
    n = A.shape[0]
    A.sort_indices()
    C.sort_indices()
    cmap, nc = _coarse_map(splitting)
    P = direct_interpolation_native(A, C, splitting, cmap, nc)
    if P is not None:
        return P

    S = C.copy()
    S.data = np.ones_like(S.data)
    S = S.multiply(A).tocsr()
    S.sort_indices()

    rows_A = np.repeat(np.arange(n), np.diff(A.indptr))
    offdiag_A = rows_A != A.indices
    neg_A = (A.data.real < 0) & offdiag_A
    pos_A = (A.data.real >= 0) & offdiag_A
    sum_all_neg = row_reduce(np.where(neg_A, A.data, 0), A.indptr, np.add,
                             0.0)
    sum_all_pos = row_reduce(np.where(pos_A, A.data, 0), A.indptr, np.add,
                             0.0)
    diag = A.diagonal().astype(A.dtype).copy()

    rows_S = np.repeat(np.arange(n), np.diff(S.indptr))
    strongC = (splitting[S.indices] == 1) & (rows_S != S.indices)
    neg_S = strongC & (S.data.real < 0)
    pos_S = strongC & (S.data.real >= 0)
    sum_strong_neg = row_reduce(np.where(neg_S, S.data, 0), S.indptr,
                                np.add, 0.0)
    sum_strong_pos = row_reduce(np.where(pos_S, S.data, 0), S.indptr,
                                np.add, 0.0)

    no_pos = sum_strong_pos == 0
    diag = diag + np.where(no_pos, sum_all_pos, 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        alpha = np.where(sum_strong_neg != 0,
                         sum_all_neg / np.where(sum_strong_neg != 0,
                                                sum_strong_neg, 1), 0)
        beta = np.where(no_pos, 0,
                        sum_all_pos / np.where(sum_strong_pos != 0,
                                               sum_strong_pos, 1))
        neg_coeff = -alpha / diag
        pos_coeff = -beta / diag

    keepF = strongC & (splitting[rows_S] == 0)
    valsF = np.where(S.data.real < 0, neg_coeff[rows_S],
                     pos_coeff[rows_S]) * S.data
    cpts = np.flatnonzero(splitting == 1)
    rowsP = np.concatenate([rows_S[keepF], cpts])
    colsP = np.concatenate([cmap[S.indices[keepF]], cmap[cpts]])
    valsP = np.concatenate([valsF[keepF], np.ones(nc, dtype=A.dtype)])
    P = sp.coo_matrix((valsP, (rowsP, colsP)), shape=(n, nc)).tocsr()
    P.sort_indices()
    return P


def _masked_product_csr(Aop, Bop, pattern):
    """``(Aop @ Bop)`` on ``pattern``'s sparsity (explicit zeros kept, so
    the result is aligned entry for entry with the pattern)."""
    out = masked_spgemm_native(Aop, Bop, pattern)
    if out is not None:
        return out
    full = (Aop @ Bop).tocsr()
    full.sort_indices()
    ncols = pattern.shape[1]
    pk = np.repeat(np.arange(pattern.shape[0], dtype=np.int64),
                   np.diff(pattern.indptr)) * ncols + pattern.indices
    fk = np.repeat(np.arange(full.shape[0], dtype=np.int64),
                   np.diff(full.indptr)) * ncols + full.indices
    data = np.zeros(pattern.nnz, dtype=full.dtype)
    if fk.size:
        pos = np.minimum(np.searchsorted(fk, pk), fk.size - 1)
        data = np.where(fk[pos] == pk, full.data[pos], 0)
    return sp.csr_matrix((data, pattern.indices.copy(),
                          pattern.indptr.copy()), shape=pattern.shape)


def standard_interpolation(A, C, splitting):
    """Standard (distance-two) interpolation: an F row i interpolates from
    its strong C neighbours k with ``P_ik = -(a_ik + sum_j (a_ij / denom_ij)
    a_jk) / d_i``, distributing each strong F neighbour j over j's strong C
    connections shared with i (``denom_ij`` their sum); a zero denominator
    and the weak off-diagonal mass lump into ``d_i``.  Vectorized, the two
    pair quantities are pattern-restricted products:
    ``denom = (C_i indicator) (S_C)^T`` on the strong F-F pattern and
    ``contrib = (a_ij / denom_ij) S_C`` on the strong C pattern."""
    A = to_csr(A)
    C = to_csr(C)
    splitting = np.asarray(splitting, dtype=np.int32)
    n = A.shape[0]
    A.sort_indices()
    C.sort_indices()

    # S: A's values on C's pattern
    S_data = pattern_values_native(C, A)
    if S_data is not None:
        S = sp.csr_matrix((S_data, C.indices, C.indptr), shape=C.shape)
        S.has_sorted_indices = True
    else:
        S = C.copy()
        S.data = np.ones_like(S.data)
        S = S.multiply(A).tocsr()
        S.sort_indices()

    cmap, nc = _coarse_map(splitting)
    P = standard_interpolation_native(A, S, splitting, cmap, nc)
    if P is not None:
        return P

    isC = splitting == 1
    rows_S = np.repeat(np.arange(n), np.diff(S.indptr))
    offd = rows_S != S.indices
    sC = offd & isC[S.indices]
    sF = offd & ~isC[S.indices]

    # fresh index arrays: eliminate_zeros compacts them in place
    SC = sp.csr_matrix((np.where(sC, S.data, 0), S.indices.copy(),
                        S.indptr.copy()), shape=S.shape)
    SC.eliminate_zeros()
    SC.sort_indices()
    SF = sp.csr_matrix((np.where(sF, S.data, 0), S.indices.copy(),
                        S.indptr.copy()), shape=S.shape)
    SF.eliminate_zeros()
    SF.sort_indices()

    Pind = SC.copy()
    Pind.data = np.ones_like(Pind.data)
    denom = _masked_product_csr(Pind, SC.T, SF)
    B = SF.copy()
    zero_den = denom.data == 0
    with np.errstate(divide="ignore", invalid="ignore"):
        B.data = np.where(zero_den, 0.0,
                          B.data / np.where(zero_den, 1, denom.data))
    lump = row_reduce(np.where(zero_den, SF.data, 0), SF.indptr, np.add, 0.0)
    w_vals = SC.data + _masked_product_csr(B, SC, SC).data

    rows_A = np.repeat(np.arange(n), np.diff(A.indptr))
    offsum_A = row_reduce(np.where(rows_A != A.indices, A.data, 0),
                          A.indptr, np.add, 0.0)
    offsum_S = row_reduce(np.where(offd, S.data, 0), S.indptr, np.add, 0.0)
    diag = A.diagonal() + (offsum_A - offsum_S) + lump

    rows_SC = np.repeat(np.arange(n), np.diff(SC.indptr))
    keep = (splitting[rows_SC] == 0) & (diag[rows_SC] != 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        valsF = -w_vals / np.where(diag[rows_SC] != 0, diag[rows_SC], 1)
    cpts = np.flatnonzero(isC)
    rowsP = np.concatenate([rows_SC[keep], cpts])
    colsP = np.concatenate([cmap[SC.indices[keep]], cmap[cpts]])
    valsP = np.concatenate([valsF[keep], np.ones(nc, dtype=A.dtype)])
    P = sp.coo_matrix((valsP.astype(A.dtype), (rowsP, colsP)),
                      shape=(n, nc)).tocsr()
    P.sort_indices()
    return P


def _standard_interpolation_loop(A, C, splitting):
    """Standard interpolation row by row, the test oracle of the
    vectorized form."""
    A = to_csr(A)
    C = to_csr(C)
    splitting = np.asarray(splitting, dtype=np.int32)
    n = A.shape[0]
    S = C.copy()
    S.data = np.ones_like(S.data)
    S = S.multiply(A).tocsr()
    S.sort_indices()
    cmap, nc = _coarse_map(splitting)

    rows_out, cols_out, vals_out = [], [], []
    Ap, Aj, Ax = A.indptr, A.indices, A.data
    Sp, Sj, Sx = S.indptr, S.indices, S.data
    for i in range(n):
        if splitting[i] == 1:
            rows_out.append([i])
            cols_out.append([cmap[i]])
            vals_out.append([1.0])
            continue
        srow = Sj[Sp[i]:Sp[i + 1]]
        sval = Sx[Sp[i]:Sp[i + 1]]
        m = (splitting[srow] == 1) & (srow != i)
        Ci = srow[m]
        if Ci.size == 0:
            continue
        w = dict(zip(Ci.tolist(), sval[m].tolist()))
        diag = 0.0
        strong_set = set(srow[(splitting[srow] == 1) | (srow == i)].tolist())
        strongF = set(srow[(splitting[srow] == 0) & (srow != i)].tolist())
        for j, a in zip(Aj[Ap[i]:Ap[i + 1]], Ax[Ap[i]:Ap[i + 1]]):
            if j == i:
                diag += a
            elif j in strongF:
                sj = Sj[Sp[j]:Sp[j + 1]]
                sv = Sx[Sp[j]:Sp[j + 1]]
                mj = splitting[sj] == 1
                common = np.isin(sj[mj], Ci)
                denom = sv[mj][common].sum()
                if denom != 0:
                    for k, akj in zip(sj[mj][common], sv[mj][common]):
                        w[int(k)] = w.get(int(k), 0.0) + a * akj / denom
                else:
                    diag += a
            elif j not in strong_set:
                diag += a
        if diag == 0:
            continue
        for k, wk in w.items():
            rows_out.append([i])
            cols_out.append([cmap[k]])
            vals_out.append([-wk / diag])
    return sp.coo_matrix(
        (np.concatenate(vals_out).astype(A.dtype),
         (np.concatenate(rows_out), np.concatenate(cols_out))),
        shape=(n, nc)).tocsr()
