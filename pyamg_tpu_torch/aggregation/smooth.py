"""Prolongation smoothers of the unstructured SA chain (host, scipy).

Port of ``jacobi_prolongation_smoother`` and
``richardson_prolongation_smoother`` from
``pyamg_tpu/aggregation/smooth.py``, for scalar (CSR) operators without the
strength filter.  Energy minimization is not ported yet.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..util.linalg import approximate_spectral_radius
from ..util.utils import get_diagonal, not_ported, scale_rows, to_csr

__all__ = ["jacobi_prolongation_smoother",
           "richardson_prolongation_smoother",
           "energy_prolongation_smoother"]

_UNSTRUCTURED = "the unstructured SA chain"


def _jacobi_weight(S, omega, weighting, sym_hint):
    """``(D_inv, c)`` such that the Jacobi smoother is ``I - c D^{-1} S``:
    the one place that chooses the estimator of rho, for the one-product
    form (:func:`_jacobi_operator`) and the materialized one
    (:func:`_dinv_s`) alike."""
    if weighting == "diagonal":
        D_inv = get_diagonal(S, inv=True)
        if sym_hint:
            from ..relaxation.smoothing import rho_D_inv_A

            rho = rho_D_inv_A(S, symmetric=True)
        else:
            rho = approximate_spectral_radius(
                scale_rows(to_csr(S), D_inv, copy=True))
        return D_inv, omega / rho
    # "local": omega applied to the abs-row-sum scaling, no rho
    D = np.asarray(abs(to_csr(S)).sum(axis=1)).ravel()
    D_inv = np.where(D != 0, 1.0 / np.where(D != 0, D, 1), 0.0)
    return D_inv, omega


def _dinv_s(S, omega, weighting, sym_hint=None):
    """The omega-scaled ``D^{-1} S`` of the requested weighting."""
    if weighting == "block":
        weighting = "diagonal"          # a scalar operator's blocks are 1x1
    if weighting not in ("diagonal", "local"):
        raise ValueError("incorrect weighting option")
    D_inv, c = _jacobi_weight(S, omega, weighting, sym_hint)
    return c * scale_rows(to_csr(S), D_inv, copy=True)


def _jacobi_operator(S, omega, weighting, sym_hint):
    """``E = I - (omega/rho) D^{-1} S`` in one value pass on S's own
    pattern, so that smoothing is the single product ``E @ P``; None when a
    row stores no diagonal (or the weighting is not diagonal/local)."""
    if weighting not in ("diagonal", "local"):
        return None
    S_csr = to_csr(S)
    n = S_csr.shape[0]
    if S_csr.shape[1] != n:
        return None
    D_inv, c = _jacobi_weight(S, omega, weighting, sym_hint)
    rows = np.repeat(np.arange(n), np.diff(S_csr.indptr))
    diag_mask = S_csr.indices == rows
    if int(diag_mask.sum()) != n:
        return None
    data = (-c) * (S_csr.data * D_inv[rows])
    data[diag_mask] += 1.0
    E = sp.csr_matrix((data, S_csr.indices, S_csr.indptr), shape=S_csr.shape)
    E.has_sorted_indices = S_csr.has_sorted_indices
    return E


def jacobi_prolongation_smoother(S, T, C, B, omega=4.0 / 3.0, degree=1,
                                 filter=False, weighting="diagonal",
                                 sym_hint=None):
    """``P = (I - omega/rho(D^{-1}S) D^{-1}S)^degree T``.

    Examples
    --------
    >>> import numpy as np
    >>> from pyamg_tpu_torch.gallery import poisson
    >>> from pyamg_tpu_torch.aggregation.aggregate import standard_aggregation
    >>> from pyamg_tpu_torch.aggregation.tentative import fit_candidates
    >>> A = poisson((16, 16), format='csr')
    >>> AggOp, _ = standard_aggregation(A)
    >>> T, Bc = fit_candidates(AggOp, np.ones((A.shape[0], 1)))
    >>> P = jacobi_prolongation_smoother(A, T, A, Bc)
    >>> P.shape == T.shape and P.nnz >= T.nnz
    True
    """
    if filter:
        raise not_ported("the strength filter of the Jacobi prolongation "
                         "smoother", _UNSTRUCTURED)
    if sp.issparse(S) and S.format == "bsr" and S.blocksize[0] > 1:
        raise not_ported("Jacobi prolongation smoothing of a block (BSR) "
                         "operator", "bdia/bell")
    P = to_csr(T)
    E = _jacobi_operator(S, omega, weighting, sym_hint)
    if E is not None:
        for _ in range(degree):
            P = (E @ P).tocsr()
        return P
    D_inv_S = _dinv_s(S, omega, weighting, sym_hint=sym_hint)
    for _ in range(degree):
        P = (P - D_inv_S @ P).tocsr()
    return P


def richardson_prolongation_smoother(S, T, omega=4.0 / 3.0, degree=1,
                                     sym_hint=None):
    """``P = (I - omega/rho(S) S)^degree T``."""
    weight = omega / approximate_spectral_radius(
        S, symmetric=bool(sym_hint) or None)
    P = to_csr(T)
    S = to_csr(S)
    for _ in range(degree):
        P = (P - weight * (S @ P)).tocsr()
    return P


def energy_prolongation_smoother(*args, **kwargs):
    """Energy-minimizing prolongation smoothing: not ported yet."""
    raise not_ported("smooth='energy'", _UNSTRUCTURED)
