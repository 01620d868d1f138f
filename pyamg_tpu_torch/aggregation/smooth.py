"""Prolongation smoothers of the unstructured SA chain (host, scipy):
Jacobi, Richardson and energy minimization.

Port of ``pyamg_tpu/aggregation/smooth.py`` for scalar (CSR) and block
(BSR) operators: Jacobi with diagonal, local or block weighting and the
optional strength filter; energy minimization by pattern-constrained CG
(``krylov="cg"``) on one of three routes with the JAX package's conditions
-- the block route on a float64 BSR operator (every iterate dense (R, K)
blocks on the block pattern), the flat route over a fixed CSR pattern with
the compiled products (real float64), and the generic scipy route -- or,
for a nonsymmetric operator, by CGNR or GMRES on the generic route; the
root-node form (``Cpt_params``) and the pre- and post-filters.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..util.linalg import approximate_spectral_radius, pinv_array
from ..util.utils import (compute_BtBinv, filter_matrix_rows,
                          get_block_diag, get_diagonal,
                          scale_rows, to_csr, truncate_rows, unamal)

__all__ = ["jacobi_prolongation_smoother",
           "richardson_prolongation_smoother",
           "energy_prolongation_smoother", "satisfy_constraints"]


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
    """The omega-scaled ``D^{-1} S`` of the requested weighting; "block"
    inverts the diagonal blocks of a BSR S (the diagonal of anything
    else)."""
    if weighting == "block" and (not sp.issparse(S) or S.format != "bsr"
                                 or S.blocksize[0] == 1):
        weighting = "diagonal"
    if weighting == "block":
        D_inv = get_block_diag(S, blocksize=S.blocksize[0], inv_flag=True)
        D_inv_mat = sp.bsr_matrix(
            (D_inv, np.arange(D_inv.shape[0]),
             np.arange(D_inv.shape[0] + 1)), shape=S.shape)
        D_inv_S = (D_inv_mat @ S).tocsr()
        return (omega / approximate_spectral_radius(D_inv_S)) * D_inv_S
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
    """``P = (I - omega/rho(D^{-1}S) D^{-1}S)^degree T``; with ``filter``,
    S is first restricted to the strength graph C (expanded to S's blocks)
    and each update is projected so that ``P B`` keeps its values.

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
    if not filter:
        E = _jacobi_operator(S, omega, weighting, sym_hint)
        if E is not None:
            P = to_csr(T)
            for _ in range(degree):
                P = (E @ P).tocsr()
            return P
    else:
        numPDEs = S.blocksize[0] if (sp.issparse(S) and S.format == "bsr") \
            else 1
        Cf = unamal(C, numPDEs, numPDEs)
        S = to_csr(S).multiply(Cf).tocsr()
        S.eliminate_zeros()
        sym_hint = None                  # the filtered S is not symmetric

    D_inv_S = _dinv_s(S, omega, weighting, sym_hint=sym_hint)
    P = to_csr(T)
    for _ in range(degree):
        if filter:
            U = (D_inv_S @ P).tocsr()
            U = satisfy_constraints(U, B, compute_BtBinv(B, U))
            P = (P - U).tocsr()
        else:
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


def satisfy_constraints(U, B, BtBinv):
    """Project each row of U so that ``U @ B = 0``: ``U_ij -= (U_i B)
    BtBinv_i (B_j)^H`` for every stored entry.  U sparse (n, m), B (m, k)
    coarse candidates, BtBinv (n, k, k) the Gram pseudo-inverses over U's
    rows."""
    U = to_csr(U).copy()
    B = np.asarray(B)
    n = U.shape[0]
    UB = np.asarray(U @ B)                                 # (n, k)
    coef = np.einsum("nk,nkl->nl", UB, BtBinv)             # (n, k)
    rows = np.repeat(np.arange(n), np.diff(U.indptr))
    U.data = U.data - np.einsum("ek,ek->e", coef[rows],
                                np.conj(B[U.indices]))
    return U


def _masked_product(A, P, pattern):
    """``(A @ P)`` on ``pattern``'s sparsity: the compiled row-scatter
    product for real float64, else the product then the mask."""
    from ..amg_core import masked_spgemm_native

    out = masked_spgemm_native(to_csr(A), P, pattern)
    if out is not None:
        return out
    return (A @ P).tocsr().multiply(pattern).tocsr()


def _grow_pattern(Atilde, T, degree):
    """The unit pattern of ``|Atilde|^degree |T|``."""
    pattern = to_csr(T).copy()
    pattern.data = np.ones_like(pattern.data)
    if degree > 0:
        G = abs(to_csr(Atilde))
        for _ in range(degree):
            pattern = (G @ pattern).tocsr()
    pattern.data = np.ones_like(pattern.data)
    return pattern


def energy_prolongation_smoother(A, T, Atilde, B, Bf=None, Cpt_params=None,
                                 krylov="cg", maxiter=4, tol=1e-8, degree=1,
                                 weighting="local", prefilter=None,
                                 postfilter=None):
    """Energy-minimizing prolongation smoothing: minimize ``trace(P^H A
    P)`` over P on the pattern ``|Atilde|^degree |T|`` under ``P B_c =
    B_f`` (every update U projected to ``U B_c = 0``), by ``maxiter``
    iterations of pattern-constrained CG from T; ``krylov="cgnr"`` or
    ``"gmres"`` minimizes ``||A P||`` instead, for a nonsymmetric A.
    ``Atilde`` may be the node-level strength graph of a blocked A
    (expanded to dofs here).  ``weighting`` ("local", "diagonal" or
    "block") preconditions the iteration.

    ``Cpt_params = (True, params)`` (``get_Cpt_params``'s dict) is the
    root-node form: the root rows of the pattern are those of ``P_I``, the
    CG updates only the other rows (``I_F``), and the result is ``I_F P +
    P_I``.  ``prefilter`` / ``postfilter`` (``{"theta": ..}`` and/or
    ``{"k": ..}``) thin T before the pattern grows, or P after the CG (then
    the constraint is restored on the thinned pattern).

    Examples
    --------
    >>> import numpy as np
    >>> from pyamg_tpu_torch.gallery import poisson
    >>> from pyamg_tpu_torch.aggregation.aggregate import standard_aggregation
    >>> from pyamg_tpu_torch.aggregation.tentative import fit_candidates
    >>> A = poisson((16, 16), format='csr')
    >>> AggOp, _ = standard_aggregation(A)
    >>> T, Bc = fit_candidates(AggOp, np.ones((A.shape[0], 1)))
    >>> P = energy_prolongation_smoother(A, T, A, Bc)
    >>> bool(np.allclose(P @ Bc, T @ Bc))
    True
    """
    if krylov not in ("cg", "cgnr", "gmres"):
        raise ValueError(f"unknown krylov method {krylov!r}")
    if weighting not in ("local", "diagonal", "block"):
        raise ValueError("incorrect weighting option")
    rootnode = Cpt_params is not None and Cpt_params[0]
    bs_A = A.blocksize[0] if sp.issparse(A) and A.format == "bsr" else 1

    # a node-blocked operator: the whole CG in BSR block form (not for the
    # root-node form or the filters, as in the JAX package)
    if (bs_A > 1 and krylov == "cg" and weighting in ("local", "diagonal")
            and not prefilter and not postfilter and not rootnode
            and (degree == 0
                 or (Atilde is not None and sp.issparse(Atilde)
                     and Atilde.shape[0] * bs_A == T.shape[0]))):
        Tout = _cg_prolongation_bsr(A, to_csr(T), Atilde, np.asarray(B),
                                    maxiter, tol, degree, weighting)
        if Tout is not None:
            Tout.eliminate_zeros()
            return Tout

    A = to_csr(A)
    T = to_csr(T)
    B = np.asarray(B)
    # a blocked operator carries a node-level strength graph: expand it to
    # dofs for the pattern growth
    if Atilde is not None and sp.issparse(Atilde) \
            and Atilde.shape[0] != T.shape[0]:
        bs_row = T.shape[0] // Atilde.shape[0]
        Atilde = unamal(Atilde, bs_row, bs_row)
    if prefilter:
        if "theta" in prefilter:
            T = filter_matrix_rows(T, prefilter["theta"])
        if "k" in prefilter:
            T = truncate_rows(T, prefilter["k"])
    pattern = _grow_pattern(Atilde, T, degree)
    I_F = fmask = None
    if rootnode:
        # the root rows of the pattern are exactly P_I's
        I_F, P_I = to_csr(Cpt_params[1]["I_F"]), to_csr(Cpt_params[1]["P_I"])
        PIpat = P_I.copy()
        PIpat.data = np.ones_like(PIpat.data)
        pattern = ((I_F @ pattern).tocsr() + PIpat).tocsr()
        pattern.data = np.ones_like(pattern.data)
        fmask = np.asarray(I_F.diagonal()).real != 0
    BtBinv = compute_BtBinv(B, pattern)

    def project(U):
        if I_F is not None:
            U = (I_F @ U).tocsr()
        return satisfy_constraints(U, B, BtBinv)

    Tout = None
    if weighting == "block":
        # as in the JAX package, the blocks are those of the CSR form here:
        # 1 x 1 (ROADMAP.md, Queue 3)
        Db = get_block_diag(A, blocksize=1, inv_flag=True)
        Dinv_mat = sp.bsr_matrix((Db, np.arange(Db.shape[0]),
                                  np.arange(Db.shape[0] + 1)),
                                 shape=A.shape).tocsr()

        def apply_Dinv(R):
            return (Dinv_mat @ R).tocsr()
    else:
        if weighting == "local":
            Dv = np.asarray(abs(A).sum(axis=1)).ravel()
            Dinv = np.where(Dv != 0, 1.0 / np.where(Dv != 0, Dv, 1), 0.0)
        else:
            Dinv = get_diagonal(A, inv=True)

        def apply_Dinv(R):
            return scale_rows(R, Dinv, copy=True)

        if krylov == "cg":
            Tout = _cg_prolongation_flat(A, T, pattern, B, BtBinv, Dinv,
                                         maxiter, tol, fmask=fmask)
    if Tout is None:
        minimize = {"cg": _cg_prolongation, "cgnr": _cgnr_prolongation,
                    "gmres": _gmres_prolongation}[krylov]
        Tout = minimize(A, T, pattern, project, apply_Dinv, maxiter, tol)
    if rootnode:
        Tout = (I_F @ Tout + P_I).tocsr()
    if postfilter:
        if "theta" in postfilter:
            Tout = _restore_constraint(
                Tout, filter_matrix_rows(Tout, postfilter["theta"]), B)
        if "k" in postfilter:
            Tout = _restore_constraint(
                Tout, truncate_rows(Tout, postfilter["k"]), B)
    Tout.eliminate_zeros()
    return Tout


def _restore_constraint(Tout, Tnew, B):
    """``Tnew`` (a thinned ``Tout``) plus the least-norm correction on its
    own pattern, row by row, that gives back ``Tnew @ B == Tout @ B``."""
    defect = np.asarray((Tout - Tnew) @ B)            # (n, k)
    BtBinv = compute_BtBinv(B, Tnew)
    coef = np.einsum("nk,nkl->nl", defect, BtBinv)    # (n, k)
    U = Tnew.copy()
    rows = np.repeat(np.arange(Tnew.shape[0]), np.diff(U.indptr))
    U.data = np.einsum("ek,ek->e", coef[rows],
                       np.conj(np.asarray(B)[U.indices]))
    out = (Tnew + U).tocsr()
    out.eliminate_zeros()
    return out


def _frob_inner(X, Y):
    """``sum_ij conj(X_ij) Y_ij`` over matching patterns."""
    return complex((X.conjugate().multiply(Y)).sum()) \
        if np.iscomplexobj(X.data) else float((X.multiply(Y)).sum())


def _cg_prolongation_bsr(A, T, AtildeN, B, maxiter, tol, degree, weighting):
    """The energy CG in BSR block form: every iterate is dense (R, K)
    blocks on the block pattern ``|AtildeN|^degree`` times T's block
    pattern, the pattern grows on the node graph, and one Gram
    pseudo-inverse serves each block row.  None (the caller then takes the
    scalar routes) for data that is not real float64, without the compiled
    library, or where the block structure does not apply."""
    from ..amg_core import (constraint_project_bsr_native,
                            masked_spgemm_bsr_native, pattern_gram_bsr_native)

    R = A.blocksize[0]
    if (A.blocksize[1] != R or A.dtype != np.float64
            or np.iscomplexobj(A.data) or np.iscomplexobj(B)):
        return None
    B = np.asarray(B, dtype=np.float64)
    K = B.shape[1]
    if T.shape[0] % R or T.shape[1] % K:
        return None
    try:
        Tb = T.tobsr(blocksize=(R, K))
    except ValueError:
        return None
    nbr, nbc = Tb.shape[0] // R, Tb.shape[1] // K
    if AtildeN is not None and AtildeN.shape[0] != nbr:
        return None
    if (np.diff(A.indptr) == 0).any():
        return None                       # an empty block row

    # node-level pattern growth (structure only)
    pat = sp.csr_matrix(
        (np.ones(Tb.indices.shape[0]), Tb.indices.copy(), Tb.indptr.copy()),
        shape=(nbr, nbc))
    if degree > 0 and AtildeN is not None:
        G = to_csr(AtildeN).copy()
        G.data = np.ones_like(G.data, dtype=np.float64)
        for _ in range(degree):
            pat = (G @ pat).tocsr()
    pat.data = np.ones_like(pat.data)
    pat.sort_indices()
    Pp, Pj = pat.indptr, pat.indices
    nnzb = pat.nnz

    gram = pattern_gram_bsr_native(Pp, Pj, K, B)
    if gram is None:
        return None
    Gb = np.ascontiguousarray(pinv_array(gram))

    # the weighting per scalar row, from the BSR data
    data = A.data
    if weighting == "local":
        Dv = np.add.reduceat(np.abs(data).sum(axis=2),
                             A.indptr[:-1], axis=0)     # (nbr, R)
    else:
        Dv = A.diagonal().reshape(nbr, R)
    Dinv = np.where(Dv != 0, 1.0 / np.where(Dv != 0, Dv, 1), 0.0)

    # T's blocks in the pattern's slots (sorted block-major keys)
    key_pat = Pj.astype(np.int64) + np.int64(nbc) * np.repeat(
        np.arange(nbr, dtype=np.int64), np.diff(Pp))
    key_T = Tb.indices.astype(np.int64) + np.int64(nbc) * np.repeat(
        np.arange(nbr, dtype=np.int64), np.diff(Tb.indptr))
    pos = np.searchsorted(key_pat, key_T)
    if pos.max(initial=-1) >= nnzb or not (key_pat[pos] == key_T).all():
        return None                     # T's pattern escapes the target

    Ap, Aj = A.indptr, A.indices

    def project(vals):
        if not constraint_project_bsr_native(vals, Pp, Pj, R, K, B, Gb):
            raise RuntimeError("the compiled projection vanished mid-solve")
        return vals

    AT = masked_spgemm_bsr_native(nbc, R, K, Ap, Aj, data,
                                  Tb.indptr, Tb.indices, Tb.data, Pp, Pj)
    if AT is None:
        return None
    dinv_e = Dinv[np.repeat(np.arange(nbr), np.diff(Pp))][:, :, None]

    tvals = np.zeros((nnzb, R, K), dtype=np.float64)
    tvals[pos] = Tb.data
    rvals = project(-AT)
    normr0 = max(np.abs(rvals).max(initial=0.0), 1e-300)
    pvals = tvals
    oldsum = 0.0
    ptvals = None
    for _ in range(maxiter):
        if np.abs(rvals).max(initial=0.0) < tol * normr0:
            break
        zvals = rvals * dinv_e
        newsum = float(rvals.ravel() @ zvals.ravel())
        if newsum == 0:
            break
        ptvals = zvals if oldsum == 0 else \
            zvals + (newsum / oldsum) * ptvals
        oldsum = newsum
        ap = project(masked_spgemm_bsr_native(nbc, R, K, Ap, Aj, data,
                                              Pp, Pj, ptvals, Pp, Pj))
        d = float(ptvals.ravel() @ ap.ravel())
        if d == 0:
            break
        alpha = newsum / d
        pvals = pvals + alpha * ptvals
        rvals = rvals - alpha * ap
    out = sp.bsr_matrix((pvals.copy(), Pj.copy(), Pp.copy()),
                        shape=T.shape).tocsr()
    out.sort_indices()
    return out


def _cg_prolongation_flat(A, T, pattern, B, BtBinv, Dinv, maxiter, tol,
                          fmask=None):
    """The energy CG with every iterate a flat value array over
    ``pattern``'s CSR structure: sparse adds and masks become axpys, the
    products and projections the compiled ones.  ``fmask`` (a bool per row,
    or None) keeps the root rows of the root-node form at zero in every
    update.  None (the caller then takes the generic route) for data that
    is not real float64, without the compiled library, or where T's
    pattern escapes ``pattern``."""
    from ..amg_core import constraint_project_native, masked_spgemm_native

    if np.iscomplexobj(A.data) or A.dtype != np.float64 \
            or np.iscomplexobj(B):
        return None
    P0 = to_csr(pattern)
    P0.sort_indices()
    T = to_csr(T)
    T.sort_indices()
    n, ncols = P0.shape
    indptr, indices = P0.indptr, P0.indices
    nnz = P0.nnz

    key_pat = indices.astype(np.int64) + np.int64(ncols) * np.repeat(
        np.arange(n, dtype=np.int64), np.diff(indptr))
    key_T = T.indices.astype(np.int64) + np.int64(ncols) * np.repeat(
        np.arange(n, dtype=np.int64), np.diff(T.indptr))
    pos = np.searchsorted(key_pat, key_T)
    if pos.max(initial=-1) >= nnz or not (key_pat[pos] == key_T).all():
        return None

    def view(vals):
        M = sp.csr_matrix((vals, indices, indptr), shape=(n, ncols))
        M.has_sorted_indices = True
        return M

    AT = masked_spgemm_native(A, T, P0)
    if AT is None:
        return None
    rows = np.repeat(np.arange(n), np.diff(indptr))
    Bd = np.ascontiguousarray(np.asarray(B), dtype=np.float64)
    Gd = np.ascontiguousarray(np.asarray(BtBinv), dtype=np.float64)
    dinv_e = np.asarray(Dinv)[rows]
    fmask_u8 = (None if fmask is None
                else np.ascontiguousarray(fmask, dtype=np.uint8))

    def project(vals):
        if constraint_project_native(vals, indptr, indices, Bd, Gd,
                                     fmask_u8):
            return vals
        # more than 16 candidates: the same projection in numpy
        if fmask is not None:
            vals = vals * fmask[rows]
        coef = np.einsum("nk,nkl->nl", np.asarray(view(vals) @ Bd), Gd)
        return vals - np.einsum("ek,ek->e", coef[rows], Bd[indices])

    tvals = np.zeros(nnz, dtype=A.dtype)
    tvals[pos] = T.data
    rvals = project(-AT.data)
    normr0 = max(np.abs(rvals).max(initial=0.0), 1e-300)
    pvals = tvals
    oldsum = 0.0
    ptvals = None
    for _ in range(maxiter):
        if np.abs(rvals).max(initial=0.0) < tol * normr0:
            break
        zvals = rvals * dinv_e
        newsum = float(rvals @ zvals)
        if newsum == 0:
            break
        ptvals = zvals if oldsum == 0 else \
            zvals + (newsum / oldsum) * ptvals
        oldsum = newsum
        ap = project(masked_spgemm_native(A, view(ptvals), P0).data)
        d = float(ptvals @ ap)
        if d == 0:
            break
        alpha = newsum / d
        pvals = pvals + alpha * ptvals
        rvals = rvals - alpha * ap
    return view(pvals.copy())


def _cg_prolongation(A, T, pattern, project, apply_Dinv, maxiter, tol):
    """The energy CG on scipy matrices: every iterate a sparse matrix on
    ``pattern``, masked products and sparse adds."""
    R = project((-(A @ T)).tocsr().multiply(pattern).tocsr())
    normr0 = max(abs(R).max() if R.nnz else 0.0, 1e-300)
    P = T
    oldsum = 0.0
    P_temp = None
    for _ in range(maxiter):
        if R.nnz == 0 or abs(R).max() < tol * normr0:
            break
        Z = apply_Dinv(R)
        newsum = _frob_inner(R, Z)
        if newsum == 0:
            break
        P_temp = Z if oldsum == 0 else \
            (Z + (newsum / oldsum) * P_temp).tocsr()
        oldsum = newsum
        AP = project(_masked_product(A, P_temp, pattern))
        d = _frob_inner(P_temp, AP)
        if d == 0:
            break
        alpha = newsum / d
        P = (P + alpha * P_temp).tocsr()
        R = (R - alpha * AP).tocsr()
    return P.tocsr()


def _cgnr_prolongation(A, T, pattern, project, apply_Dinv, maxiter, tol):
    """The energy minimization for a nonsymmetric A by CGNR: minimize
    ``||A P||_F`` over the pattern (the normal equations ``A^H A``), the
    gradient masked to the pattern and projected."""
    AH = A.conjugate().T.tocsr()
    R = (-(A @ T)).tocsr()                  # the unmasked residual of A P
    P = T

    def gradient(R):
        return project((AH @ R).tocsr().multiply(pattern).tocsr())

    G = gradient(R)
    normr0 = max(abs(G).max() if G.nnz else 0.0, 1e-300)
    oldsum = 0.0
    P_temp = None
    for _ in range(maxiter):
        if G.nnz == 0 or abs(G).max() < tol * normr0:
            break
        Z = apply_Dinv(G)
        newsum = _frob_inner(G, Z)
        if newsum == 0:
            break
        P_temp = Z if oldsum == 0 else \
            (Z + (newsum / oldsum) * P_temp).tocsr()
        oldsum = newsum
        AP = (A @ P_temp).tocsr()
        d = _frob_inner(AP, AP)
        if d == 0:
            break
        alpha = newsum / d
        P = (P + alpha * P_temp).tocsr()
        R = (R - alpha * AP).tocsr()
        G = gradient(R)
    return P.tocsr()


def _gmres_prolongation(A, T, pattern, project, apply_Dinv, maxiter, tol):
    """The energy minimization for a nonsymmetric A by ``maxiter`` steps of
    GMRES in the Frobenius inner product, every Krylov matrix masked to the
    pattern and projected; right-preconditioned by ``apply_Dinv``."""
    R = project((-(A @ T)).tocsr().multiply(pattern).tocsr())
    beta = np.sqrt(abs(_frob_inner(R, R)))
    if beta == 0:
        return T.tocsr()
    m = int(maxiter)
    V = [(1.0 / beta) * R]
    H = np.zeros((m + 1, m), dtype=complex if np.iscomplexobj(R.data)
                 else float)
    for j in range(m):
        W = project(_masked_product(A, apply_Dinv(V[j]), pattern))
        for i in range(j + 1):
            H[i, j] = _frob_inner(V[i], W)
            W = (W - H[i, j] * V[i]).tocsr()
        H[j + 1, j] = np.sqrt(abs(_frob_inner(W, W)))
        if H[j + 1, j] < 1e-14:
            m = j + 1
            break
        V.append((1.0 / H[j + 1, j]) * W)
    k = min(m, len(V))
    e1 = np.zeros(k + 1, dtype=H.dtype)
    e1[0] = beta
    y, *_ = np.linalg.lstsq(H[:k + 1, :k], e1, rcond=None)
    P = T.tocsr()
    for j in range(k):
        P = (P + y[j] * apply_Dinv(V[j])).tocsr()
    return P
