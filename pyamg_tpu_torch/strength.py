"""Strength of connection (host, numpy/scipy).

Port of ``pyamg_tpu/strength.py``: the classical and symmetric measures
for scalar (CSR) and block (BSR) operators (a BSR input gives the strength
graph of its block rows: classical filters the scalar entries and then
amalgamates, symmetric measures the block Frobenius norms), the evolution
measure of Olson, Schroder and Tuminaro (weighted-Jacobi evolution of
delta functions, then a constrained fit of the near-nullspace per row,
batched over all rows), the energy-based measure, the coordinate distance
measure, the affinity and algebraic distances of relaxed random vectors,
and the distance filters.  The evolution measure's steps run in the
compiled ``amg_core`` library where it loaded.
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp

from .amg_core import (classical_strength_native, distance_filter_native,
                       evolution_epilogue_native, evolution_nulldim1_native,
                       identity_minus_colscaled_native,
                       identity_minus_scaled_native, masked_spgemm_native)
from .util.linalg import _rho_lanczos, approximate_spectral_radius, \
    pinv_array
from .util.utils import (amalgamate, get_block_diag, row_reduce, scale_rows,
                         scale_rows_by_largest_entry, to_csr)

__all__ = ["symmetric_strength_of_connection",
           "classical_strength_of_connection",
           "evolution_strength_of_connection",
           "energy_based_strength_of_connection",
           "distance_strength_of_connection", "affinity_distance",
           "algebraic_distance", "relaxation_vectors",
           "apply_distance_filter", "apply_absolute_distance_filter",
           "ode_strength_of_connection"]


def apply_distance_filter(C, epsilon):
    """A copy of the distance matrix C keeping the off-diagonal
    ``C_ij < epsilon * min_{k != i} C_ik``, with a unit diagonal."""
    C = C.tocsr().copy()
    if not np.iscomplexobj(C.data) and distance_filter_native(C, epsilon):
        C.eliminate_zeros()
        return C
    rows = np.repeat(np.arange(C.shape[0]), np.diff(C.indptr))
    offdiag = rows != C.indices
    dmin = row_reduce(np.where(offdiag, C.data.real, np.inf), C.indptr,
                      np.minimum, np.inf)
    keep = offdiag & (C.data.real < epsilon * dmin[rows])
    C.data = np.where(~offdiag, 1.0, np.where(keep, C.data, 0))
    C.eliminate_zeros()
    return C


def apply_absolute_distance_filter(C, theta):
    """A copy of the distance matrix C keeping the off-diagonal
    ``C_ij < theta``, with a unit diagonal."""
    C = C.tocsr().copy()
    rows = np.repeat(np.arange(C.shape[0]), np.diff(C.indptr))
    offdiag = rows != C.indices
    keep = offdiag & (C.data.real < theta)
    C.data = np.where(~offdiag, 1.0, np.where(keep, C.data, 0))
    C.eliminate_zeros()
    return C


def classical_strength_of_connection(A, theta=0.0):
    """Keep ``|A_ij| >= theta * max_{k != i} |A_ik|`` and the diagonal;
    returns ``|A|`` on that pattern with each row scaled so that its
    largest entry is 1.  A BSR input is filtered entry by entry and then
    amalgamated to one entry per stored block.

    Examples
    --------
    >>> from pyamg_tpu_torch.gallery import poisson
    >>> A = poisson((4, 4), format='csr')
    >>> classical_strength_of_connection(A, theta=0.25).nnz == A.nnz
    True
    """
    bs = A.blocksize[0] if sp.issparse(A) and A.format == "bsr" else 1
    A = to_csr(A)
    if theta < 0 or theta > 1:
        raise ValueError("expected theta in [0,1]")
    if bs == 1:
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
    if bs > 1:
        S = amalgamate(S, bs)
    S.data = np.abs(S.data)
    return scale_rows_by_largest_entry(S)


def symmetric_strength_of_connection(A, theta=0):
    """Keep ``|A_ij| >= theta * sqrt(|A_ii| |A_jj|)`` and the diagonal;
    returns ``|A|`` on that pattern with each row scaled so that its
    largest entry is 1.  For a BSR input the measure runs on the graph of
    its blocks, each weighted by its Frobenius norm.

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
        nb = A.shape[0] // A.blocksize[0]
        norms = np.sqrt((np.abs(A.data) ** 2).sum(axis=(1, 2)))
        A = sp.csr_matrix((norms, A.indices.copy(), A.indptr.copy()),
                          shape=(nb, nb))
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


def distance_strength_of_connection(A, V, theta=2.0, relative_drop=True):
    """Strength from the Euclidean distances of the coordinates ``V`` (one
    row per node) over A's pattern (of its blocks for BSR): distances
    below 1e-6 are taken as 1e-6, filtered relative to each row's nearest
    neighbour (``relative_drop``) or against ``theta``, then inverted."""
    if sp.issparse(A) and A.format == "bsr":
        sn = A.shape[0] // A.blocksize[0]
        A = sp.csr_matrix((np.ones(A.data.shape[0]), A.indices, A.indptr),
                          shape=(sn, sn))
    A = to_csr(A)
    V = np.asarray(V)
    rows = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr))
    d = np.sqrt(((V[rows] - V[A.indices]) ** 2).sum(axis=1))
    d[d < 1e-6] = 1e-6
    C = sp.csr_matrix((d, A.indices.copy(), A.indptr.copy()), shape=A.shape)
    if relative_drop:
        if theta != np.inf:
            C = apply_distance_filter(C, theta)
    else:
        C = apply_absolute_distance_filter(C, theta)
    C = C + sp.eye(C.shape[0], C.shape[1], format="csr")
    C.data = 1.0 / C.data
    return scale_rows_by_largest_entry(C)


def _masked_power(Atilde_T, nsquare, mask):
    """``(Atilde^T)^(2^nsquare)`` with the last product kept on ``mask``'s
    pattern only (the compiled masked product computes no other entry)."""
    M = Atilde_T
    for _ in range(max(nsquare - 1, 0)):
        M = (M @ M).tocsr()

    def ones_pattern():
        return sp.csr_matrix((np.ones(mask.nnz), mask.indices, mask.indptr),
                             shape=mask.shape)

    if nsquare > 0:
        native = masked_spgemm_native(M, M, mask)
        M = native if native is not None \
            else (M @ M).multiply(ones_pattern()).tocsr()
    else:
        M = M.multiply(ones_pattern()).tocsr()
    M.eliminate_zeros()
    M.sort_indices()
    return M


def evolution_strength_of_connection(A, B=None, epsilon=4.0, k=2,
                                     proj_type="l2", block_flag=False,
                                     symmetrize_measure=True,
                                     _masked_power_impl=None):
    """Evolution strength measure: evolve delta functions by ``k``
    weighted-Jacobi steps, ``(I - D^-1 A / rho(D^-1 A))^k``, and measure per
    row how well the near-nullspace ``B`` (constant when None) fits the
    evolved vector, under the constraint that the fit is exact at the row's
    own node (``proj_type`` "l2", or "D_A" weighting by A's diagonal).
    Misfits are filtered against ``epsilon`` times the row's smallest,
    symmetrized (``symmetrize_measure``) and inverted into strengths.
    ``block_flag`` scales a BSR input by its inverted diagonal blocks.
    ``_masked_power_impl(Atilde_T, nsquare, mask)`` replaces the masked
    matrix powers (the device setup runs them on the card).

    Examples
    --------
    >>> from pyamg_tpu_torch.gallery import poisson
    >>> A = poisson((8, 8), format='csr')
    >>> evolution_strength_of_connection(A, k=2, epsilon=4.0).shape
    (64, 64)
    """
    if epsilon < 1.0:
        raise ValueError("expected epsilon > 1.0")
    if k <= 0:
        raise ValueError("number of time steps must be > 0")
    if proj_type not in ("l2", "D_A"):
        raise ValueError("proj_type must be 'l2' or 'D_A'")

    bsr_in = sp.issparse(A) and A.format == "bsr"
    numPDEs = A.blocksize[0] if bsr_in else 1
    Bmat = np.ones((A.shape[0], 1), dtype=A.dtype) if B is None \
        else np.asarray(B).reshape(A.shape[0], -1)

    D = A.diagonal()
    Dinv = Dinv_A = None
    if bsr_in and block_flag:
        blocks = get_block_diag(A, blocksize=numPDEs, inv_flag=True)
        nb = blocks.shape[0]
        Dinv_A = (sp.bsr_matrix((blocks, np.arange(nb), np.arange(nb + 1)),
                                shape=A.shape) @ A).tocsr()
    else:
        Dinv = np.zeros_like(D)
        nz = D != 0
        Dinv[nz] = 1.0 / D[nz]
        Dinv[~nz] = 1.0
    A = to_csr(A)
    if A.nnz and not A.data.all():
        A.eliminate_zeros()
    A.sort_indices()

    def dinv_a():
        return Dinv_A if Dinv_A is not None else scale_rows(A, Dinv)

    n = A.shape[1]
    null_dim = Bmat.shape[1]

    # rho(D^-1 A) to ~1%: for an exactly symmetric A (checked by two
    # products) with a positive diagonal it equals rho(D^-1/2 A D^-1/2),
    # estimated by Lanczos on float32 products; otherwise Arnoldi
    rho = None
    sym_probe = np.inf
    if (not np.iscomplexobj(A.data) and numPDEs == 1
            and A.shape[0] == A.shape[1] and (D > 0).all()):
        xp = np.random.default_rng(1).standard_normal(A.shape[0])
        y1, y2 = A @ xp, A.T @ xp
        sym_probe = float(np.abs(y1 - y2).max()) \
            / (float(np.abs(y1).max()) or 1.0)
        if sym_probe <= 1e-8:
            from scipy.sparse.linalg import LinearOperator

            s = (1.0 / np.sqrt(D)).astype(np.float32)
            A32 = sp.csr_matrix((A.data.astype(np.float32), A.indices,
                                 A.indptr), shape=A.shape)
            rho = _rho_lanczos(LinearOperator(
                A.shape, dtype=np.float32,
                matvec=lambda z: s * (A32 @ (s * z))))
    if rho is None:
        Dinv_A = dinv_a()
        rho = approximate_spectral_radius(
            Dinv_A.astype(np.float32) if Dinv_A.dtype == np.float64
            else Dinv_A)

    D_A = np.asarray(D) if proj_type == "D_A" \
        else np.ones(n, dtype=A.dtype)
    nsquare = int(np.log2(k))
    ninc = k - 2 ** nsquare

    # (I - D^-1 A / rho)^T: for an A whose probe products agree bit for
    # bit, I - A D^-1 / rho in one pass over A's own arrays; else from the
    # CSC arrays of D^-1 A (the CSR arrays of its transpose)
    Atilde = None
    if sym_probe == 0.0 and Dinv is not None:
        Sx = identity_minus_colscaled_native(A, Dinv, 1.0 / rho)
        if Sx is not None:
            Atilde = sp.csr_matrix((Sx, A.indices, A.indptr), shape=(n, n))
    if Atilde is None:
        W = dinv_a().tocsc()
        W.sort_indices()
        Sx = identity_minus_scaled_native(W, 1.0 / rho)
        if Sx is not None:
            Atilde = sp.csr_matrix((Sx, W.indices, W.indptr), shape=(n, n))
        else:
            Atilde = sp.csr_matrix(((-1.0 / rho) * W.data, W.indices,
                                    W.indptr), shape=(n, n))
            rows_t = np.repeat(np.arange(n), np.diff(Atilde.indptr))
            on_diag = rows_t == Atilde.indices
            if int(on_diag.sum()) == n:
                Atilde.data[on_diag] += 1.0
            else:
                Atilde = (sp.eye(n, n, format="csr", dtype=A.dtype)
                          + Atilde).tocsr()

    # the mask: A's pattern, restricted to couplings of the same PDE
    mask = A
    if numPDEs > 1:
        mask = A.copy()
        pde = np.repeat(np.mod(np.arange(n), numPDEs), np.diff(mask.indptr))
        mask.data[np.mod(mask.indices, numPDEs) != pde] = 0.0
        mask.eliminate_zeros()

    if ninc > 0:
        warnings.warn("evolution strength is most efficient for k a power "
                      f"of two; got k={k}")
        step = Atilde
        for _ in range(nsquare):
            Atilde = (Atilde @ Atilde).tocsr()
        for _ in range(ninc):
            Atilde = (Atilde @ step).tocsr()
        Atilde = Atilde.multiply(sp.csr_matrix(
            (np.ones(mask.nnz), mask.indices, mask.indptr),
            shape=mask.shape)).tocsr()
        Atilde.eliminate_zeros()
        Atilde.sort_indices()
    else:
        Atilde = (_masked_power_impl or _masked_power)(Atilde, nsquare, mask)

    if null_dim == 1:
        # one candidate b: the constraint pins the fit to z_i / b_i, so the
        # fitted value at column j is b_j z_i / b_i and the quality of the
        # connection its relative misfit |1 - zhat_j / z_j|
        b1 = np.ravel(Bmat).copy()
        b1[b1 == 0] = 1.0
        tiny = np.sqrt(np.finfo(float).eps)
        Atilde.sort_indices()
        if not np.iscomplexobj(b1) and \
                evolution_nulldim1_native(Atilde, b1, tiny):
            Atilde.eliminate_zeros()
            return _evolution_epilogue(Atilde, epsilon, symmetrize_measure,
                                       bsr_in, numPDEs)
        coeff = Atilde.diagonal() / b1
        row_of = np.repeat(np.arange(n), np.diff(Atilde.indptr))
        z = Atilde.data
        zhat = coeff[row_of] * b1[Atilde.indices]
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = zhat / z
        misfit = np.abs(1.0 - ratio)
        # a fit against the evolved value, or vanishing beside it: weak
        aligned = (zhat.real * z.real + zhat.imag * z.imag) >= 0.0
        significant = np.abs(ratio) >= 1e-4
        Atilde.data = np.where(aligned & significant, misfit, 0.0)
        Atilde.eliminate_zeros()
        Atilde.data[Atilde.data < tiny] = 1e-4
    else:
        Atilde = _evolution_constrained_min(Atilde, Bmat, D_A)

    return _evolution_epilogue(Atilde, epsilon, symmetrize_measure, bsr_in,
                               numPDEs)


def _evolution_epilogue(Atilde, epsilon, symmetrize_measure, bsr_in=False,
                        numPDEs=1):
    """Distance filter, symmetrization, unit diagonal, the block minimum of
    a BSR input and the inversion into strengths: the tail of the
    evolution measure (one compiled call for a scalar input)."""
    n = Atilde.shape[1]
    Atilde.data = np.asarray(np.real(Atilde.data), dtype=float)
    if not bsr_in:
        Atilde.sort_indices()
        native = evolution_epilogue_native(Atilde, epsilon,
                                           symmetrize_measure)
        if native is not None:
            return native

    if epsilon != np.inf:
        Atilde = apply_distance_filter(Atilde, epsilon)
    if symmetrize_measure:
        Atilde = (0.5 * (Atilde + Atilde.T)).tocsr()
    rows = np.repeat(np.arange(n), np.diff(Atilde.indptr))
    on_diag = rows == Atilde.indices
    if int(on_diag.sum()) == n:
        Atilde.data[on_diag] = 1.0
    else:
        Atilde = (Atilde + (sp.eye(n, n, format="csr") - sp.dia_matrix(
            (Atilde.diagonal()[None, :], [0]), shape=Atilde.shape))).tocsr()
    if bsr_in:
        # the smallest nonzero magnitude of each block
        Ab = Atilde.tobsr(blocksize=(numPDEs, numPDEs))
        mags = np.abs(Ab.data.reshape(Ab.data.shape[0], -1))
        mins = np.where(mags > 0, mags, np.inf).min(axis=1)
        mins[~np.isfinite(mins)] = 0.0
        Atilde = sp.csr_matrix((mins, Ab.indices, Ab.indptr),
                               shape=(Ab.shape[0] // numPDEs,
                                      Ab.shape[1] // numPDEs))
        Atilde.eliminate_zeros()
    with np.errstate(divide="ignore"):
        Atilde.data = 1.0 / Atilde.data
    return scale_rows_by_largest_entry(Atilde.tocsr())


def _evolution_constrained_min(Atilde, B, D_A):
    """The evolution measure's fit for K > 1 candidates, batched over all
    rows padded to the longest: per row i, ``min ||z - B x||_{D_A}`` subject
    to ``(B x)_i = z_i`` through the pseudo-inverse of its (K+1)x(K+1) KKT
    matrix; the value at column j is ``|1 - zhat_j / z_j|`` (1e-4 below
    sqrt(eps), 0 for a fit against z or vanishing beside it, 1 on the
    diagonal and on rows of at most K entries)."""
    Atilde = Atilde.tocsr()
    Atilde.sort_indices()
    n = Atilde.shape[0]
    K = B.shape[1]
    nnz_row = np.diff(Atilde.indptr)
    L = int(nnz_row.max()) if n else 0
    eps_of = {np.dtype(np.float32): 1e3 * np.finfo(np.float32).eps,
              np.dtype(np.complex64): 1e3 * np.finfo(np.float32).eps}
    tol = eps_of.get(np.dtype(Atilde.dtype), 1e6 * np.finfo(np.float64).eps)

    rows = np.repeat(np.arange(n), nnz_row)
    offs = np.arange(Atilde.nnz) - np.repeat(Atilde.indptr[:-1], nnz_row)
    z = np.zeros((n, L), dtype=Atilde.dtype)
    cols = np.zeros((n, L), dtype=np.int64)
    valid = np.zeros((n, L), dtype=bool)
    z[rows, offs] = Atilde.data
    cols[rows, offs] = Atilde.indices
    valid[rows, offs] = True
    Bp = B[cols] * valid[:, :, None]                      # (n, L, K)
    Dp = D_A[cols] * valid                                # (n, L)

    # [[2 B^H D B, B^H D e_i], [e_i^T B, 0]]
    lhs = np.zeros((n, K + 1, K + 1),
                   dtype=np.result_type(B.dtype, Atilde.dtype))
    lhs[:, :K, :K] = 2.0 * np.einsum("nlk,nl,nlm->nkm", Bp.conj(), Dp, Bp)
    lhs[:, :K, K] = (B.conj() * D_A[:, None]).conj()
    lhs[:, K, :K] = B
    rhs = np.zeros((n, K + 1), dtype=lhs.dtype)
    rhs[:, :K] = 2.0 * np.einsum("nlk,nl,nl->nk", Bp.conj(), Dp, z)
    on_diag = (cols == np.arange(n)[:, None]) & valid
    rhs[:, K] = np.where(on_diag.any(axis=1),
                         np.where(on_diag, z, 0).sum(axis=1), 1.0)

    x = np.einsum("nij,nj->ni", pinv_array(lhs), rhs)[:, :K]
    zhat = np.einsum("nlk,nk->nl", Bp, x)
    # drop the numerically zero parts of zhat
    tol_i = tol * np.abs(zhat).max(axis=1, keepdims=True)
    re = np.where(np.abs(zhat.real) < tol_i, 0.0, zhat.real)
    if np.iscomplexobj(zhat):
        zhat = re + 1j * np.where(np.abs(zhat.imag) < tol_i, 0.0, zhat.imag)
    else:
        zhat = re

    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(z != 0, zhat / np.where(z != 0, z, 1), 0.0)
    err = np.abs(1.0 - ratio)
    val = np.where(err < np.sqrt(np.finfo(float).eps), 1e-4, err)
    val = np.where(np.abs(ratio) ** 2 <= 1e-8, 0.0, val)
    val = np.where(zhat.real * z.real + zhat.imag * z.imag < 0.0, 0.0, val)
    val = np.where(cols == np.arange(n)[:, None], 1.0, val)
    val = np.where(nnz_row[:, None] <= K, 1.0, val)

    out = Atilde.copy()
    out.data = val[rows, offs].astype(out.dtype)
    out.eliminate_zeros()
    return out


def energy_based_strength_of_connection(A, theta=0.0, k=2):
    """Energy-based measure (Brannick et al.): ``k + 1`` weighted-Jacobi
    steps from 0 approximate the columns of A^-1; the strength of (i, j) is
    the relative change of column i's A-energy when its entry j is zeroed,
    then the classical measure with ``theta`` on those values."""
    if theta < 0:
        raise ValueError("expected a positive theta")
    if k < 0 or not isinstance(k, int):
        raise ValueError("expected positive integer k")
    bsr = sp.issparse(A) and A.format == "bsr"
    numPDEs = A.blocksize[0] if bsr else 1

    A = to_csr(A)
    Atilde = A.copy()
    Acsc = A.tocsc()
    D = A.diagonal()
    Dinv = np.where(D != 0, 1.0 / np.where(D != 0, D, 1), 0.0)
    Dinv_mat = sp.dia_matrix((Dinv[None, :], [0]), shape=A.shape).tocsc()
    omega = 1.0 / approximate_spectral_radius(Dinv_mat @ Acsc)

    S = sp.csc_matrix(A.shape, dtype=A.dtype)
    eye = sp.eye(A.shape[0], format="csc")
    for _ in range(k + 1):
        S = S + omega * (Dinv_mat @ (eye - Acsc @ S))
    S = S.tocsc()

    for i in range(Atilde.shape[0]):
        v = np.asarray(S[:, i].todense()).ravel().copy()
        denom = np.sqrt(np.abs(np.vdot(v, Acsc @ v)))
        if denom == 0:
            denom = 1.0
        for jj in range(Atilde.indptr[i], Atilde.indptr[i + 1]):
            col = Atilde.indices[jj]
            vj = v[col]
            v[col] = 0.0
            val = np.sqrt(np.abs(np.vdot(v, Acsc @ v))) / denom - 1.0
            Atilde.data[jj] = abs(val) if val > -0.01 else 0.0
            v[col] = vj

    Atilde = classical_strength_of_connection(Atilde, theta=theta)
    Atilde.eliminate_zeros()
    Atilde = (Atilde + sp.eye(A.shape[0], format="csr")).tocsr()
    Atilde.sort_indices()
    if bsr:
        Ab = Atilde.tobsr(blocksize=(numPDEs, numPDEs))
        Atilde = sp.csr_matrix((np.ones(Ab.indices.shape[0]), Ab.indices,
                                Ab.indptr),
                               shape=(Ab.shape[0] // numPDEs,
                                      Ab.shape[1] // numPDEs))
    return scale_rows_by_largest_entry(Atilde)


def relaxation_vectors(A, R, k, alpha, seed=None):
    """``R`` random vectors (uniform in [-0.5, 0.5) from ``seed``), each
    relaxed ``k`` times on ``A x = 0`` by weighted Jacobi with ``alpha``."""
    from .relaxation.relaxation import jacobi

    n = A.shape[0]
    x = np.random.default_rng(seed).random((n, R)) - 0.5
    b = np.zeros(n)
    for r in range(R):
        xr = x[:, r].copy()
        jacobi(A, xr, b, iterations=k, omega=alpha)
        x[:, r] = xr
    return x


def _distance_measure(A, func, alpha, R, k, epsilon, seed=None):
    x = relaxation_vectors(A, R, k, alpha, seed=seed)
    rows, cols = A.nonzero()
    d = np.asarray(func(x, rows, cols), dtype=float)
    d[rows == cols] = 0
    C = sp.csr_matrix((d, (rows, cols)), shape=A.shape)
    C.eliminate_zeros()
    C = apply_distance_filter(C, epsilon)
    C.eliminate_zeros()
    with np.errstate(divide="ignore"):
        C.data = 1.0 / C.data
    C = (C + sp.eye(C.shape[0], format="csr")).tocsr()
    return scale_rows_by_largest_entry(C)


def _check_distance_args(alpha, R, k, epsilon):
    if alpha < 0:
        raise ValueError("expected alpha>0")
    if R <= 0 or not isinstance(R, int):
        raise ValueError("expected integer R>0")
    if k <= 0 or not isinstance(k, int):
        raise ValueError("expected integer k>0")
    if epsilon < 1:
        raise ValueError("expected epsilon>1.0")


def affinity_distance(A, alpha=0.5, R=5, k=20, epsilon=4.0, seed=None):
    """Affinity strength (Livne and Brandt): ``1 - (x_i . x_j)^2 /
    (|x_i|^2 |x_j|^2)`` over ``R`` relaxed random vectors, filtered and
    inverted."""
    A = to_csr(A)
    _check_distance_args(alpha, R, k, epsilon)

    def distance(x, rows, cols):
        num = np.sum(x[rows] * x[cols], axis=1) ** 2
        den = np.sum(x[rows] ** 2, axis=1) * np.sum(x[cols] ** 2, axis=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            return 1 - num / den

    return _distance_measure(A, distance, alpha, R, k, epsilon, seed)


def algebraic_distance(A, alpha=0.5, R=5, k=20, epsilon=2.0, p=2, seed=None):
    """Algebraic distance (Safro, Sanders and Schulz): the p-norm mean of
    ``|x_i - x_j|`` over ``R`` relaxed random vectors (the maximum for
    ``p = inf``), filtered and inverted."""
    A = to_csr(A)
    _check_distance_args(alpha, R, k, epsilon)
    if p < 1:
        raise ValueError("expected p>=1 or numpy.inf")

    def distance(x, rows, cols):
        if p != np.inf:
            return (np.sum(np.abs(x[rows] - x[cols]) ** p, axis=1) / R) \
                ** (1.0 / p)
        return np.abs(x[rows] - x[cols]).max(axis=1)

    return _distance_measure(A, distance, alpha, R, k, epsilon, seed)


def ode_strength_of_connection(*args, **kwargs):
    """Deprecated name of :func:`evolution_strength_of_connection`."""
    warnings.warn("ode_strength_of_connection is deprecated; use "
                  "evolution_strength_of_connection", DeprecationWarning)
    return evolution_strength_of_connection(*args, **kwargs)
