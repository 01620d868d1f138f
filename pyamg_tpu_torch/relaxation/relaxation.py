"""Host relaxation methods (numpy/scipy), in place on ``x``.

Port of ``make_system``, ``gauss_seidel``, ``jacobi``, ``sor``,
``polynomial``, ``block_jacobi``, ``block_gauss_seidel`` and
``gauss_seidel_indexed`` from ``pyamg_tpu/relaxation/relaxation.py``.  They
serve the setup phase (``improve_candidates``), the iterative coarse
solvers and, in the tests, the lexicographic oracle of the device
smoothers.  Real float64 Gauss-Seidel runs the compiled in-place sweeps of
``amg_core`` where the library loaded; every other dtype, and every dtype
without it, takes sparse triangular solves in delta form, equal to the
sweeps to round-off.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.linalg import spsolve_triangular

from ..amg_core import (gauss_seidel_indexed_native,
                        gauss_seidel_sweeps_native)
from ..util.utils import get_block_diag, to_csr

__all__ = ["make_system", "sor", "gauss_seidel", "jacobi", "polynomial",
           "block_jacobi", "block_gauss_seidel", "gauss_seidel_indexed"]

_SWEEPS = ("forward", "backward", "symmetric")


def _check_sweep(sweep):
    if sweep not in _SWEEPS:
        raise ValueError("valid sweep directions: forward/backward/"
                         f"symmetric, got {sweep!r}")


def make_system(A, x, b):
    """Validate shapes and dtypes; returns ``(A, x, b)`` with A as CSR (or
    BSR) and x, b raveled."""
    if not sp.issparse(A):
        A = to_csr(A)
    else:
        A = A.tocsr() if A.format not in ("csr", "bsr") else A
    x = np.ravel(np.asarray(x))
    b = np.ravel(np.asarray(b))
    if A.shape[0] != A.shape[1]:
        raise ValueError("expected square matrix")
    if A.shape[0] != x.size or A.shape[0] != b.size:
        raise ValueError("A, x and b must have matching dimensions")
    if x.dtype != A.dtype and np.iscomplexobj(A.data) \
            and not np.iscomplexobj(x):
        raise ValueError("x and A must have compatible dtypes")
    if not np.issubdtype(x.dtype, np.inexact):
        # the sweeps update x in place; an integer x cannot hold the result
        raise TypeError(f"x must be a float/complex array, got {x.dtype}")
    return A, x, b


def _store(x, x_v):
    np.asarray(x).reshape(-1)[:] = x_v
    return x


def _fix_zero_diag(T, r):
    """Gauss-Seidel skips a row with a zero (or missing) diagonal: in delta
    form ``dx[i] = 0``, so that row of T becomes the unit row and its rhs
    entry 0."""
    zero = T.diagonal() == 0
    if zero.any():
        unit = sp.dia_matrix((zero.astype(T.dtype)[None, :], [0]),
                             shape=T.shape)
        keep = sp.dia_matrix(((~zero).astype(T.dtype)[None, :], [0]),
                             shape=T.shape)
        T = keep @ T + unit
        r = np.where(zero, 0, r)
    return T.tocsr(), r


def _tri_solve(A, r, lower):
    """``(D + L)^{-1} r`` (``lower``) or ``(D + U)^{-1} r``."""
    T = sp.tril(A, 0) if lower else sp.triu(A, 0)
    T, r = _fix_zero_diag(T.tocsr(), r)
    return spsolve_triangular(T, r, lower=lower)


def gauss_seidel(A, x, b, iterations=1, sweep="forward"):
    """In-place Gauss-Seidel: ``(D + L) x_{k+1} = b - U x_k`` (forward).

    Examples
    --------
    >>> import numpy as np
    >>> from pyamg_tpu_torch.gallery import poisson
    >>> A = poisson((10, 10), format='csr')
    >>> b, x = np.ones(A.shape[0]), np.zeros(A.shape[0])
    >>> r0 = np.linalg.norm(b - A @ x)
    >>> _ = gauss_seidel(A, x, b, iterations=5)
    >>> bool(np.linalg.norm(b - A @ x) < r0)
    True
    """
    A, x_v, b_v = make_system(A, x, b)
    A = A.tocsr()
    _check_sweep(sweep)
    if A.dtype == np.float64 and x_v.dtype == np.float64 \
            and gauss_seidel_sweeps_native(A, x_v, b_v, iterations, sweep):
        return _store(x, x_v)
    for _ in range(iterations):
        if sweep in ("forward", "symmetric"):
            x_v += _tri_solve(A, b_v - A @ x_v, lower=True)
        if sweep in ("backward", "symmetric"):
            x_v += _tri_solve(A, b_v - A @ x_v, lower=False)
    return _store(x, x_v)


def sor(A, x, b, omega, iterations=1, sweep="forward"):
    """Successive over-relaxation:
    ``(D/omega + L) x_{k+1} = b - (U + (1 - 1/omega) D) x_k``."""
    A, x_v, b_v = make_system(A, x, b)
    A = A.tocsr()
    _check_sweep(sweep)
    D = sp.dia_matrix((A.diagonal()[None, :], [0]), shape=A.shape).tocsr()
    for _ in range(iterations):
        if sweep in ("forward", "symmetric"):
            M = (sp.tril(A, -1) + D / omega).tocsr()
            x_v += spsolve_triangular(M, b_v - A @ x_v, lower=True)
        if sweep in ("backward", "symmetric"):
            M = (sp.triu(A, 1) + D / omega).tocsr()
            x_v += spsolve_triangular(M, b_v - A @ x_v, lower=False)
    return _store(x, x_v)


def jacobi(A, x, b, iterations=1, omega=1.0):
    """Weighted Jacobi: ``x += omega D^{-1} (b - A x)``."""
    A, x_v, b_v = make_system(A, x, b)
    d = A.diagonal()
    mask = d != 0
    dinv = np.zeros_like(d)
    dinv[mask] = 1.0 / d[mask]
    for _ in range(iterations):
        x_v += omega * dinv * (b_v - A @ x_v)
    return _store(x, x_v)


def polynomial(A, x, b, coefficients, iterations=1):
    """Polynomial smoother ``x += p(A) r`` by Horner's rule; coefficients in
    descending order."""
    A, x_v, b_v = make_system(A, x, b)
    for _ in range(iterations):
        r = b_v - A @ x_v
        h = coefficients[0] * r
        for c in coefficients[1:]:
            h = c * r + A @ h
        x_v += h
    return _store(x, x_v)


def block_jacobi(A, x, b, Dinv=None, blocksize=1, iterations=1, omega=1.0):
    """Block weighted Jacobi with the batched inverse of the diagonal
    blocks."""
    A, x_v, b_v = make_system(A, x, b)
    bs = int(blocksize)
    if Dinv is None:
        Dinv = get_block_diag(A, bs, inv_flag=True)
    n_blocks = A.shape[0] // bs
    for _ in range(iterations):
        r = (b_v - A @ x_v).reshape(n_blocks, bs)
        x_v += omega * np.einsum("nij,nj->ni", Dinv, r).reshape(-1)
    return _store(x, x_v)


def block_gauss_seidel(A, x, b, Dinv=None, blocksize=1, iterations=1,
                       sweep="forward"):
    """Block Gauss-Seidel, sequential over block rows; 1x1 blocks are
    scalar Gauss-Seidel."""
    bs = int(blocksize)
    if bs == 1 and Dinv is None:
        return gauss_seidel(A, x, b, iterations=iterations, sweep=sweep)
    A, x_v, b_v = make_system(A, x, b)
    _check_sweep(sweep)
    if Dinv is None:
        Dinv = get_block_diag(A, bs, inv_flag=True)
    Dinv = np.asarray(Dinv)
    B = sp.bsr_matrix(A, blocksize=(bs, bs))
    nb = B.shape[0] // bs
    indptr, indices, data = B.indptr, B.indices, B.data
    xb = x_v.reshape(nb, bs)
    bb = b_v.reshape(nb, bs)

    def one_pass(order):
        for i in order:
            rhs = bb[i].copy()
            for jj in range(indptr[i], indptr[i + 1]):
                j = indices[jj]
                if j != i:
                    rhs -= data[jj] @ xb[j]
            xb[i] = Dinv[i] @ rhs

    for _ in range(iterations):
        if sweep in ("forward", "symmetric"):
            one_pass(range(nb))
        if sweep in ("backward", "symmetric"):
            one_pass(range(nb - 1, -1, -1))
    return _store(x, x_v)


def gauss_seidel_indexed(A, x, b, indices, iterations=1, sweep="forward"):
    """Gauss-Seidel restricted to, and ordered by, an index list."""
    A, x_v, b_v = make_system(A, x, b)
    A = A.tocsr()
    _check_sweep(sweep)
    indices = np.asarray(indices, dtype=np.int64)
    if A.dtype == np.float64 and x_v.dtype == np.float64:
        done = True
        for _ in range(iterations):
            if sweep in ("forward", "symmetric"):
                done &= gauss_seidel_indexed_native(A, x_v, b_v, indices)
            if sweep in ("backward", "symmetric"):
                done &= gauss_seidel_indexed_native(A, x_v, b_v,
                                                    indices[::-1])
        if done:
            return _store(x, x_v)
    indptr, cols, data = A.indptr, A.indices, A.data

    def one_pass(order):
        for i in order:
            s, e = indptr[i], indptr[i + 1]
            row_cols, row_data = cols[s:e], data[s:e]
            on_diag = row_cols == i
            diag = row_data[on_diag].sum()
            if diag != 0:
                rsum = row_data[~on_diag] @ x_v[row_cols[~on_diag]]
                x_v[i] = (b_v[i] - rsum) / diag

    for _ in range(iterations):
        if sweep in ("forward", "symmetric"):
            one_pass(indices)
        if sweep in ("backward", "symmetric"):
            one_pass(indices[::-1])
    return _store(x, x_v)
