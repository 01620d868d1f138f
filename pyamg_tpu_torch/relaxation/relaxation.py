"""Host relaxation methods (numpy/scipy), in place on ``x``.

Port of ``make_system``, ``gauss_seidel``, ``jacobi``, ``sor``,
``polynomial``, ``block_jacobi``, ``block_gauss_seidel``,
``gauss_seidel_indexed``, the normal-equation relaxations ``jacobi_ne``,
``gauss_seidel_ne`` (Kaczmarz; compiled where ``amg_core`` loaded) and
``gauss_seidel_nr``, and the scalar line relaxations ``zebra``,
``line_gauss_seidel`` and ``line_jacobi`` (exact tridiagonal solves along
one grid axis; compiled Thomas solves where ``amg_core`` loaded) from
``pyamg_tpu/relaxation/relaxation.py``.  They
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

from ..amg_core import (bsr_gauss_seidel_native,
                        gauss_seidel_indexed_native,
                        gauss_seidel_kaczmarz_native,
                        gauss_seidel_sweeps_native, thomas_lines_native)
from ..util.utils import get_block_diag, to_csr

__all__ = ["make_system", "sor", "gauss_seidel", "jacobi", "polynomial",
           "block_jacobi", "block_gauss_seidel", "gauss_seidel_indexed",
           "jacobi_ne", "gauss_seidel_ne", "gauss_seidel_nr",
           "zebra", "line_gauss_seidel", "line_jacobi"]

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


def jacobi_ne(A, x, b, iterations=1, omega=1.0):
    """Jacobi on the normal equations, in the normal-residual form of the
    JAX package's host method: ``x += omega D^{-1} A^H (b - A x)`` with D
    the squared column norms of A.  (The device smoother of the same name
    scales the residual by the squared row norms before applying A^H.)"""
    A, x_v, b_v = make_system(A, x, b)
    A = A.tocsr()
    d = np.asarray(A.multiply(A.conjugate()).sum(axis=0)).ravel().real
    mask = d != 0
    dinv = np.zeros(A.shape[1])
    dinv[mask] = 1.0 / d[mask]
    for _ in range(iterations):
        x_v += omega * dinv * (A.conjugate().T @ (b_v - A @ x_v))
    return _store(x, x_v)


def _ordered_passes(one_pass, n, iterations, sweep):
    for _ in range(iterations):
        if sweep in ("forward", "symmetric"):
            one_pass(range(n))
        if sweep in ("backward", "symmetric"):
            one_pass(range(n - 1, -1, -1))


def gauss_seidel_ne(A, x, b, iterations=1, sweep="forward", omega=1.0):
    """Gauss-Seidel on ``A A^H`` (Kaczmarz): row projections in turn,
    ``x += omega (b_i - a_i x) / |a_i|^2 a_i^H``.  A real float64 forward
    sweep runs the compiled one where the library loaded."""
    A, x_v, b_v = make_system(A, x, b)
    A = A.tocsr()
    _check_sweep(sweep)
    if A.dtype == np.float64 and x_v.dtype == np.float64 \
            and sweep == "forward":
        ok = True
        for _ in range(iterations):
            ok &= gauss_seidel_kaczmarz_native(A, x_v, b_v, omega)
        if ok:
            return _store(x, x_v)
    indptr, cols, data = A.indptr, A.indices, A.data
    row_norms = np.asarray(A.multiply(A.conjugate()).sum(axis=1)).ravel().real

    def one_pass(order):
        for i in order:
            if row_norms[i] == 0:
                continue
            s, e = indptr[i], indptr[i + 1]
            ri = b_v[i] - data[s:e] @ x_v[cols[s:e]]
            x_v[cols[s:e]] += omega * (ri / row_norms[i]) \
                * data[s:e].conjugate()

    _ordered_passes(one_pass, A.shape[0], iterations, sweep)
    return _store(x, x_v)


def gauss_seidel_nr(A, x, b, iterations=1, sweep="forward", omega=1.0):
    """Gauss-Seidel on ``A^H A``: column updates in turn, each minimizing
    the residual along its column, ``x_j += omega a_j^H r / |a_j|^2``."""
    A, x_v, b_v = make_system(A, x, b)
    _check_sweep(sweep)
    Ac = A.tocsc()
    indptr, rows, data = Ac.indptr, Ac.indices, Ac.data
    col_norms = np.asarray(A.multiply(A.conjugate()).sum(axis=0)).ravel().real
    r = b_v - A @ x_v

    def one_pass(order):
        for j in order:
            if col_norms[j] == 0:
                continue
            s, e = indptr[j], indptr[j + 1]
            delta = omega * (data[s:e].conjugate() @ r[rows[s:e]]) \
                / col_norms[j]
            x_v[j] += delta
            r[rows[s:e]] -= delta * data[s:e]

    _ordered_passes(one_pass, A.shape[1], iterations, sweep)
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
    """Block Gauss-Seidel, sequential over block rows (the compiled sweep
    for real float64); 1x1 blocks are scalar Gauss-Seidel."""
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
    if (data.dtype == np.float64 and Dinv.dtype == np.float64
            and x_v.dtype == np.float64):
        xc = np.ascontiguousarray(x_v)
        done = True
        for _ in range(iterations):
            if sweep in ("forward", "symmetric"):
                done &= bsr_gauss_seidel_native(indptr, indices, data, Dinv,
                                                xc, b_v, bs, 0, nb, 1)
            if sweep in ("backward", "symmetric"):
                done &= bsr_gauss_seidel_native(indptr, indices, data, Dinv,
                                                xc, b_v, bs, nb - 1, -1, -1)
            if not done:
                break
        if done:
            return _store(x, xc)
        x_v = xc           # no library: the Python sweep from here
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


def _usable_grid(A, grid):
    """``grid`` (default ``A.grid``) as a tuple when it describes A's rows,
    else None."""
    if grid is None:
        grid = getattr(A, "grid", None)
    if grid is None or int(np.prod(grid)) != A.shape[0]:
        return None
    return tuple(int(g) for g in grid)


def zebra(A, x, b, iterations=1, sweep="symmetric", grid=None, axis=None,
          omega=1.0):
    """Zebra line relaxation, in place: exact tridiagonal solves along one
    grid axis (``axis``, default the most strongly coupled), first the even
    lines and then the odd ones ("forward"; the reverse for "backward",
    both for "symmetric").  ``grid`` defaults to ``A.grid``; without a grid
    that describes A it is symmetric Gauss-Seidel."""
    A, x_v, b_v = make_system(A, x, b)
    grid = _usable_grid(A, grid)
    if grid is None:
        return gauss_seidel(A, x, b, iterations=iterations,
                            sweep="symmetric")
    lines, unlines, _solve, solve_phase = _line_setup(A, grid, axis)
    phases = (0, 1) if sweep in ("forward", "symmetric") else (1, 0)
    for _ in range(iterations):
        for ph in phases:
            x_v += omega * unlines(solve_phase(lines(b_v - A @ x_v), ph))
    return _store(x, x_v)


def _line_setup(A, grid, axis):
    """The line machinery of a grid operator: ``(lines, unlines,
    solve_lines, solve_phase)`` for the tridiagonal lines along ``axis``
    (default: the axis of the largest coupling).  ``lines`` reshapes a
    vector to (nlines, L), ``unlines`` back; ``solve_lines`` solves every
    line, ``solve_phase(R, ph)`` the lines of parity ``ph`` (zeros on the
    others)."""
    n = A.shape[0]
    d = len(grid)
    strides = [int(np.prod(grid[k + 1:])) for k in range(d)]
    if axis is None:
        axis = int(np.argmax([np.abs(A.diagonal(s)).sum() for s in strides]))
    axis = axis % d
    stride = strides[axis]
    L = grid[axis]

    d_flat = A.diagonal().copy()
    d_flat[d_flat == 0] = 1.0
    du_flat = np.zeros(n, dtype=A.dtype)
    du_flat[:n - stride] = A.diagonal(stride)
    dl_flat = np.zeros(n, dtype=A.dtype)
    dl_flat[stride:] = A.diagonal(-stride)
    coords = np.unravel_index(np.arange(n), grid)
    du_flat[coords[axis] == L - 1] = 0.0
    dl_flat[coords[axis] == 0] = 0.0

    def lines(v):
        return np.moveaxis(v.reshape(grid), axis, -1).reshape(-1, L)

    def unlines(M):
        shp = tuple(grid[k] for k in range(d) if k != axis) + (L,)
        return np.moveaxis(M.reshape(shp), -1, axis).ravel()

    dl, dm, du = lines(dl_flat), lines(d_flat), lines(du_flat)
    parity = np.arange(dm.shape[0]) % 2
    real = not np.iscomplexobj(dm)
    tri = tuple(np.ascontiguousarray(t, dtype=np.float64)
                for t in (dl, dm, du)) if real else None

    def solve_lines(R):
        if tri is not None and not np.iscomplexobj(R):
            xp = np.array(R, dtype=np.float64, order="C", copy=True)
            if thomas_lines_native(*tri, xp):
                return xp
        cp = np.zeros_like(dm)
        xp = np.zeros_like(R)
        cp[:, 0] = du[:, 0] / dm[:, 0]
        xp[:, 0] = R[:, 0] / dm[:, 0]
        for i in range(1, L):
            den = dm[:, i] - dl[:, i] * cp[:, i - 1]
            den = np.where(den == 0, 1.0, den)
            cp[:, i] = du[:, i] / den
            xp[:, i] = (R[:, i] - dl[:, i] * xp[:, i - 1]) / den
        for i in range(L - 2, -1, -1):
            xp[:, i] -= cp[:, i] * xp[:, i + 1]
        return xp

    # each parity's lines contiguous: a half-sweep solves only its own
    tri_ph = None if tri is None else tuple(
        tuple(np.ascontiguousarray(t[ph::2]) for t in tri) for ph in (0, 1))

    def solve_phase(R, ph):
        if tri_ph is not None and not np.iscomplexobj(R):
            Rp = np.array(R[ph::2], dtype=np.float64, order="C", copy=True)
            if thomas_lines_native(*tri_ph[ph], Rp):
                out = np.zeros(R.shape, dtype=Rp.dtype)
                out[ph::2] = Rp
                return out
        xp = solve_lines(R)
        xp[parity != ph] = 0.0
        return xp

    return lines, unlines, solve_lines, solve_phase


def line_gauss_seidel(A, x, b, iterations=1, sweep="symmetric", grid=None,
                      axis=None):
    """Even/odd line Gauss-Seidel: :func:`zebra`."""
    return zebra(A, x, b, iterations=iterations, sweep=sweep, grid=grid,
                 axis=axis)


def line_jacobi(A, x, b, iterations=1, grid=None, axis=None, omega=0.7):
    """Damped line Jacobi, in place: every line solved from one residual;
    weighted Jacobi without a grid that describes A."""
    A, x_v, b_v = make_system(A, x, b)
    grid = _usable_grid(A, grid)
    if grid is None:
        return jacobi(A, x, b, iterations=iterations, omega=omega)
    lines, unlines, solve_lines, _phase = _line_setup(A, grid, axis)
    for _ in range(iterations):
        x_v += omega * unlines(solve_lines(lines(b_v - A @ x_v)))
    return _store(x, x_v)
