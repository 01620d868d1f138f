"""Host linear algebra for setup: vector norm, spectral-radius estimates and
the batched pseudo-inverse of small blocks.

Port of ``pyamg_tpu/util/linalg.py`` (``norm``, ``infinity_norm``,
``residual_norm``, ``approximate_spectral_radius``, ``_rho_lanczos``,
``condest``, ``cond``, ``ishermitian``, ``pinv_array``), unchanged numpy:
the same ``default_rng(seed)`` start vectors give the same estimates, hence
the same smoother coefficients and prolongation damping, and the same
random probes give ``ishermitian`` the same answer (it picks the black-box
solver's route).
"""

from __future__ import annotations

import numpy as np

__all__ = ["norm", "infinity_norm", "residual_norm",
           "approximate_spectral_radius", "condest", "cond", "ishermitian",
           "pinv_array"]


def norm(x, pnorm="2"):
    """Vector norm: ``"2"`` in a dot-product formulation, or ``"inf"``."""
    x = np.asarray(x).ravel()
    if pnorm == "2":
        return float(np.sqrt(np.inner(x.conjugate(), x).real))
    if pnorm == "inf":
        return float(np.abs(x).max()) if x.size else 0.0
    raise ValueError(f"unknown norm {pnorm!r}")


def infinity_norm(A):
    """``||A||_inf``: the largest row sum of ``|A|``."""
    import scipy.sparse as sp

    if sp.issparse(A):
        return float(abs(A).sum(axis=1).max())
    return float(np.abs(np.asarray(A)).sum(axis=1).max())


def residual_norm(A, x, b):
    """``||b - A x||_2``."""
    return norm(np.ravel(b) - A @ np.ravel(x))


def _matvec(A):
    if hasattr(A, "matvec"):
        return A.matvec
    return lambda v: A @ v


def approximate_spectral_radius(A, tol=0.01, maxiter=15, restart=5,
                                symmetric=None, return_vector=False,
                                seed=0):
    """Approximate the spectral radius |λ|_max of A via restarted Arnoldi
    (Lanczos when ``symmetric``).  Cached on ``A.rho`` when the object
    allows attribute assignment."""
    cached = getattr(A, "rho", None)
    if cached is not None and not return_vector:
        return cached

    if symmetric and not return_vector:
        rho = _rho_lanczos(A, maxiter=max(maxiter, 15), seed=seed)
        try:
            A.rho = rho
        except (AttributeError, TypeError):
            pass
        return rho

    n = A.shape[0]
    mv = _matvec(A)
    rng = np.random.default_rng(seed)
    dtype = np.result_type(getattr(A, "dtype", np.float64), np.float32)
    v0 = rng.standard_normal(n).astype(dtype, copy=False)
    if np.issubdtype(dtype, np.complexfloating):
        v0 = v0 + 1j * rng.standard_normal(n)

    k = min(maxiter, n)
    rho = 0.0
    vec = v0
    for _ in range(max(1, restart)):
        V = np.zeros((k + 1, n), dtype=dtype)
        H = np.zeros((k + 1, k), dtype=np.promote_types(dtype, np.float64))
        nv = norm(vec)
        if nv == 0:
            vec = rng.standard_normal(n)
            nv = norm(vec)
        V[0] = vec / nv
        m = k
        for j in range(k):
            w = mv(V[j])
            w = np.asarray(w, dtype=V.dtype).ravel()
            # CGS2 orthogonalization in two BLAS-2 products per pass
            Vj = V[:j + 1]
            h1 = Vj.conj() @ w
            w = w - Vj.T @ h1
            h2 = Vj.conj() @ w
            w -= Vj.T @ h2
            H[:j + 1, j] = h1 + h2
            H[j + 1, j] = norm(w)
            if H[j + 1, j] < 1e-14:
                m = j + 1
                break
            V[j + 1] = w / H[j + 1, j]
        Hm = H[:m, :m]
        evals, evecs = np.linalg.eig(Hm)
        imax = int(np.argmax(np.abs(evals)))
        new_rho = float(np.abs(evals[imax]))
        vec = (V[:m].T @ evecs[:, imax])
        if not np.iscomplexobj(np.zeros(0, dtype=V.dtype)):
            # real operator: restart with the real part of the Ritz vector
            vec = np.real(vec)
        if rho > 0 and abs(new_rho - rho) / new_rho < tol:
            rho = new_rho
            break
        rho = new_rho

    try:
        A.rho = rho
    except (AttributeError, TypeError):
        pass
    if return_vector:
        return rho, vec
    return rho


def _rho_lanczos(A, maxiter=15, seed=0):
    """|λ|_max of a symmetric/Hermitian operator via the Lanczos 3-term
    recurrence: one matvec and O(n) work per step."""
    n = A.shape[0]
    import scipy.sparse as _sp
    if _sp.issparse(A) and A.dtype == np.float64:
        # ~1% accuracy target: f32 matvecs are 2x cheaper on bandwidth
        A = A.astype(np.float32)
    mv = _matvec(A)
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n).astype(
        getattr(A, "dtype", np.float64), copy=False)
    v /= np.linalg.norm(v)
    v_prev = np.zeros_like(v)
    alphas, betas = [], []
    beta = 0.0
    for _ in range(min(maxiter, n)):
        w = np.asarray(mv(v)).ravel()
        alpha = float(np.real(np.vdot(v, w)))
        w = w - alpha * v - beta * v_prev
        beta = float(np.linalg.norm(w))
        alphas.append(alpha)
        betas.append(beta)
        if beta < 1e-14:
            break
        v_prev = v
        v = w / beta
    T = np.diag(alphas)
    off = betas[:-1][:len(alphas) - 1]
    if off:
        T = T + np.diag(off, 1) + np.diag(off, -1)
    evals = np.linalg.eigvalsh(T)
    return float(np.abs(evals).max())


def condest(A, maxiter=25, symmetric=False):
    """Estimate of ``cond_2(A)``: exact from the singular values of a dense
    or small sparse matrix (up to 2000 rows), else the spectral radius
    estimate (a bound, as in the JAX package)."""
    import scipy.sparse as sp

    if sp.issparse(A) and A.shape[0] <= 2000:
        A = A.toarray()
    if isinstance(A, np.ndarray):
        return cond(A)
    return float(approximate_spectral_radius(A, maxiter=maxiter))


def cond(A):
    """Exact 2-norm condition number, from the singular values of the
    dense form."""
    A = A.toarray() if hasattr(A, "toarray") else np.asarray(A)
    s = np.linalg.svd(A, compute_uv=False)
    smin = s[s > 0].min() if (s > 0).any() else 0.0
    return float(s.max() / smin) if smin else np.inf


def ishermitian(A, fast_check=True, tol=1e-6, seed=0):
    """Whether ``A`` equals ``A^H``: with ``fast_check`` by comparing
    ``<A x, y>`` with ``<x, A y>`` on two random probes of
    ``default_rng(seed)``, else entry by entry to ``tol``.

    Examples
    --------
    >>> import numpy as np
    >>> bool(ishermitian(np.array([[1.0, 2.0], [2.0, 1.0]])))
    True
    >>> bool(ishermitian(np.array([[1.0, 2.0], [0.0, 1.0]])))
    False
    """
    import scipy.sparse as sp

    if fast_check:
        rng = np.random.default_rng(seed)
        x = rng.random(A.shape[0])
        y = rng.random(A.shape[0])
        if np.iscomplexobj(getattr(A, "dtype", np.float64).type(0)):
            x = x + 1j * rng.random(A.shape[0])
            y = y + 1j * rng.random(A.shape[0])
        diff = abs(np.vdot(A @ x, y) - np.vdot(x, A @ y))
        scale = max(abs(np.vdot(A @ x, y)), 1e-300)
        return bool(diff / scale < tol)
    if sp.issparse(A):
        diff = abs(A - A.conjugate().T)
        if diff.nnz == 0:
            return True
        return bool(diff.max() < tol)
    A = np.asarray(A)
    return bool(np.abs(A - A.conjugate().T).max() < tol)


def _pinv_svd(a, rcond):
    """Stacked-SVD pseudo-inverse, block by block if LAPACK fails on the
    stack."""
    try:
        return np.linalg.pinv(a, rcond=rcond)
    except np.linalg.LinAlgError:
        out = np.empty_like(a)
        for i in range(a.shape[0]):
            out[i] = np.linalg.pinv(a[i], rcond=rcond)
        return out


def pinv_array(a, tol=None):
    """Batched pseudo-inverse of n (m, m) blocks.

    m = 1 is a guarded reciprocal and m in {2, 3} the closed-form adjugate
    inverse; a block whose ``|det|`` cannot certify every singular value
    above the cutoff (``|det| > rc * ||A||_F^m``) goes to the stacked SVD,
    so rank-deficient blocks keep pseudo-inverse semantics."""
    a = np.asarray(a)
    if a.shape[0] == 0:
        return np.empty_like(a)
    m = a.shape[-1]
    rc = tol if tol is not None else 1e-13
    if m == 1:
        nz = a != 0
        return np.where(nz, 1.0 / np.where(nz, a, 1.0), 0.0)
    if m not in (2, 3):
        return _pinv_svd(a, rc)
    normF = np.sqrt((np.abs(a) ** 2).sum(axis=(-2, -1)))
    adj = np.empty_like(a)
    if m == 2:
        det = a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0]
        adj[:, 0, 0] = a[:, 1, 1]
        adj[:, 1, 1] = a[:, 0, 0]
        adj[:, 0, 1] = -a[:, 0, 1]
        adj[:, 1, 0] = -a[:, 1, 0]
    else:
        def cof(i1, i2, j1, j2):
            return a[:, i1, j1] * a[:, i2, j2] - a[:, i1, j2] * a[:, i2, j1]

        adj[:, 0, 0] = cof(1, 2, 1, 2)
        adj[:, 1, 0] = -cof(1, 2, 0, 2)
        adj[:, 2, 0] = cof(1, 2, 0, 1)
        adj[:, 0, 1] = -cof(0, 2, 1, 2)
        adj[:, 1, 1] = cof(0, 2, 0, 2)
        adj[:, 2, 1] = -cof(0, 2, 0, 1)
        adj[:, 0, 2] = cof(0, 1, 1, 2)
        adj[:, 1, 2] = -cof(0, 1, 0, 2)
        adj[:, 2, 2] = cof(0, 1, 0, 1)
        det = (a[:, 0, 0] * adj[:, 0, 0] + a[:, 0, 1] * adj[:, 1, 0]
               + a[:, 0, 2] * adj[:, 2, 0])
    ok = np.abs(det) > rc * normF ** m
    if not ok.any():
        return _pinv_svd(a, rc)
    out = adj * (1.0 / np.where(ok, det, 1.0))[:, None, None]
    if not ok.all():
        out[~ok] = _pinv_svd(a[~ok], rc)
    return out
