"""Host linear algebra for setup: vector norm and spectral-radius estimates.

Port of ``pyamg_tpu/util/linalg.py`` (``norm``,
``approximate_spectral_radius``, ``_rho_lanczos``), unchanged numpy: the same
``default_rng(seed)`` start vectors give the same estimates, hence the same
smoother coefficients and prolongation damping.
"""

from __future__ import annotations

import numpy as np

__all__ = ["norm", "approximate_spectral_radius"]


def norm(x):
    """2-norm in a dot-product formulation."""
    x = np.asarray(x).ravel()
    return float(np.sqrt(np.inner(x.conjugate(), x).real))


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
