"""GMRES family: restarted GMRES and flexible GMRES over one Arnoldi
routine, and Householder GMRES.

Port of ``pyamg_tpu/krylov/_gmres.py``.  The Krylov basis lives on the
solve's device; each Arnoldi step orthogonalizes by modified Gram-Schmidt
with plain dot products and copies that step's Hessenberg column to the
host, where the Givens rotations, the projected residual and the small
triangular solve run in numpy.  ``restrt=None`` means no restart (the basis
spans the whole iteration budget), ``maxiter=None`` means ``min(n, 300)``.
The Householder variant is the reference's host implementation: its
reflector chain is sequential by construction.
"""

from __future__ import annotations

import numpy as np
import torch

from ._common import norm, prepare, real_dtype

__all__ = ["gmres", "gmres_mgs", "gmres_householder", "fgmres",
           "gmres_core", "restart_start", "restart_loop"]


def gmres(A, b, x0=None, tol=1e-5, restrt=None, maxiter=None, xtype=None,
          M=None, callback=None, residuals=None, orthog="mgs",
          device="cuda", **kwargs):
    """GMRES dispatcher: ``orthog='mgs'`` or ``'householder'``; returns
    (x, info), x a tensor on the solve's device.

    Examples
    --------
    >>> import numpy as np
    >>> from pyamg_tpu_torch.gallery import poisson
    >>> from pyamg_tpu_torch.krylov import gmres
    >>> A = poisson((10, 10), format='csr')
    >>> b = np.ones(A.shape[0])
    >>> x, info = gmres(A, b, tol=1e-8, maxiter=300, device="cpu")
    >>> bool(np.linalg.norm(b - A @ x.numpy()) < 1e-6 * np.linalg.norm(b))
    True
    """
    if orthog == "mgs":
        fn = gmres_mgs
    elif orthog == "householder":
        fn = gmres_householder
    else:
        raise ValueError(f"unknown orthogonalization {orthog!r}")
    return fn(A, b, x0=x0, tol=tol, restrt=restrt, maxiter=maxiter, M=M,
              callback=callback, residuals=residuals, device=device)


def _arnoldi_cycle(mv, pre, x, b, m, tol_t, flexible=False):
    """One restart cycle of at most ``m`` Arnoldi steps from ``x``: returns
    ``(x_new, res_hist, beta)``, ``res_hist`` the projected residual after
    each step taken (at least one) and ``beta`` the norm the cycle started
    from.

    Left-preconditioned GMRES on M A: the tracked residual is ``||M r||``.
    With ``flexible`` the preconditioned vectors Z are kept and the update
    uses them (right-preconditioned FGMRES): the tracked residual is the
    true ``||r||``."""
    n, dtype = b.shape[0], b.dtype
    npdt = torch.empty(0, dtype=dtype).numpy().dtype
    r = b - mv(x) if flexible else pre(b - mv(x))
    beta = float(norm(r).item())
    if beta == 0:           # nothing to correct (and no direction to take)
        return x, [0.0], beta

    V = torch.zeros((m + 1, n), dtype=dtype, device=b.device)
    Z = torch.zeros_like(V) if flexible else None
    V[0] = r / beta
    R = np.zeros((m + 1, m), dtype=npdt)        # the triangular factor
    g = np.zeros(m + 1, dtype=npdt)
    cs = np.zeros(m, dtype=npdt)
    sn = np.zeros(m, dtype=npdt)
    g[0] = beta
    res_hist = []

    j = 0
    while j < m and (j == 0 or res_hist[-1] > tol_t):
        if flexible:
            Z[j] = pre(V[j])
            w = mv(Z[j])
        else:
            w = pre(mv(V[j]))
        # modified Gram-Schmidt against V[0..j]
        dots = []
        for i in range(j + 1):
            hi = torch.vdot(V[i], w)
            w = w - hi * V[i]
            dots.append(hi)
        hj1 = norm(w)
        V[j + 1] = w / torch.where(hj1 == 0, 1, hj1)
        # the step's one device-to-host copy: the Hessenberg column
        h = torch.stack(dots + [hj1.to(dtype)]).cpu().numpy()

        # stored rotations 0..j-1, then the new one that zeroes h[j+1]
        for i in range(j):
            hi, hi1 = h[i], h[i + 1]
            h[i] = np.conj(cs[i]) * hi + np.conj(sn[i]) * hi1
            h[i + 1] = -sn[i] * hi + cs[i] * hi1
        denom = np.sqrt(np.abs(h[j]) ** 2 + np.abs(h[j + 1]) ** 2)
        if denom == 0:
            cs[j], sn[j] = 1.0, 0.0
        else:
            cs[j], sn[j] = h[j] / denom, h[j + 1] / denom
        h[j], h[j + 1] = denom, 0.0
        R[:j + 2, j] = h
        g[j + 1] = -sn[j] * g[j]
        g[j] = np.conj(cs[j]) * g[j]
        res_hist.append(float(np.abs(g[j + 1])))
        j += 1

    import scipy.linalg as sla

    y = sla.solve_triangular(R[:j, :j], g[:j], lower=False)
    basis = Z if flexible else V
    x_new = x + basis[:j].T @ torch.as_tensor(y, device=b.device)
    return x_new, res_hist, beta


def restart_loop(mv, pre, b, carry, tol_t, maxiter, restrt, max_outer,
                  flexible):
    """Restart cycles from ``carry = (x, it, res_buf, outer, last)`` until
    the tracked residual meets ``tol_t``, ``max_outer`` cycles ran or
    ``maxiter`` iterations were taken.  A later call continues the same
    carry exactly: a restart discards the basis anyway."""
    x, it, res_buf, outer, last = carry
    while last > tol_t and outer < max_outer and it < maxiter:
        x, res_hist, _beta = _arnoldi_cycle(mv, pre, x, b, restrt, tol_t,
                                            flexible=flexible)
        for k, res in enumerate(res_hist):
            # the last cycle may overrun maxiter: its tail shares one slot
            res_buf[min(it + 1 + k, maxiter)] = res
        it += len(res_hist)
        outer += 1
        last = res_hist[-1]
    return x, it, res_buf, outer, last


def restart_start(mv, x, b, maxiter):
    """The carry of :func:`restart_loop` before the first cycle."""
    res_buf = np.zeros(maxiter + 1, dtype=real_dtype(b.dtype))
    res_buf[0] = norm(b - mv(x)).item()
    return x, 0, res_buf, 0, float(res_buf[0])


def gmres_core(mv, pre, x, b, tol_t, maxiter, restrt=30, flexible=False):
    """Restarted GMRES core with the contract of ``cg_core``: returns
    ``(x, n_iters, res_buf)``.  ``res_buf[0]`` is the true starting
    residual, the later entries the tracked one."""
    restrt = int(min(restrt, b.shape[0], maxiter))
    max_outer = max(1, -(-int(maxiter) // restrt))
    x, it, res_buf, _outer, _last = restart_loop(
        mv, pre, b, restart_start(mv, x, b, maxiter), float(tol_t),
        maxiter, restrt, max_outer, flexible)
    return x, it, res_buf


def _gmres_like(A, b, x0, tol, restrt, maxiter, M, callback, residuals,
                flexible, device):
    n = np.shape(b)[0] if not isinstance(b, torch.Tensor) else b.numel()
    A, M, mv, pre, b, x, _ = prepare(A, b, x0, maxiter or n, M, device)
    n = b.shape[0]
    if maxiter is None:
        maxiter = min(n, 300)
    if restrt is None:
        restrt = min(n, int(maxiter))
    restrt = int(min(restrt, n))
    max_outer = max(1, -(-int(maxiter) // restrt))

    normb = float(norm(b).item())
    if normb == 0:
        normb = 1.0
    tol_t = tol * normb

    all_res = [float(norm(b - mv(x)).item())]
    for _ in range(max_outer):
        x, res_hist, beta = _arnoldi_cycle(mv, pre, x, b, restrt, tol_t,
                                           flexible=flexible)
        all_res.extend(res_hist)
        if res_hist[-1] <= tol_t or beta <= tol_t:
            break

    true_res = float(norm(b - mv(x)).item())
    if residuals is not None:
        residuals.extend(all_res)
    if callback is not None:
        callback(x)
    info = 0 if true_res <= tol * normb * 1.5 or all_res[-1] <= tol_t \
        else len(all_res) - 1
    return x, info


def gmres_mgs(A, b, x0=None, tol=1e-5, restrt=None, maxiter=None, xtype=None,
              M=None, callback=None, residuals=None, device="cuda"):
    """Restarted left-preconditioned GMRES with modified Gram-Schmidt;
    returns (x, info).  ``residuals`` takes the true starting residual and
    then the tracked ``||M r||``; ``info`` is 0 when the true final
    residual is within 1.5 times the tolerance."""
    return _gmres_like(A, b, x0, tol, restrt, maxiter, M, callback,
                       residuals, False, device)


def fgmres(A, b, x0=None, tol=1e-5, restrt=None, maxiter=None, xtype=None,
           M=None, callback=None, residuals=None, device="cuda"):
    """Flexible GMRES: the preconditioner may vary between iterations (an
    AMG cycle with nonsymmetric smoothing); returns (x, info)."""
    return _gmres_like(A, b, x0, tol, restrt, maxiter, M, callback,
                       residuals, True, device)


def gmres_householder(A, b, x0=None, tol=1e-5, restrt=None, maxiter=None,
                      xtype=None, M=None, callback=None, residuals=None,
                      device="cuda"):
    """Householder-orthogonalization GMRES; returns (x, info).  The
    reflector chain runs on the host in numpy; only the operator and the
    preconditioner are applied on the solve's device."""
    A, M, mv, pre, b_t, x_t, _ = prepare(A, b, x0, maxiter, M, device)
    dev = b_t.device

    def amv(v):
        return mv(torch.as_tensor(v, device=dev)).cpu().numpy().copy()

    def mop(v):
        return pre(torch.as_tensor(v, device=dev)).cpu().numpy().copy()

    b = b_t.cpu().numpy()
    n = b.shape[0]
    x = x_t.cpu().numpy().copy()
    if maxiter is None:
        maxiter = n
    if restrt is None:
        restrt = min(n, 30, maxiter)
    restrt = int(min(restrt, n))
    normb = np.linalg.norm(b)
    if normb == 0:
        normb = 1.0
    tol_t = tol * normb

    all_res = [float(np.linalg.norm(b - amv(x)))]
    max_outer = max(1, -(-int(maxiter) // restrt))

    for _ in range(max_outer):
        r = mop(b - amv(x))
        beta = np.linalg.norm(r)
        if beta <= tol_t:
            break
        m = restrt
        W = np.zeros((m + 1, n), dtype=r.dtype)      # Householder vectors
        H = np.zeros((m + 1, m), dtype=r.dtype)
        g = np.zeros(m + 1, dtype=r.dtype)
        cs = np.zeros(m + 1, dtype=r.dtype)
        sn = np.zeros(m + 1, dtype=r.dtype)

        # first reflector maps r to ||r|| e_0
        w = r.copy()
        alpha = -np.sign(w[0].real if w[0] != 0 else 1.0) * beta
        w[0] -= alpha
        nw = np.linalg.norm(w)
        if nw > 0:
            w /= nw
        W[0] = w
        g[0] = alpha

        k_done = 0
        for j in range(m):
            # v = P_0 ... P_j e_j
            v = np.zeros(n, dtype=r.dtype)
            v[j] = 1.0
            for i in range(j, -1, -1):
                v -= 2.0 * W[i] * np.vdot(W[i], v)
            v = mop(amv(v))
            # apply P_j ... P_0
            for i in range(j + 1):
                v -= 2.0 * W[i] * np.vdot(W[i], v)
            # new reflector to zero v below entry j+1
            if j + 1 < n:
                w = np.zeros(n, dtype=r.dtype)
                w[j + 1:] = v[j + 1:]
                nv = np.linalg.norm(v[j + 1:])
                if nv > 0:
                    alpha = -np.sign(v[j + 1].real if v[j + 1] != 0
                                     else 1.0) * nv
                    w[j + 1] -= alpha
                    nw = np.linalg.norm(w)
                    if nw > 0:
                        w /= nw
                    W[j + 1] = w
                    v -= 2.0 * w * np.vdot(w, v)
            H[:, j] = v[:m + 1]
            # apply stored Givens
            for i in range(j):
                hi, hi1 = H[i, j], H[i + 1, j]
                H[i, j] = np.conj(cs[i]) * hi + np.conj(sn[i]) * hi1
                H[i + 1, j] = -sn[i] * hi + cs[i] * hi1
            # new Givens
            denom = np.sqrt(np.abs(H[j, j]) ** 2 + np.abs(H[j + 1, j]) ** 2)
            if denom != 0:
                cs[j] = H[j, j] / denom
                sn[j] = H[j + 1, j] / denom
                H[j, j] = denom
                H[j + 1, j] = 0.0
                gj = g[j]
                g[j] = np.conj(cs[j]) * gj
                g[j + 1] = -sn[j] * gj
            k_done = j + 1
            all_res.append(float(np.abs(g[j + 1])))
            if np.abs(g[j + 1]) <= tol_t:
                break

        k = k_done
        y = np.linalg.solve(H[:k, :k], g[:k]) if k else np.zeros(0)
        # x update: sum_j y_j (P_0...P_j e_j)
        dx = np.zeros(n, dtype=r.dtype)
        for j in range(k - 1, -1, -1):
            dx[j] += y[j]
            dx -= 2.0 * W[j] * np.vdot(W[j], dx)
        x = x + dx
        if all_res[-1] <= tol_t:
            break

    if residuals is not None:
        residuals.extend(all_res)
    x_out = torch.as_tensor(x, device=dev)
    if callback is not None:
        callback(x_out)
    info = 0 if all_res[-1] <= tol_t else len(all_res) - 1
    return x_out, info
