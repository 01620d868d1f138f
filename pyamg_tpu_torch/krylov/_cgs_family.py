"""CR, CGNE, CGNR, steepest descent, minimal residual, BiCGStab.

Port of ``pyamg_tpu/krylov/_cgs_family.py``: each core is a Python loop over
tensors with the reference's iterate sequence, stopping rule (residual
above the tolerance and iterations left), zero-denominator guards and
residual bookkeeping, and returns ``(x, n_iters, res_buf)`` like
``cg_core``.
"""

from __future__ import annotations

import numpy as np
import torch

from ._common import (finalize, make_rmatvec, norm, prepare, real_dtype,
                      tolerance)

__all__ = ["cr", "cgne", "cgnr", "steepest_descent", "minimal_residual",
           "bicgstab", "cr_core", "cgnr_core", "cgne_core",
           "steepest_descent_core", "minimal_residual_core",
           "bicgstab_core"]


def _guard(d):
    """d, with 1 in place of an exact zero (a breakdown keeps the iterate
    finite, as in the reference)."""
    return torch.where(d == 0, 1, d)


def _iterate(step, state, res0, b, tol_t, maxiter):
    """Run ``state, r = step(state)`` until the norm of r meets ``tol_t``
    or ``maxiter`` steps were taken; ``state[0]`` is the iterate.  Returns
    ``(x, n_iters, res_buf)``."""
    rdt = real_dtype(b.dtype)
    tol = rdt.type(tol_t)
    res_buf = np.zeros(maxiter + 1, dtype=rdt)
    res_buf[0] = norm(res0).item()
    it = 0
    while res_buf[it] > tol and it < maxiter:
        state, r = step(state)
        it += 1
        res_buf[it] = norm(r).item()
    return state[0], it, res_buf


def cr_core(mv, pre, x, b, tol_t, maxiter):
    """Preconditioned conjugate-residual core."""
    r0 = b - mv(x)
    r = pre(r0)
    Ar = mv(r)

    def step(state):
        x, r, p, Ar, Ap, rAr = state
        MAp = pre(Ap)
        alpha = rAr / _guard(torch.vdot(Ap, MAp))
        x = x + alpha * p
        r = r - alpha * MAp
        Ar = mv(r)
        rAr_new = torch.vdot(r, Ar)
        beta = rAr_new / _guard(rAr)
        return (x, r, r + beta * p, Ar, Ar + beta * Ap, rAr_new), r

    return _iterate(step, (x, r, r, Ar, Ar, torch.vdot(r, Ar)), r0, b,
                    tol_t, maxiter)


def cgnr_core(mv, rmv, pre, x, b, tol_t, maxiter):
    """CGNR core: left-preconditioned normal residual equations
    ``M A^H A x = M A^H b`` (z = M rhat, alpha = <z, rhat>/<Ap, Ap>)."""
    r = b - mv(x)
    rhat = rmv(r)
    z = pre(rhat)

    def step(state):
        x, r, p, zr = state
        Ap = mv(p)
        alpha = zr / _guard(torch.vdot(Ap, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        rhat = rmv(r)
        z = pre(rhat)
        zr_new = torch.vdot(z, rhat)
        return (x, r, z + (zr_new / _guard(zr)) * p, zr_new), r

    return _iterate(step, (x, r, z, torch.vdot(z, rhat)), r, b, tol_t,
                    maxiter)


def cgne_core(mv, rmv, pre, x, b, tol_t, maxiter):
    """CGNE core: Craig's method on ``M A A^H y = M b`` (z = M r,
    p = A^H z + beta p, alpha = <z, r>/<p, p>)."""
    r = b - mv(x)
    z = pre(r)

    def step(state):
        x, r, p, zr = state
        alpha = zr / _guard(torch.vdot(p, p))
        x = x + alpha * p
        r = r - alpha * mv(p)
        z = pre(r)
        zr_new = torch.vdot(z, r)
        return (x, r, rmv(z) + (zr_new / _guard(zr)) * p, zr_new), r

    return _iterate(step, (x, r, rmv(z), torch.vdot(z, r)), r, b, tol_t,
                    maxiter)


def steepest_descent_core(mv, pre, x, b, tol_t, maxiter):
    """Preconditioned steepest-descent core."""
    r = b - mv(x)

    def step(state):
        x, r = state
        z = pre(r)
        Az = mv(z)
        alpha = torch.vdot(z, r) / _guard(torch.vdot(z, Az))
        r = r - alpha * Az
        return (x + alpha * z, r), r

    return _iterate(step, (x, r), r, b, tol_t, maxiter)


def minimal_residual_core(mv, pre, x, b, tol_t, maxiter):
    """Minimal-residual core (on the preconditioned residual)."""
    r0 = b - mv(x)

    def step(state):
        x, r = state
        Ar = pre(mv(r))
        alpha = torch.vdot(Ar, r) / _guard(torch.vdot(Ar, Ar))
        r_new = r - alpha * Ar
        return (x + alpha * r, r_new), r_new

    return _iterate(step, (x, pre(r0)), r0, b, tol_t, maxiter)


def bicgstab_core(mv, pre, x, b, tol_t, maxiter):
    """BiCGStab core; the shadow residual is the starting residual."""
    r = b - mv(x)
    rhat = r

    def step(state):
        x, r, p, rho = state
        phat = pre(p)
        v = mv(phat)
        alpha = rho / _guard(torch.vdot(rhat, v))
        s = r - alpha * v
        shat = pre(s)
        t = mv(shat)
        omega = torch.vdot(t, s) / _guard(torch.vdot(t, t))
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho_new = torch.vdot(rhat, r)
        beta = (rho_new / _guard(rho)) * (alpha / _guard(omega))
        return (x, r, r + beta * (p - omega * v), rho_new), r

    return _iterate(step, (x, r, r, torch.vdot(rhat, r)), r, b, tol_t,
                    maxiter)


def _solve(core, A, b, x0, tol, maxiter, M, callback, residuals, device,
           normal=False):
    """The public contract around a core; ``normal`` cores also take
    ``v -> A^H v``."""
    A0 = A
    A, M, mv, pre, b, x, maxiter = prepare(A, b, x0, maxiter, M, device)
    tol_t = tolerance(tol, b)
    if normal:
        rmv = make_rmatvec(A if hasattr(A, "rmatvec") else A0, b.device)
        x, it, res_buf = core(mv, rmv, pre, x, b, tol_t, maxiter)
    else:
        x, it, res_buf = core(mv, pre, x, b, tol_t, maxiter)
    return finalize(x, res_buf, it + 1, float(tol_t), callback, residuals)


def cr(A, b, x0=None, tol=1e-5, maxiter=None, xtype=None, M=None,
       callback=None, residuals=None, device="cuda"):
    """Conjugate residual method (Hermitian, possibly indefinite A);
    returns (x, info)."""
    return _solve(cr_core, A, b, x0, tol, maxiter, M, callback, residuals,
                  device)


def cgnr(A, b, x0=None, tol=1e-5, maxiter=None, xtype=None, M=None,
         callback=None, residuals=None, device="cuda"):
    """CG on the normal residual equations A^H A x = A^H b (CGLS); ``M``
    preconditions the normal system (z = M A^H r).  Returns (x, info)."""
    return _solve(cgnr_core, A, b, x0, tol, maxiter, M, callback, residuals,
                  device, normal=True)


def cgne(A, b, x0=None, tol=1e-5, maxiter=None, xtype=None, M=None,
         callback=None, residuals=None, device="cuda"):
    """CG on the normal error equations A A^H y = b (Craig's method); ``M``
    preconditions the normal system (z = M r).  Returns (x, info)."""
    return _solve(cgne_core, A, b, x0, tol, maxiter, M, callback, residuals,
                  device, normal=True)


def steepest_descent(A, b, x0=None, tol=1e-5, maxiter=None, xtype=None,
                     M=None, callback=None, residuals=None, device="cuda"):
    """Preconditioned steepest descent; returns (x, info)."""
    return _solve(steepest_descent_core, A, b, x0, tol, maxiter, M, callback,
                  residuals, device)


def minimal_residual(A, b, x0=None, tol=1e-5, maxiter=None, xtype=None,
                     M=None, callback=None, residuals=None, device="cuda"):
    """Minimal residual iteration; returns (x, info)."""
    return _solve(minimal_residual_core, A, b, x0, tol, maxiter, M, callback,
                  residuals, device)


def bicgstab(A, b, x0=None, tol=1e-5, maxiter=None, xtype=None, M=None,
             callback=None, residuals=None, device="cuda"):
    """BiCGStab for nonsymmetric systems; returns (x, info)."""
    return _solve(bicgstab_core, A, b, x0, tol, maxiter, M, callback,
                  residuals, device)
