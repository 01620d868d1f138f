"""Preconditioned conjugate gradient.

Port of ``cg_core`` and ``cg`` (``pyamg_tpu/krylov/_cg.py``): a Python loop
over tensors with the same iterate sequence and the same zero-denominator
guards.  The stopping test reads one scalar from the device per iteration;
nothing else synchronizes.
"""

from __future__ import annotations

import numpy as np
import torch

from ._common import finalize, norm, prepare, real_dtype, tolerance

__all__ = ["cg", "cg_core"]


def cg_core(mv, pre, x, b, tol_t, maxiter):
    """PCG from ``x`` until ``res <= tol_t`` or ``maxiter`` iterations.

    Returns ``(x, n_iters, res_buf)``: ``res_buf[j]`` is the residual norm
    after j iterations (a host array of b's real dtype, length
    ``maxiter + 1``, zero past ``n_iters``)."""
    rdt = real_dtype(b.dtype)
    tol = rdt.type(tol_t)
    res_buf = np.zeros(maxiter + 1, dtype=rdt)

    r = b - mv(x)
    z = pre(r)
    p = z
    rz = torch.vdot(r, z)
    res_buf[0] = norm(r).item()
    it = 0
    while res_buf[it] > tol and it < maxiter:
        Ap = mv(p)
        pAp = torch.vdot(p, Ap)
        alpha = rz / torch.where(pAp == 0, 1, pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = pre(r)
        rz_new = torch.vdot(r, z)
        beta = rz_new / torch.where(rz == 0, 1, rz)
        p = z + beta * p
        rz = rz_new
        it += 1
        res_buf[it] = norm(r).item()
    return x, it, res_buf


def cg(A, b, x0=None, tol=1e-5, maxiter=None, xtype=None, M=None,
       callback=None, residuals=None, device="cuda"):
    """Solve SPD/HPD A x = b with preconditioned CG; returns (x, info),
    x a tensor on the solve's device.

    Examples
    --------
    >>> import numpy as np
    >>> from pyamg_tpu_torch.gallery import poisson
    >>> from pyamg_tpu_torch.krylov import cg
    >>> A = poisson((10, 10), format='csr')
    >>> b = np.ones(A.shape[0])
    >>> x, info = cg(A, b, tol=1e-8, maxiter=300, device="cpu")
    >>> bool(info == 0 and
    ...      np.linalg.norm(b - A @ x.numpy()) < 1e-6 * np.linalg.norm(b))
    True
    """
    A, M, mv, pre, b, x, maxiter = prepare(A, b, x0, maxiter, M, device)
    tol_t = tolerance(tol, b)
    x, it, res_buf = cg_core(mv, pre, x, b, tol_t, maxiter)
    return finalize(x, res_buf, it + 1, float(tol_t), callback, residuals)
