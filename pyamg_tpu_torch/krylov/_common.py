"""Shared pieces of the Krylov methods: operator and preconditioner
closures, argument preparation, the vector norm and the uniform ``(A, b,
x0, tol, maxiter, M, callback, residuals) -> (x, info)`` contract.

Port of ``make_matvec``, ``make_rmatvec``, ``identity_M``, ``prepare``,
``norm`` and ``finalize`` from ``pyamg_tpu/krylov/_common.py``.  The JAX
package compiles each method into one ``while_loop`` program and needs
machinery to pass operators into it; here every method is a Python loop
over tensors that reads one scalar per iteration for its stopping test, so
that machinery has no counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["make_matvec", "make_rmatvec", "identity_M", "prepare", "norm",
           "tolerance", "finalize", "real_dtype"]


def real_dtype(dtype):
    """numpy dtype of the real part of a torch dtype."""
    return torch.empty(0, dtype=dtype).real.numpy().dtype


def _device_of(A, b, device):
    """Where a solve runs: the operator's device where it has one, else a
    tensor b's, else the ``device`` argument."""
    dev = getattr(A, "device", None)
    if isinstance(dev, (torch.device, str)):
        return torch.device(dev)
    if isinstance(b, torch.Tensor):
        return b.device
    return torch.device(device)


def _takes_tensors(op):
    """False for a scipy ``LinearOperator`` whose ``matvec`` is scipy's own
    (numpy in, numpy out); the port's operators and the hierarchy's
    preconditioner take tensors."""
    from scipy.sparse.linalg import LinearOperator

    return not (isinstance(op, LinearOperator)
                and type(op).matvec is LinearOperator.matvec)


def _through_host(mv):
    """Wrap a numpy-only ``matvec`` to take and return tensors."""
    def wrapped(v):
        out = np.asarray(mv(v.cpu().numpy())).reshape(-1)
        return torch.as_tensor(out, device=v.device).to(v.dtype)
    return wrapped


def _device_form(A, device):
    """A scipy sparse matrix as a device operator; anything else as is."""
    import scipy.sparse as sp

    if sp.issparse(A):
        from ..sparse import device_operator

        return device_operator(A.tocsr(), device=device)
    return A


def make_matvec(A, device="cuda"):
    """``v -> A v`` on tensors, from a port operator (``SparseDIA``,
    ``SparseELL``, a linop), any object with ``matvec``, a callable, a
    scipy sparse matrix (converted by ``device_operator`` onto ``device``)
    or a dense array."""
    if callable(A) and not hasattr(A, "matvec"):
        return A
    A = _device_form(A, device)
    mv = getattr(A, "matvec", None)
    if mv is not None:
        return mv if _takes_tensors(A) else _through_host(mv)
    Ad = torch.as_tensor(np.asarray(A), device=device)
    return lambda v: Ad @ v


def make_rmatvec(A, device="cuda"):
    """``v -> A^H v`` on tensors: the operator's own ``rmatvec``, a device
    operator of the conjugate transpose of a scipy sparse matrix, or the
    conjugate transpose of a dense array."""
    if hasattr(A, "rmatvec") and _takes_tensors(A):
        return A.rmatvec
    import scipy.sparse as sp

    if sp.issparse(A):
        return make_matvec(A.conjugate().T.tocsr(), device)
    if hasattr(A, "rmatvec"):
        return _through_host(A.rmatvec)
    if not callable(A) and not hasattr(A, "matvec"):
        AH = torch.as_tensor(np.asarray(A), device=device).conj().T
        return lambda v: AH @ v
    raise ValueError("operator does not support rmatvec (A^H v)")


def identity_M(M, device="cuda"):
    """The preconditioner closure ``r -> M r`` (the identity for None)."""
    if M is None:
        return lambda r: r
    if callable(M) and not hasattr(M, "matvec"):
        return M
    mv = make_matvec(M, device)

    def wrapped(r):
        out = mv(r)
        if not isinstance(out, torch.Tensor):
            out = torch.as_tensor(np.asarray(out), device=r.device) \
                .to(r.dtype)
        return out
    return wrapped


def prepare(A, b, x0, maxiter, M, device="cuda"):
    """Returns ``(A, M, mv, pre, b, x, maxiter)``: scipy sparse A and M as
    device operators, b and the starting iterate as flat tensors of b's
    dtype on the solve's device, ``maxiter`` defaulting to n."""
    dev = _device_of(A, b, device)
    A = _device_form(A, dev)
    if M is not None:
        M = _device_form(M, dev)
    if isinstance(b, torch.Tensor):
        b = b.reshape(-1).to(dev)
    else:
        b = torch.as_tensor(np.ravel(np.asarray(b)), device=dev)
    if x0 is None:
        x = torch.zeros_like(b)
    elif isinstance(x0, torch.Tensor):
        x = x0.reshape(-1).to(device=dev, dtype=b.dtype)
    else:
        x = torch.as_tensor(np.ravel(np.asarray(x0)), device=dev) \
            .to(b.dtype)
    if maxiter is None:
        maxiter = b.shape[0]
    return (A, M, make_matvec(A, dev), identity_M(M, dev), b, x,
            int(maxiter))


def norm(v: torch.Tensor) -> torch.Tensor:
    """2-norm as a 0-d tensor on v's device: sqrt(real(v^H v))."""
    return torch.sqrt(torch.vdot(v, v).real)


def tolerance(tol, b):
    """The absolute tolerance ``tol * ||b||`` (``tol`` for a zero b), as a
    host scalar of b's real dtype."""
    normb = real_dtype(b.dtype).type(norm(b).item())
    return tol * (normb if normb != 0 else real_dtype(b.dtype).type(1))


def finalize(x, res_buf, n_res, tol_target, callback, residuals):
    """The reference ``(x, info)`` contract: trim the residual history to
    ``n_res`` entries, append it to ``residuals`` (a list, or None), call
    ``callback(x)`` once with the result, and return ``(x, info)``; info is
    0 when the last residual meets ``tol_target``, else the iteration
    count.  ``x`` stays a tensor on its device."""
    res = np.asarray(res_buf)[:int(n_res)]
    if residuals is not None:
        residuals.extend([float(r) for r in res])
    if callback is not None:
        callback(x)
    final = res[-1] if len(res) else np.inf
    info = 0 if final <= tol_target else len(res) - 1
    return x, info
