"""Structural sparse products of the setup: ``spgemm``, ``rap`` and
``transpose`` as scipy products on the host, the result as padded ELL on
the device.

Port of ``pyamg_tpu/sparse/ops.py``.  Each takes scipy matrices or the
port's ``SparseELL``/``BlockELL``.

Examples
--------
>>> import numpy as np, scipy.sparse as sp
>>> M = sp.csr_matrix(np.array([[1., 2., 0.], [0., 3., 4.]]))
>>> C = spgemm(M, M.T, device="cpu")
>>> bool(np.allclose(C.to_scipy().toarray(), (M @ M.T).toarray()))
True
"""

from __future__ import annotations

import scipy.sparse as sp

from .bell import BlockELL
from .ell import SparseELL

__all__ = ["spgemm", "rap", "transpose"]


def _csr(A):
    if isinstance(A, (SparseELL, BlockELL)):
        A = A.to_scipy()
    return sp.csr_matrix(A)


def spgemm(A, B, width=None, dtype=None, device="cuda") -> SparseELL:
    """``C = A @ B`` (explicit zeros dropped) as padded ELL on ``device``,
    ``width`` wide if given."""
    C = _csr(A) @ _csr(B)
    C.eliminate_zeros()
    return SparseELL.from_scipy(C, dtype=dtype, device=device, width=width)


def rap(R, A, P, dtype=None, device="cuda") -> SparseELL:
    """The Galerkin product ``R A P`` (explicit zeros dropped) as padded
    ELL on ``device``."""
    C = _csr(R) @ _csr(A) @ _csr(P)
    C.eliminate_zeros()
    return SparseELL.from_scipy(C, dtype=dtype, device=device)


def transpose(A, device="cuda") -> SparseELL:
    """``A^T`` as padded ELL on ``device``."""
    return SparseELL.from_scipy(_csr(A).T.tocsr(), device=device)
