"""Shared pieces of the Krylov methods: the vector norm and the reference
``(x, info)`` contract.

Port of ``norm`` and ``finalize`` from ``pyamg_tpu/krylov/_common.py``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["norm", "finalize"]


def norm(v: torch.Tensor) -> torch.Tensor:
    """2-norm as a 0-d tensor on v's device: sqrt(real(v^H v))."""
    return torch.sqrt(torch.vdot(v, v).real)


def finalize(x, res_buf, n_res, tol_target, residuals):
    """Trim the residual history to ``n_res`` entries, append it to
    ``residuals`` (a list, or None) and return ``(x, info)``: info is 0 when
    the last residual meets ``tol_target``, else the iteration count."""
    res = np.asarray(res_buf)[:int(n_res)]
    if residuals is not None:
        residuals.extend([float(r) for r in res])
    final = res[-1] if len(res) else np.inf
    info = 0 if final <= tol_target else len(res) - 1
    return x, info
