"""Smoother steps of the solve phase, on the level's device.

Port of ``pyamg_tpu/relaxation/device.py`` for the smoothers of the
structured SA path: weighted Jacobi and the polynomial (Chebyshev) smoother,
applied by Horner's rule so that every step is a DIA matvec plus vector
updates.  The multicolor, block, line, Schwarz and Krylov smoothers are not
ported yet and raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..util.utils import not_ported

__all__ = ["SmootherData", "jacobi_step", "polynomial_step",
           "apply_smoother"]


@dataclass(frozen=True)
class SmootherData:
    """Precomputed smoother state attached to a hierarchy level."""

    kind: str = "jacobi"
    iterations: int = 1
    omega: float = 1.0
    dinv: Optional[torch.Tensor] = None      # (n,) inverted diagonal
    coefficients: Tuple[float, ...] = ()     # descending order


def jacobi_step(A, dinv, x, b, omega=1.0):
    """x + omega * D^{-1} (b - A x)."""
    return x + omega * dinv * (b - A.matvec(x))


def polynomial_step(A, coefficients, x, b):
    """x + p(A) r by Horner's rule; coefficients in descending order."""
    r = b - A.matvec(x)
    h = coefficients[0] * r
    for c in coefficients[1:]:
        h = c * r + A.matvec(h)
    return x + h


def apply_smoother(sm: SmootherData, A, x, b):
    """Apply ``sm.iterations`` sweeps of the configured smoother."""
    if sm is None or sm.kind in ("none", None):
        return x
    for _ in range(sm.iterations):
        if sm.kind == "jacobi":
            x = jacobi_step(A, sm.dinv, x, b, sm.omega)
        elif sm.kind in ("polynomial", "chebyshev"):
            x = polynomial_step(A, sm.coefficients, x, b)
        else:
            raise not_ported(f"smoother kind {sm.kind!r}",
                             "multicolor GS/SOR/block smoothers")
    return x
