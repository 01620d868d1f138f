"""Smoother steps of the solve phase, on the level's device.

Port of ``pyamg_tpu/relaxation/device.py`` for weighted Jacobi, the
polynomial (Chebyshev) smoother, applied by Horner's rule so that every
step is a matvec plus vector updates, and multicolor Gauss-Seidel in mask
form (forward, backward and symmetric sweeps).  The gather-form multicolor,
SOR, block, line, Schwarz and Krylov smoothers are not ported yet and
raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..util.utils import not_ported

__all__ = ["SmootherData", "jacobi_step", "polynomial_step",
           "multicolor_gs_step", "apply_smoother"]


@dataclass(frozen=True)
class SmootherData:
    """Precomputed smoother state attached to a hierarchy level."""

    kind: str = "jacobi"
    iterations: int = 1
    sweep: str = "forward"      # multicolor GS: forward/backward/symmetric
    omega: float = 1.0
    dinv: Optional[torch.Tensor] = None      # (n,) inverted diagonal
    color_masks: Optional[torch.Tensor] = None   # (ncolors, n) 0/1 masks
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


def multicolor_gs_step(A, dinv, color_masks, x, b, reverse=False):
    """One multicolor Gauss-Seidel sweep: per color c, in order (reversed
    when ``reverse``), ``x += mask_c * D^{-1} (b - A x)``.  No two nodes of
    one color are adjacent, so this is Gauss-Seidel in the color order."""
    order = range(color_masks.shape[0])
    for c in (reversed(order) if reverse else order):
        x = x + color_masks[c] * dinv * (b - A.matvec(x))
    return x


def apply_smoother(sm: SmootherData, A, x, b):
    """Apply ``sm.iterations`` sweeps of the configured smoother."""
    if sm is None or sm.kind in ("none", None):
        return x
    for _ in range(sm.iterations):
        if sm.kind == "jacobi":
            x = jacobi_step(A, sm.dinv, x, b, sm.omega)
        elif sm.kind in ("polynomial", "chebyshev"):
            x = polynomial_step(A, sm.coefficients, x, b)
        elif (sm.kind in ("gauss_seidel", "multicolor_gauss_seidel")
              and sm.color_masks is not None):
            if sm.sweep in ("forward", "symmetric"):
                x = multicolor_gs_step(A, sm.dinv, sm.color_masks, x, b)
            if sm.sweep in ("backward", "symmetric"):
                x = multicolor_gs_step(A, sm.dinv, sm.color_masks, x, b,
                                       reverse=True)
        else:
            raise not_ported(f"smoother kind {sm.kind!r}",
                             "multicolor GS/SOR/block smoothers")
    return x
