"""Smoother steps of the solve phase, on the level's device.

Port of ``pyamg_tpu/relaxation/device.py`` for weighted Jacobi and
Richardson, the polynomial (Chebyshev) smoother applied by Horner's rule,
multicolor Gauss-Seidel in mask form (one full matvec per color: cheap on
DIA levels) and in gather form (each row of the matrix touched once per
sweep: for padded-ELL levels), multicolor SOR, block Jacobi and multicolor
block Gauss-Seidel, with forward, backward and symmetric sweeps.  Every
step is a matvec, or a gather, plus vector updates.  The NE/NR, Schwarz,
line and Krylov smoothers are not ported yet and raise.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch

from ..util.utils import not_ported, torch_dtype

__all__ = ["SmootherData", "jacobi_step", "richardson_step",
           "polynomial_step", "multicolor_gs_step",
           "multicolor_gs_gather_step", "block_jacobi_step",
           "apply_smoother"]


@dataclass(frozen=True)
class SmootherData:
    """Precomputed smoother state attached to a hierarchy level."""

    kind: str = "jacobi"
    iterations: int = 1
    sweep: str = "forward"      # multicolor sweeps: forward/backward/symmetric
    omega: float = 1.0
    dinv: Optional[torch.Tensor] = None      # (n,) inverted diagonal
    color_masks: Optional[torch.Tensor] = None   # (ncolors, n) 0/1 masks
    coefficients: Tuple[float, ...] = ()     # descending order
    block_dinv: Optional[torch.Tensor] = None    # (nb, bs, bs)
    blocksize: int = 1
    # gather form: int64 so that no gather converts its index per call
    color_rows: Optional[torch.Tensor] = None    # (C, R), -1 padded
    color_cols: Optional[torch.Tensor] = None    # (C, R, W)
    color_data: Optional[torch.Tensor] = None    # (C, R, W)

    def astype(self, dtype):
        """This state with every floating-point array cast to ``dtype``
        (the index arrays of the gather form stay integer)."""
        dtype = torch_dtype(dtype)

        def cast(a):
            return None if a is None else a.to(dtype)
        return replace(self, dinv=cast(self.dinv),
                       color_masks=cast(self.color_masks),
                       block_dinv=cast(self.block_dinv),
                       color_data=cast(self.color_data))


def jacobi_step(A, dinv, x, b, omega=1.0):
    """x + omega * D^{-1} (b - A x)."""
    return x + omega * dinv * (b - A.matvec(x))


def richardson_step(A, x, b, omega=1.0):
    """x + omega * (b - A x)."""
    return x + omega * (b - A.matvec(x))


def polynomial_step(A, coefficients, x, b):
    """x + p(A) r by Horner's rule; coefficients in descending order."""
    r = b - A.matvec(x)
    h = coefficients[0] * r
    for c in coefficients[1:]:
        h = c * r + A.matvec(h)
    return x + h


def _colors(n, reverse):
    return range(n - 1, -1, -1) if reverse else range(n)


def multicolor_gs_step(A, dinv, color_masks, x, b, reverse=False, omega=1.0):
    """One multicolor Gauss-Seidel sweep: per color c, in order (reversed
    when ``reverse``), ``x += omega * mask_c * D^{-1} (b - A x)``.  No two
    nodes of one color are adjacent, so this is Gauss-Seidel (SOR for
    ``omega != 1``) in the color order."""
    for c in _colors(color_masks.shape[0], reverse):
        mask = color_masks[c] if omega == 1.0 else omega * color_masks[c]
        x = x + mask * dinv * (b - A.matvec(x))
    return x


def multicolor_gs_gather_step(sm: SmootherData, x, b, reverse=False):
    """One multicolor Gauss-Seidel sweep in gather form: per color, gather
    only that color's rows from the padded ``(C, R, W)`` arrays and update
    them.  The same iteration as :func:`multicolor_gs_step` under the same
    coloring, but the whole sweep touches each matrix row once: one
    matvec-equivalent in all instead of one full matvec per color.  Padded
    rows (-1) add an exact zero onto row 0."""
    for c in _colors(sm.color_rows.shape[0], reverse):
        rows = sm.color_rows[c]
        valid = (rows >= 0).to(x.dtype)
        safe = rows.clamp(min=0)
        Ax = (sm.color_data[c] * x[sm.color_cols[c]]).sum(dim=1)
        upd = valid * sm.dinv[safe] * (b[safe] - Ax)
        x = x.index_add(0, safe, upd)
    return x


def block_jacobi_step(A, block_dinv, x, b, omega=1.0):
    """x + omega * blockdiag(D)^{-1} (b - A x), batched over the blocks."""
    bs = block_dinv.shape[-1]
    r = (b - A.matvec(x)).reshape(-1, bs)
    dx = torch.einsum("nij,nj->ni", block_dinv, r).reshape(-1)
    return x + omega * dx


def _multicolor_block_gs(A, sm, x, b, reverse):
    """One multicolor block Gauss-Seidel sweep over the block graph's
    colors; the masks are expanded to the blocks' dofs."""
    bs = sm.block_dinv.shape[-1]
    for c in _colors(sm.color_masks.shape[0], reverse):
        r = (b - A.matvec(x)).reshape(-1, bs)
        dx = torch.einsum("nij,nj->ni", sm.block_dinv, r).reshape(-1)
        x = x + sm.color_masks[c] * dx
    return x


def _sweeps(sweep):
    """The ``reverse`` flags of a sweep: forward, backward, or both."""
    flags = {"forward": (False,), "backward": (True,),
             "symmetric": (False, True)}
    if sweep not in flags:
        raise ValueError("valid sweep directions: forward/backward/"
                         f"symmetric, got {sweep!r}")
    return flags[sweep]


def apply_smoother(sm: SmootherData, A, x, b):
    """Apply ``sm.iterations`` sweeps of the configured smoother."""
    if sm is None or sm.kind in ("none", None):
        return x
    for _ in range(sm.iterations):
        if sm.kind == "jacobi":
            x = jacobi_step(A, sm.dinv, x, b, sm.omega)
        elif sm.kind == "richardson":
            x = richardson_step(A, x, b, sm.omega)
        elif sm.kind in ("polynomial", "chebyshev"):
            x = polynomial_step(A, sm.coefficients, x, b)
        elif sm.kind in ("gauss_seidel", "multicolor_gauss_seidel"):
            for reverse in _sweeps(sm.sweep):
                if sm.color_rows is not None:
                    x = multicolor_gs_gather_step(sm, x, b, reverse)
                else:
                    x = multicolor_gs_step(A, sm.dinv, sm.color_masks, x, b,
                                           reverse)
        elif sm.kind == "sor":
            for reverse in _sweeps(sm.sweep):
                x = multicolor_gs_step(A, sm.dinv, sm.color_masks, x, b,
                                       reverse, omega=sm.omega)
        elif sm.kind == "block_jacobi":
            x = block_jacobi_step(A, sm.block_dinv, x, b, sm.omega)
        elif sm.kind in ("block_gauss_seidel",
                         "multicolor_block_gauss_seidel"):
            for reverse in _sweeps(sm.sweep):
                x = _multicolor_block_gs(A, sm, x, b, reverse)
        else:
            raise not_ported(f"smoother kind {sm.kind!r}",
                             "multicolor GS/SOR/block smoothers")
    return x
