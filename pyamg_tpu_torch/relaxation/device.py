"""Smoother steps of the solve phase, on the level's device.

Port of ``pyamg_tpu/relaxation/device.py`` for weighted Jacobi and
Richardson, the polynomial (Chebyshev) smoother applied by Horner's rule,
multicolor Gauss-Seidel in mask form (one full matvec per color: cheap on
DIA levels) and in gather form (each row of the matrix touched once per
sweep: for padded-ELL levels), multicolor SOR, block Jacobi and multicolor
block Gauss-Seidel, with forward, backward and symmetric sweeps, and the
scalar line smoothers (line Jacobi and zebra line Gauss-Seidel: every line
of a grid solved at once by parallel cyclic reduction), Jacobi on the
normal equations (NE and NR) and the Krylov smoothers (CG, GMRES, CGNR,
CGNE at a fixed depth).  Every step is a matvec, or a gather, plus vector
updates.  The Schwarz and node-blocked line smoothers are not ported yet
and raise.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch

from ..util.utils import not_ported, torch_dtype

__all__ = ["SmootherData", "jacobi_step", "richardson_step",
           "polynomial_step", "multicolor_gs_step",
           "multicolor_gs_gather_step", "block_jacobi_step",
           "batched_tridiag_pcr", "line_relaxation_step",
           "krylov_smoother_step", "jacobi_ne_step", "jacobi_nr_step",
           "cgnr_smoother_step", "cgne_smoother_step", "apply_smoother"]


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
    # line smoothers: (3, nlines, L) sub-, main and super-diagonal of the
    # lines along grid axis ``line_axis``
    line_tri: Optional[torch.Tensor] = None
    grid: Optional[Tuple[int, ...]] = None
    line_axis: int = 0
    # normal-equation and CGNE/CGNR smoothers: A^H as a device operator and
    # the inverted squared row (NE) or column (NR) norms of A
    AT: Optional[object] = None
    dinv_ne: Optional[torch.Tensor] = None

    def astype(self, dtype):
        """This state with every floating-point array cast to ``dtype``
        (the index arrays of the gather form stay integer)."""
        dtype = torch_dtype(dtype)

        def cast(a):
            return None if a is None else a.to(dtype)
        return replace(self, dinv=cast(self.dinv),
                       color_masks=cast(self.color_masks),
                       block_dinv=cast(self.block_dinv),
                       color_data=cast(self.color_data),
                       line_tri=cast(self.line_tri),
                       AT=None if self.AT is None else self.AT.astype(dtype),
                       dinv_ne=cast(self.dinv_ne))


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


def batched_tridiag_pcr(dl, d, du, B):
    """Solve the tridiagonal systems ``(dl, d, du) x = B``, one per row of
    the (nlines, L) arrays, by parallel cyclic reduction: log2(L) rounds,
    each eliminating the couplings at distance s from every row at once.
    Neighbours beyond a line's end are identity rows."""
    L = d.shape[-1]

    def shift(a, s, fill=0.0):
        # a[..., i + s], ``fill`` beyond the ends
        pad = torch.full(a.shape[:-1] + (abs(s),), fill, dtype=a.dtype,
                         device=a.device)
        if s > 0:
            return torch.cat([a[..., s:], pad], dim=-1)
        return torch.cat([pad, a[..., :s]], dim=-1)

    s = 1
    while s < L:
        alpha = -dl / shift(d, -s, 1.0)
        beta = -du / shift(d, s, 1.0)
        d = d + alpha * shift(du, -s) + beta * shift(dl, s)
        B = B + alpha * shift(B, -s) + beta * shift(B, s)
        dl = alpha * shift(dl, -s)
        du = beta * shift(du, s)
        s *= 2
    return B / d


def line_relaxation_step(A, sm: SmootherData, x, b, zebra_phase=None):
    """One damped line-Jacobi step (``zebra_phase`` None), or one zebra
    half-sweep over the even (0) or odd (1) lines: exact solves of the
    residual along the lines of ``sm.line_axis``."""
    if sm.line_tri.dim() != 3:
        raise not_ported("node-blocked line relaxation",
                         "multicolor GS/SOR/block smoothers")
    grid = sm.grid
    axis = sm.line_axis % len(grid)
    Rg = torch.movedim((b - A.matvec(x)).reshape(grid), axis, -1)
    lead = Rg.shape[:-1]
    dx = batched_tridiag_pcr(sm.line_tri[0], sm.line_tri[1], sm.line_tri[2],
                             Rg.reshape(-1, Rg.shape[-1]))
    if zebra_phase is not None:
        keep = torch.arange(dx.shape[0], device=dx.device) % 2 == zebra_phase
        dx = dx * keep[:, None].to(dx.dtype)
    dxg = torch.movedim(dx.reshape(lead + (dx.shape[-1],)), -1, axis)
    return x + sm.omega * dxg.reshape(-1)


def _safe(d):
    """``d``, or 1 where it is 0: a breakdown leaves the iterate as is."""
    return torch.where(d == 0, torch.ones_like(d), d)


def krylov_smoother_step(A, x, b, kind="cg", iterations=2):
    """A fixed number of CG steps (GMRES steps for ``kind="gmres"``) from
    x, with no convergence test."""
    if kind in ("gmres", "gmres_smoother"):
        return _gmres_smoother_step(A, x, b, k=max(iterations, 1))
    r = b - A.matvec(x)
    p = r
    rz = torch.vdot(r, r)
    for _ in range(iterations):
        Ap = A.matvec(p)
        alpha = rz / _safe(torch.vdot(p, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        rz_new = torch.vdot(r, r)
        p = r + (rz_new / _safe(rz)) * p
        rz = rz_new
    return x


def _gmres_smoother_step(A, x, b, k=2):
    """k steps of unrestarted GMRES from x: x plus the minimizer of the
    residual over the k-dimensional Krylov space of the residual (least
    squares by the pseudo-inverse of the small Hessenberg matrix)."""
    r = b - A.matvec(x)
    beta = torch.linalg.vector_norm(r)
    V = [r / _safe(beta)]
    H = torch.zeros((k + 1, k), dtype=r.dtype, device=r.device)
    for j in range(k):
        w = A.matvec(V[j])
        for i in range(j + 1):
            hij = torch.vdot(V[i], w)
            H[i, j] = hij
            w = w - hij * V[i]
        hn = torch.linalg.vector_norm(w)
        H[j + 1, j] = hn
        V.append(w / _safe(hn))
    e1 = torch.zeros(k + 1, dtype=r.dtype, device=r.device)
    e1[0] = beta
    y = torch.linalg.pinv(H) @ e1
    return x + torch.stack(V[:k]).T @ y


def jacobi_ne_step(A, AT, dinv_ne, x, b, omega=1.0):
    """Jacobi on ``A A^H`` (Cimmino, parallel Kaczmarz):
    ``x + omega A^H D^{-1} (b - A x)``, D the squared row norms of A."""
    return x + omega * AT.matvec(dinv_ne * (b - A.matvec(x)))


def jacobi_nr_step(A, AT, dinv_ne, x, b, omega=1.0):
    """Jacobi on ``A^H A``: ``x + omega D^{-1} A^H (b - A x)``, D the
    squared column norms of A."""
    return x + omega * dinv_ne * AT.matvec(b - A.matvec(x))


def cgnr_smoother_step(A, AT, x, b, iterations=2):
    """A fixed number of CG steps on ``A^H A x = A^H b`` (CGNR)."""
    r = b - A.matvec(x)
    z = AT.matvec(r)
    p = z
    zz = torch.vdot(z, z)
    for _ in range(max(iterations, 1)):
        Ap = A.matvec(p)
        alpha = zz / _safe(torch.vdot(Ap, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        z = AT.matvec(r)
        zz_new = torch.vdot(z, z)
        p = z + (zz_new / _safe(zz)) * p
        zz = zz_new
    return x


def cgne_smoother_step(A, AT, x, b, iterations=2):
    """A fixed number of steps of CGNE (Craig's method): CG on
    ``A A^H y = b`` with ``x = A^H y``."""
    r = b - A.matvec(x)
    p = AT.matvec(r)
    rr = torch.vdot(r, r)
    for _ in range(max(iterations, 1)):
        alpha = rr / _safe(torch.vdot(p, p))
        x = x + alpha * p
        r = r - alpha * A.matvec(p)
        rr_new = torch.vdot(r, r)
        p = AT.matvec(r) + (rr_new / _safe(rr)) * p
        rr = rr_new
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
        elif sm.kind == "line_jacobi":
            x = line_relaxation_step(A, sm, x, b)
        elif sm.kind in ("zebra", "line_gauss_seidel"):
            phases = (1, 0) if sm.sweep == "backward" else (0, 1)
            if sm.sweep == "symmetric":
                phases = (0, 1, 1, 0)
            for ph in phases:
                x = line_relaxation_step(A, sm, x, b, zebra_phase=ph)
        elif sm.kind == "jacobi_ne":
            x = jacobi_ne_step(A, sm.AT, sm.dinv_ne, x, b, sm.omega)
        elif sm.kind == "jacobi_nr":
            x = jacobi_nr_step(A, sm.AT, sm.dinv_ne, x, b, sm.omega)
        elif sm.kind in ("cg_smoother", "gmres_smoother"):
            # a Krylov depth of 2 a sweep; iterations counts the sweeps
            x = krylov_smoother_step(A, x, b, kind=sm.kind, iterations=2)
        elif sm.kind == "cgnr_smoother":
            x = cgnr_smoother_step(A, sm.AT, x, b, iterations=2)
        elif sm.kind == "cgne_smoother":
            x = cgne_smoother_step(A, sm.AT, x, b, iterations=2)
        else:
            raise not_ported(f"smoother kind {sm.kind!r}",
                             "multicolor GS/SOR/block smoothers")
    return x
