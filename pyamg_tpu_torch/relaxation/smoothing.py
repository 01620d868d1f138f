"""Smoother factory: bind pre/post smoothers onto hierarchy levels.

Port of ``pyamg_tpu/relaxation/smoothing.py`` for jacobi, chebyshev and
polynomial smoothing, and the graph coloring of the multicolor
Gauss-Seidel smoother on unstructured levels (``_coloring``,
``_color_masks``).  Smoother state (inverted diagonals, color masks) is
computed on the host in numpy and moved to the level's device once.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..util.linalg import approximate_spectral_radius
from ..util.utils import (levelize_smooth_or_improve_candidates, not_ported,
                          numpy_dtype, unpack_arg)
from .chebyshev import chebyshev_polynomial_coefficients
from .device import SmootherData

__all__ = ["change_smoothers", "rho_D_inv_A", "make_smoother_data"]

DEFAULT_NITER = 1


def rho_D_inv_A(A_csr, symmetric=None):
    """Spectral radius of D^{-1} A, cached on ``A_csr.rho_D_inv``.

    ``symmetric=True`` uses the similarity D^{-1}A ~ D^{-1/2} A D^{-1/2}
    and a Lanczos estimate (positive diagonal required); otherwise
    Arnoldi on D^{-1} A."""
    cached = getattr(A_csr, "rho_D_inv", None)
    if cached is not None:
        return cached
    d = A_csr.diagonal()
    mask = d != 0

    if symmetric and not np.iscomplexobj(d) and (d > 0).all():
        # a ~1%-accurate estimate: f32 matvecs halve the bandwidth
        A_rho = A_csr.astype(np.float32) if A_csr.dtype == np.float64 \
            else A_csr
        dhalf_inv = (1.0 / np.sqrt(d)).astype(A_rho.dtype, copy=False)

        class _Scaled:            # D^{-1/2} A D^{-1/2} without materializing
            shape = A_csr.shape
            dtype = A_rho.dtype

            @staticmethod
            def matvec(v):
                return dhalf_inv * (A_rho @ (dhalf_inv * v))

        rho = approximate_spectral_radius(_Scaled(), symmetric=True)
    else:
        dinv = np.zeros_like(d)
        dinv[mask] = 1.0 / d[mask]
        DinvA = sp.dia_matrix((dinv[None, :], [0]),
                              shape=A_csr.shape) @ A_csr
        rho = approximate_spectral_radius(DinvA)
    try:
        A_csr.rho_D_inv = rho
    except (AttributeError, TypeError):
        pass
    return rho


def _coloring(A_csr):
    """Graph coloring of A's nodes for the multicolor smoothers: greedy
    first-fit, the JAX package's choice where its native library is
    present.  The geometric colorings of structured grids are not ported
    yet."""
    from ..graph import vertex_coloring

    return np.asarray(vertex_coloring(A_csr, method="FF"))


def _color_masks(A_csr, dtype=None):
    """(ncolors, n) 0/1 masks of the :func:`_coloring` of A, in ``dtype``
    (default A's real dtype)."""
    colors = _coloring(A_csr)
    n = colors.shape[0]
    rdt = dtype or np.real(np.zeros(0, dtype=A_csr.dtype)).dtype
    masks = np.zeros((int(colors.max()) + 1, n), dtype=rdt)
    masks[colors, np.arange(n)] = 1
    return masks


def _dinv(A_csr, dtype=None):
    d = A_csr.diagonal()
    mask = d != 0
    out = np.zeros_like(d)
    out[mask] = 1.0 / d[mask]
    if dtype is not None:
        out = out.astype(dtype, copy=False)
    return out


def make_smoother_data(lvl, fn_name, kwargs, dtype=None, *,
                       device) -> SmootherData:
    """The precomputed SmootherData of one option on one level.

    ``dtype``: target dtype of the state arrays (cast on the host).
    Results are cached on the level, so identical pre- and post-smoothers
    share their state."""
    cache_key = (fn_name, tuple(sorted(kwargs.items())), str(dtype),
                 str(device))
    cache = lvl.__dict__.setdefault("_smoother_cache", {})
    if cache_key not in cache:
        cache[cache_key] = _make_smoother_data(lvl, fn_name, kwargs, dtype,
                                               device)
    return cache[cache_key]


def _make_smoother_data(lvl, fn_name, kwargs, dtype, device):
    A_csr = lvl.A_csr
    npdt = numpy_dtype(dtype)
    iterations = int(kwargs.get("iterations", DEFAULT_NITER))

    if fn_name is None or fn_name == "none":
        return SmootherData(kind="none")

    if fn_name == "jacobi":
        omega = float(kwargs.get("omega", 1.0))
        if kwargs.get("withrho", True):
            omega = omega / rho_D_inv_A(
                A_csr, symmetric=getattr(lvl, "_sym_hint", None))
        return SmootherData(kind="jacobi", iterations=iterations,
                            omega=omega,
                            dinv=torch.as_tensor(_dinv(A_csr, npdt),
                                                 device=device))

    if fn_name in ("chebyshev", "polynomial"):
        if fn_name == "chebyshev":
            rho = approximate_spectral_radius(A_csr)
            a = rho * float(kwargs.get("lower_bound", 1.0 / 30.0))
            b = rho * float(kwargs.get("upper_bound", 1.1))
            degree = int(kwargs.get("degree", 3))
            coefficients = -chebyshev_polynomial_coefficients(
                a, b, degree)[:-1]
        else:
            coefficients = np.asarray(kwargs["coefficients"])
        return SmootherData(kind="polynomial", iterations=iterations,
                            coefficients=tuple(float(c) for c in coefficients))

    raise not_ported(f"smoother {fn_name!r}",
                     "multicolor GS/SOR/block smoothers")


def change_smoothers(ml, presmoother, postsmoother):
    """Attach pre/post SmootherData to every level of ``ml`` but the
    coarsest."""
    n = len(ml.levels)
    dtype = getattr(ml, "_op_dtype", None)
    sym_hint = getattr(ml, "symmetry", None) in ("hermitian", "symmetric")
    pres = levelize_smooth_or_improve_candidates(presmoother, n)
    posts = levelize_smooth_or_improve_candidates(postsmoother, n)
    for lvl, pre, post in zip(ml.levels[:-1], pres, posts):
        if not hasattr(lvl, "_sym_hint"):
            lvl._sym_hint = sym_hint
        fn, kw = unpack_arg(pre) if pre is not None else (None, {})
        lvl.presmoother = make_smoother_data(lvl, fn, kw, dtype=dtype,
                                             device=ml.device)
        fn, kw = unpack_arg(post) if post is not None else (None, {})
        lvl.postsmoother = make_smoother_data(lvl, fn, kw, dtype=dtype,
                                              device=ml.device)
    return ml
