"""Smoother factory: bind pre/post smoothers onto hierarchy levels.

Port of ``pyamg_tpu/relaxation/smoothing.py`` for jacobi, richardson,
chebyshev and polynomial smoothing, multicolor Gauss-Seidel and SOR, block
Jacobi and block Gauss-Seidel.  Sequential methods run as their multicolor
form: the colors are geometric on a structured grid (2, or 2^d for a full
3^d stencil) and greedy first-fit otherwise; a level whose operator is
padded ELL gets the gather arrays of
:func:`~pyamg_tpu_torch.relaxation.device.multicolor_gs_gather_step`, any
other the color masks.  Smoother state is computed on the host in numpy and
moved to the level's device once.
"""

from __future__ import annotations

import itertools

import numpy as np
import scipy.sparse as sp
import torch

from ..amg_core import have_native
from ..util.linalg import approximate_spectral_radius
from ..util.utils import (amalgamate, get_block_diag,
                          levelize_smooth_or_improve_candidates, not_ported,
                          numpy_dtype, unpack_arg)
from .chebyshev import chebyshev_polynomial_coefficients
from .device import SmootherData

__all__ = ["change_smoothers", "rho_D_inv_A", "rho_block_D_inv_A",
           "make_smoother_data", "gather_form_bytes"]

DEFAULT_SWEEP = "forward"
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


def rho_block_D_inv_A(A_csr, Dinv):
    """Spectral radius of ``blockdiag(D)^{-1} A``; ``Dinv`` holds the
    inverted (nb, bs, bs) diagonal blocks."""
    nb = Dinv.shape[0]
    Dinv_mat = sp.bsr_matrix((Dinv, np.arange(nb), np.arange(nb + 1)),
                             shape=A_csr.shape).tocsr()
    return approximate_spectral_radius(Dinv_mat @ A_csr)


def _grid_strides(grid):
    return [int(np.prod(grid[k + 1:])) for k in range(len(grid))]


def _grid_coloring(grid, offsets):
    """Exact geometric coloring of a grid stencil: checkerboard (2 colors)
    when the stencil is a cross, else 2^d block coloring (valid for any
    3^d neighbourhood stencil)."""
    grid = tuple(grid)
    cross = {0}
    for s in _grid_strides(grid):
        cross |= {s, -s}
    coords = np.unravel_index(np.arange(int(np.prod(grid))), grid)
    if set(offsets) <= cross:
        return (sum(coords) % 2).astype(np.int32)
    color = np.zeros(int(np.prod(grid)), dtype=np.int32)
    for c in coords:
        color = 2 * color + (c % 2).astype(np.int32)
    return color


def _coloring(A_csr, blocksize=1, grid=None, offsets=None):
    """Graph coloring of A's nodes for the multicolor smoothers: geometric
    (2 or 2^d colors) where ``grid`` describes A and every offset is a move
    within the 3^d neighbourhood, else greedy first-fit where the compiled
    ``amg_core`` library loaded and Jones-Plassmann rounds where not.

    ``offsets``: the distinct diagonal offsets, where known (the level's
    DIA operator has them), which saves finding them again."""
    from ..graph import vertex_coloring

    G = amalgamate(A_csr, blocksize) if blocksize > 1 else A_csr
    if grid is not None and blocksize == 1 \
            and int(np.prod(grid)) == G.shape[0]:
        if offsets is None:
            coo = G.tocoo()
            offsets = np.unique(coo.col.astype(np.int64)
                                - coo.row.astype(np.int64))
        offs = [int(o) for o in offsets]
        strides = _grid_strides(tuple(grid))
        moves = {sum(d * s for d, s in zip(deltas, strides))
                 for deltas in itertools.product((-1, 0, 1),
                                                 repeat=len(grid))}
        if set(offs) <= moves:
            return np.asarray(_grid_coloring(grid, offs))
    # compiled greedy first-fit: one O(nnz) pass and fewer colors than
    # Jones-Plassmann rounds; JP is the numpy form without the library
    return np.asarray(vertex_coloring(
        G, method="FF" if have_native() else "JP"))


def _color_masks(A_csr, blocksize=1, dtype=None, grid=None, offsets=None,
                 colors=None):
    """(ncolors, n) 0/1 masks of a coloring of A (default: its
    :func:`_coloring`), in ``dtype`` (default A's real dtype); with
    ``blocksize`` > 1 each node's mask covers its dofs."""
    if colors is None:
        colors = _coloring(A_csr, blocksize=blocksize, grid=grid,
                           offsets=offsets)
    nb = colors.shape[0]
    rdt = dtype or np.real(np.zeros(0, dtype=A_csr.dtype)).dtype
    masks = np.zeros((int(colors.max()) + 1, nb), dtype=rdt)
    masks[colors, np.arange(nb)] = 1
    if blocksize > 1:
        masks = np.repeat(masks, blocksize, axis=1)
    return masks


def gather_form_bytes(A_csr, colors, itemsize):
    """``(C, R, W, bytes)`` of the gather arrays of a coloring: C colors,
    R rows in the largest color, W entries in the longest row; int64 rows
    and columns and ``itemsize``-byte values."""
    C = int(np.max(colors)) + 1
    R = int(np.bincount(colors, minlength=C).max())
    W = int(np.diff(A_csr.indptr).max()) if A_csr.shape[0] else 0
    return C, R, W, C * R * 8 + C * R * W * (8 + itemsize)


def _color_gather_arrays(A_csr, colors, dtype=None):
    """Per-color padded row arrays of the gather-form multicolor GS:
    ``(color_rows (C, R) int64, -1 padded; color_cols (C, R, W) int64;
    color_data (C, R, W))``.

    The mask-form sweep costs one full matvec per color, ruinous on a
    gather-bound (ELL) level with dozens of colors; the gather form touches
    every matrix row once per sweep.  The indices are int64, the type a
    torch gather takes, so that no sweep converts them."""
    n = A_csr.shape[0]
    colors = np.asarray(colors)
    dt = np.dtype(dtype or A_csr.dtype)
    C, R, W, _nbytes = gather_form_bytes(A_csr, colors, dt.itemsize)
    counts = np.bincount(colors, minlength=C)
    nnz_row = np.diff(A_csr.indptr)
    order = np.argsort(colors, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)])
    slot = np.arange(n) - starts[colors[order]]
    color_rows = np.full((C, R), -1, dtype=np.int64)
    color_rows[colors[order], slot] = order
    # entry scatter: (color, slot, position in its row)
    rows_e = np.repeat(np.arange(n), nnz_row)
    pos_e = np.arange(A_csr.nnz) - np.repeat(A_csr.indptr[:-1], nnz_row)
    slot_of_row = np.empty(n, dtype=np.int64)
    slot_of_row[order] = slot
    color_cols = np.zeros((C, R, W), dtype=np.int64)
    color_data = np.zeros((C, R, W), dtype=dt)
    where = (colors[rows_e], slot_of_row[rows_e], pos_e)
    color_cols[where] = A_csr.indices
    color_data[where] = A_csr.data.astype(dt, copy=False)
    return color_rows, color_cols, color_data


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
    cache = lvl.__dict__.setdefault("_smoother_cache", {})
    try:
        cache_key = (fn_name, tuple(sorted(kwargs.items())), str(dtype),
                     str(device))
        hash(cache_key)
    except TypeError:               # array-valued options (Dinv)
        return _make_smoother_data(lvl, fn_name, kwargs, dtype, device)
    if cache_key not in cache:
        cache[cache_key] = _make_smoother_data(lvl, fn_name, kwargs, dtype,
                                               device)
    return cache[cache_key]


def _make_smoother_data(lvl, fn_name, kwargs, dtype, device):
    from ..sparse import SparseDIA, SparseELL

    A_csr = lvl.host_A()
    npdt = numpy_dtype(dtype)
    rdt = None if npdt is None else np.real(np.zeros(0, dtype=npdt)).dtype
    iterations = int(kwargs.get("iterations", DEFAULT_NITER))
    sweep = kwargs.get("sweep", DEFAULT_SWEEP)
    A_dev = getattr(lvl, "A", None)
    # the DIA operator's offsets spare the coloring their rediscovery
    known_offsets = A_dev.offsets if isinstance(A_dev, SparseDIA) else None
    grid = getattr(lvl, "grid", None)

    def dev(a, dt=npdt):
        a = np.asarray(a)
        if dt is not None:
            a = a.astype(dt, copy=False)
        return torch.as_tensor(a, device=device)

    if fn_name is None or fn_name == "none":
        return SmootherData(kind="none")

    if fn_name == "jacobi":
        omega = float(kwargs.get("omega", 1.0))
        if kwargs.get("withrho", True):
            omega = omega / rho_D_inv_A(
                A_csr, symmetric=getattr(lvl, "_sym_hint", None))
        return SmootherData(kind="jacobi", iterations=iterations,
                            omega=omega, dinv=dev(_dinv(A_csr)))

    if fn_name == "richardson":
        omega = float(kwargs.get("omega", 1.0)) \
            / approximate_spectral_radius(A_csr)
        return SmootherData(kind="richardson", iterations=iterations,
                            omega=omega)

    if fn_name in ("gauss_seidel", "multicolor_gauss_seidel"):
        colors = _coloring(A_csr, grid=grid, offsets=known_offsets)
        if isinstance(A_dev, SparseELL):
            # gather form where the matvec is a gather; DIA levels keep
            # the mask form: their matvec is so cheap that a pass per
            # color beats gathering the matrix again
            cr, cc, cd = _color_gather_arrays(A_csr, colors, dtype=npdt)
            return SmootherData(kind="gauss_seidel", iterations=iterations,
                                sweep=sweep, dinv=dev(_dinv(A_csr)),
                                color_rows=dev(cr, None),
                                color_cols=dev(cc, None), color_data=dev(cd))
        return SmootherData(kind="gauss_seidel", iterations=iterations,
                            sweep=sweep, dinv=dev(_dinv(A_csr)),
                            color_masks=dev(_color_masks(
                                A_csr, dtype=rdt, colors=colors)))

    if fn_name == "sor":
        return SmootherData(kind="sor", iterations=iterations, sweep=sweep,
                            omega=float(kwargs.get("omega", 1.0)),
                            dinv=dev(_dinv(A_csr)),
                            color_masks=dev(_color_masks(
                                A_csr, dtype=rdt, grid=grid,
                                offsets=known_offsets)))

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

    if fn_name in ("block_jacobi", "block_gauss_seidel"):
        bs = int(kwargs.get("blocksize", getattr(lvl, "blocksize", 1)))
        if bs == 1:
            # 1x1 blocks: the scalar smoothers, cheaper
            scalar = "jacobi" if fn_name == "block_jacobi" else "gauss_seidel"
            kwargs = {k: v for k, v in kwargs.items()
                      if k not in ("blocksize", "Dinv")}
            return make_smoother_data(lvl, scalar, kwargs, dtype=dtype,
                                      device=device)
        Dinv = kwargs.get("Dinv")
        if Dinv is None:
            Dinv = get_block_diag(A_csr, bs, inv_flag=True)
        Dinv = np.asarray(Dinv)
        if fn_name == "block_jacobi":
            omega = float(kwargs.get("omega", 1.0))
            if kwargs.get("withrho", True):
                omega = omega / rho_block_D_inv_A(A_csr, Dinv)
            return SmootherData(kind="block_jacobi", iterations=iterations,
                                omega=omega, block_dinv=dev(Dinv),
                                blocksize=bs)
        return SmootherData(kind="block_gauss_seidel", iterations=iterations,
                            sweep=sweep, block_dinv=dev(Dinv), blocksize=bs,
                            color_masks=dev(_color_masks(
                                A_csr, blocksize=bs, dtype=rdt)))

    if fn_name in ("jacobi_ne", "gauss_seidel_ne", "gauss_seidel_nr",
                   "line_jacobi", "zebra", "line_gauss_seidel", "schwarz",
                   "strength_based_schwarz", "gmres", "cg", "cgne", "cgnr"):
        raise not_ported(f"smoother {fn_name!r}",
                         "multicolor GS/SOR/block smoothers")
    raise ValueError(f"unknown smoother {fn_name!r}")


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
