"""Smoother factory: bind pre/post smoothers onto hierarchy levels.

Port of ``pyamg_tpu/relaxation/smoothing.py`` for jacobi, richardson,
chebyshev and polynomial smoothing, multicolor Gauss-Seidel and SOR, block
Jacobi and block Gauss-Seidel, the scalar line smoothers (line Jacobi,
zebra; on a level without a grid, multicolor Gauss-Seidel; block-tridiagonal
lines on a grid level with several dofs a node), Jacobi on the normal
equations (``jacobi_ne``, ``gauss_seidel_ne``, ``gauss_seidel_nr``), the
Krylov smoothers (``cg``, ``gmres``, ``cgne``, ``cgnr``) and additive
overlapping Schwarz (``schwarz``, ``strength_based_schwarz``).  Sequential
methods run as their multicolor form: the colors are geometric on a
structured grid (2, or 2^d for a full 3^d stencil) and greedy first-fit
otherwise; a level whose operator is padded ELL gets the gather arrays of
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
                          levelize_smooth_or_improve_candidates, numpy_dtype,
                          unpack_arg)
from .chebyshev import chebyshev_polynomial_coefficients
from .device import SmootherData

__all__ = ["change_smoothers", "rho_D_inv_A", "rho_block_D_inv_A",
           "make_smoother_data", "gather_form_bytes", "schwarz_dof_slots"]

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


def _adjoint_operator(A_csr, npdt, device):
    """A^H in ``device_operator``'s form: a banded A^H rides the DIA
    kernel."""
    from ..sparse.device_op import device_operator

    return device_operator(A_csr.conjugate().T.tocsr(), dtype=npdt,
                           device=device)


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
            A_blk = getattr(lvl, "A_bsr", None)
            if A_blk is None or A_blk.blocksize != (bs, bs):
                A_blk = A_csr
            Dinv = get_block_diag(A_blk, bs, inv_flag=True)
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

    if fn_name in ("line_jacobi", "zebra", "line_gauss_seidel"):
        n = A_csr.shape[0]
        q = max(getattr(lvl, "blocksize", 1), 1)
        if grid is not None and q > 1 and int(np.prod(grid)) * q == n:
            # q dofs a grid node (the coarse levels of a K-candidate
            # hierarchy): block-tridiagonal lines, so that the level stays
            # line-relaxed as the semicoarsening above it needs
            return _block_line_data(A_csr, tuple(int(g) for g in grid), q,
                                    fn_name, iterations, sweep, kwargs, dev)
        if grid is None or int(np.prod(grid)) != n:
            # a level without its grid (every coarse level of classical
            # AMG): multicolor Gauss-Seidel, which needs no geometry
            return make_smoother_data(lvl, "gauss_seidel",
                                      {"iterations": iterations,
                                       "sweep": sweep}, dtype=dtype,
                                      device=device)
        grid = tuple(int(g) for g in grid)
        strides = _grid_strides(grid)
        axis = kwargs.get("axis")
        if axis is None:        # the most strongly coupled direction
            axis = int(np.argmax([np.abs(A_csr.diagonal(st)).sum()
                                  for st in strides]))
        axis = axis % len(grid)
        stride = strides[axis]
        L = grid[axis]
        d_flat = A_csr.diagonal().astype(A_csr.dtype)
        du_flat = np.zeros(n, dtype=A_csr.dtype)
        du_flat[:n - stride] = A_csr.diagonal(stride)
        dl_flat = np.zeros(n, dtype=A_csr.dtype)
        dl_flat[stride:] = A_csr.diagonal(-stride)
        coords = np.unravel_index(np.arange(n), grid)
        du_flat[coords[axis] == L - 1] = 0.0
        dl_flat[coords[axis] == 0] = 0.0

        def lines(v):
            return np.moveaxis(v.reshape(grid), axis, -1).reshape(-1, L)

        tri = np.stack([lines(dl_flat), lines(d_flat), lines(du_flat)])
        omega = float(kwargs.get("omega",
                                 0.7 if fn_name == "line_jacobi" else 1.0))
        return SmootherData(kind="line_jacobi" if fn_name == "line_jacobi"
                            else "zebra", iterations=iterations, sweep=sweep,
                            omega=omega, line_tri=dev(tri), grid=grid,
                            line_axis=axis)

    if fn_name in ("jacobi_ne", "gauss_seidel_ne", "gauss_seidel_nr"):
        # on the device all three are Jacobi on the normal equations (the
        # parallel member of the Kaczmarz family): NE on A A^H with the
        # squared row norms, NR on A^H A with the squared column norms
        omega = float(kwargs.get("omega", 1.0))
        if kwargs.get("withrho", True):
            # the normal equations' spectrum is the square of A's
            omega = omega / rho_D_inv_A(A_csr) ** 2
        axis = 1 if fn_name in ("jacobi_ne", "gauss_seidel_ne") else 0
        d = np.asarray(
            A_csr.multiply(A_csr.conjugate()).sum(axis=axis)).ravel().real
        mask = d != 0
        dinv_ne = np.zeros(d.shape, dtype=A_csr.dtype)
        dinv_ne[mask] = 1.0 / d[mask]
        return SmootherData(kind="jacobi_ne" if axis == 1 else "jacobi_nr",
                            iterations=iterations, omega=omega,
                            AT=_adjoint_operator(A_csr, npdt, device),
                            dinv_ne=dev(dinv_ne))

    if fn_name in ("gmres", "cg", "cgne", "cgnr"):
        # a fixed number of Krylov steps a sweep; cgne and cgnr carry A^H,
        # so that they are the normal-equation iterations on any A
        AT = None
        if fn_name in ("cgne", "cgnr"):
            AT = _adjoint_operator(A_csr, npdt, device)
        return SmootherData(kind=f"{fn_name}_smoother",
                            iterations=max(iterations, 1), AT=AT)

    if fn_name in ("schwarz", "strength_based_schwarz"):
        # strength_based_schwarz takes A's rows too: the JAX package
        # computes a strength matrix for it and never reads it
        return _schwarz_data(A_csr, iterations, kwargs, dev)
    raise ValueError(f"unknown smoother {fn_name!r}")


def _block_line_data(A_csr, grid, q, fn_name, iterations, sweep, kwargs,
                     dev) -> SmootherData:
    """Line-smoother state of a node-blocked grid level (q dofs a node):
    ``line_tri`` (3, q, q, nlines, L), the sub-, main and super-diagonal
    node blocks of the lines along the strong axis, in the JAX package's
    component layout (block indices leading).  A dof whose rows are all
    zero (an eliminated adaptive-SA candidate) gets a 1 on its diagonal,
    so that every node block stays invertible; its residual is 0, so its
    update is too."""
    nb = int(np.prod(grid))
    A_bsr = A_csr.tobsr(blocksize=(q, q))
    A_bsr.sort_indices()
    strides = _grid_strides(grid)
    axis = kwargs.get("axis")
    if axis is None:        # the strongest same-dof coupling direction
        axis = int(np.argmax([np.abs(A_csr.diagonal(st * q)).sum()
                              for st in strides]))
    axis = axis % len(grid)
    stride = strides[axis]
    L = grid[axis]
    brows = np.repeat(np.arange(nb), np.diff(A_bsr.indptr))
    delta = A_bsr.indices - brows
    blocks = {}
    for name, want in (("d", 0), ("du", stride), ("dl", -stride)):
        blocks[name] = np.zeros((nb, q, q), dtype=A_csr.dtype)
        m = delta == want
        blocks[name][brows[m]] = A_bsr.data[m]
    d, du, dl = blocks["d"], blocks["du"], blocks["dl"]
    coords = np.unravel_index(np.arange(nb), grid)
    du[coords[axis] == L - 1] = 0.0
    dl[coords[axis] == 0] = 0.0
    rowmass = (np.abs(d).sum(axis=2) + np.abs(du).sum(axis=2)
               + np.abs(dl).sum(axis=2))
    nz_n, nz_q = np.nonzero(rowmass == 0)
    d[nz_n, nz_q, nz_q] = 1.0

    def lines(blk):         # (nlines, L, q, q), the line axis innermost
        g = np.moveaxis(blk.reshape(grid + (q, q)), axis, len(grid) - 1)
        return g.reshape(-1, L, q, q)

    tri = np.stack([lines(dl), lines(d), lines(du)]).transpose(0, 3, 4, 1, 2)
    omega = float(kwargs.get("omega",
                             0.7 if fn_name == "line_jacobi" else 1.0))
    return SmootherData(kind="line_jacobi" if fn_name == "line_jacobi"
                        else "zebra", iterations=iterations, sweep=sweep,
                        omega=omega, line_tri=dev(np.ascontiguousarray(tri)),
                        grid=grid, line_axis=axis)


def schwarz_dof_slots(idx, n):
    """``(dof_slots, dof_weight)`` of a (n_dom, L) subdomain table (-1
    padded) over n dofs: each dof's positions in the flattened table, in
    ascending order, padded with n_dom * L; and the inverse of their count
    (1 for a dof in no subdomain)."""
    flat = np.flatnonzero(idx.ravel() >= 0)
    dofs = idx.ravel()[flat]
    order = np.argsort(dofs, kind="stable")
    counts = np.bincount(dofs, minlength=n)
    M = max(int(counts.max()) if counts.size else 0, 1)
    rank = np.arange(flat.size) - np.repeat(np.cumsum(counts) - counts,
                                            counts)
    slots = np.full((n, M), idx.size, dtype=np.int64)
    slots[dofs[order], rank] = flat[order]
    return slots, 1.0 / np.maximum(counts, 1)


def _schwarz_data(A_csr, iterations, kwargs, dev) -> SmootherData:
    """Additive Schwarz state: the (n_dom, L) subdomain table (-1 padded),
    the (n_dom, L, L) inverses, and for each dof its slots in the flattened
    (n_dom * L) corrections (``dof_slots``, padded with the index of an
    appended zero) with the inverse of their count (``dof_weight``), so
    that the step sums each dof's corrections by a gather in a fixed
    order."""
    from .relaxation import schwarz_parameters, subdomain_groups

    sub, sub_ptr, inv, inv_ptr = schwarz_parameters(
        A_csr, kwargs.get("subdomain"), kwargs.get("subdomain_ptr"),
        kwargs.get("inv_subblock"), kwargs.get("inv_subblock_ptr"))
    n = A_csr.shape[0]
    n_dom = sub_ptr.shape[0] - 1
    sizes = np.diff(sub_ptr).astype(np.int64)
    L = int(sizes.max()) if n_dom else 1
    idx = np.full((n_dom, L), -1, dtype=np.int64)
    binv = np.zeros((n_dom, L, L), dtype=A_csr.dtype)
    for s, doms in subdomain_groups(sizes):
        idx[doms, :s] = sub[sub_ptr[doms][:, None] + np.arange(s)]
        binv[doms, :s, :s] = inv[inv_ptr[doms][:, None]
                                 + np.arange(s * s)].reshape(-1, s, s)
    slots, weight = schwarz_dof_slots(idx, n)
    return SmootherData(kind="schwarz", iterations=iterations,
                        omega=float(kwargs.get("omega", 1.0)),
                        subdomain_idx=dev(idx, None),
                        subdomain_inv=dev(binv), dof_slots=dev(slots, None),
                        dof_weight=dev(weight.astype(A_csr.dtype)))


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
