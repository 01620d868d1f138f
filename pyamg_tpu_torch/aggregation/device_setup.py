"""Smoothed-aggregation setup on the device for grid-structured problems.

For a stencil-structured fine operator every numeric setup step runs on
the hierarchy's device, with no sparse assembly and no host round trip
inside a level:

* the spectral radius of D^-1 A by power iteration (DIA matvecs on the
  hand-written kernel; no host sync inside the loop);
* the Jacobi smoothing factor S = I - (omega/rho) D^-1 A by DIA arithmetic
  on A's offsets;
* the tentative prolongation's weights by grid pooling of the
  near-nullspace candidate (the one-candidate case of ``fit_candidates``'
  per-aggregate QR);
* the Galerkin product A_c = R A P by comb-vector probing: on a coarse
  grid the 3^d mod-3 classes of coarse nodes lie far enough apart that
  R A P applied to a class's indicator vector gives exactly one
  coarse-stencil entry per row, so 3^d applications rebuild the whole
  coarse DIA operator (no SpGEMM);
* geometric multicolor masks for the Gauss-Seidel smoothers.

The host keeps the static bookkeeping (shapes, offsets, class selectors)
and the coarsest level's small dense factorization.

Port of ``pyamg_tpu/aggregation/device_setup.py``.  The power iteration
starts from a seeded normal vector drawn by :func:`_power_start`; JAX's
random stream cannot be reproduced in torch, so rho, and with it every
value of P, differs from the JAX package's by the power iteration's error
unless both start from the same vector.

Over a mesh of ranks (``mesh=``, ``parallel.make_mesh``) the construction
itself is spread: a level is row-sharded while its size divides the ranks
(the JAX package's rule), else whole on every rank.  The diagonals are
:class:`~pyamg_tpu_torch.sparse.dia.ShardedDIA` slabs, the power
iteration's norms are summed over the ranks and its start vector is the
one seeded whole vector, sliced; S is row-local and S^T reads the
neighbours' rows; the tentative transfers pool and repeat across shard
boundaries; the comb probes run through the sharded P, A and R, each
rank keeping the probe tables of its coarse rows.  Only the coarsest
level's host matrix is gathered, for the dense coarse solve.
"""

from __future__ import annotations

import itertools

import numpy as np
import scipy.sparse as sp
import torch

from ..multilevel import Level, MultilevelSolver
from ..relaxation.device import SmootherData
from ..sparse import ComposedOp, GridPoolOp, GridRepeatOp, SparseDIA
from ..sparse.dia import ShardedDIA
from ..sparse.linop import (GatheredOp, ShardedGridPoolOp,
                            ShardedGridRepeatOp)
from ..util import profiling
from ..util.utils import numpy_dtype, torch_dtype

__all__ = ["structured_sa_setup", "device_rap", "device_smoothing_factor",
           "device_power_rho", "dia_transpose"]


def _grid_offsets(grid):
    """Flat offsets of the full 3^d stencil on a row-major grid, and the
    grid's strides."""
    d = len(grid)
    strides = [int(np.prod(grid[k + 1:])) for k in range(d)]
    offs = {sum(dd * s for dd, s in zip(deltas, strides))
            for deltas in itertools.product((-1, 0, 1), repeat=d)}
    return sorted(offs), strides


def _power_start(n, dtype, seed, device):
    """The power iteration's start vector: n standard normal numbers from
    a CPU generator seeded with ``seed`` (the same numbers on every
    device)."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    return torch.randn(n, generator=gen, dtype=torch.float64) \
        .to(device=device, dtype=dtype)


def device_power_rho(A: SparseDIA, dinv, n_iter: int = 30, seed: int = 0):
    """Spectral radius of D^-1 A by ``n_iter`` steps of power iteration,
    on A's device: a 0-d tensor, read by no host sync here.  On a
    row-sharded A the start vector is this rank's rows of the whole one
    and the norms are the whole vector's."""
    v = torch.as_tensor(_power_start(A.shape[0], A.dtype, seed, A.device),
                        dtype=A.dtype, device=A.device)
    layout = getattr(A, "layout", None)
    vnorm = torch.linalg.vector_norm
    if layout is not None:
        v, vnorm = layout.local(v), layout.norm
    lam = torch.ones((), dtype=A.dtype, device=A.device)
    for _ in range(int(n_iter)):
        w = dinv * A.matvec(v)
        lam = vnorm(w)
        v = w / torch.clamp(lam, min=1e-30)
    return lam


def device_smoothing_factor(A: SparseDIA, omega_over_rho) -> SparseDIA:
    """S = I - c D^-1 A as a DIA operator on A's offsets (offset 0 added
    when A lacks it)."""
    d = A.diagonal()
    dinv = torch.where(d != 0, 1.0 / torch.where(d != 0, d, 1), 0)
    diags = -omega_over_rho * dinv[None, :] * A.diags
    offsets = A.offsets
    if 0 not in offsets:
        offsets = tuple(sorted(set(A.offsets) | {0}))
        full = diags.new_zeros((len(offsets), A.shape[0]))
        full[[offsets.index(o) for o in A.offsets]] = diags
        diags = full
    diags[offsets.index(0)] += 1.0
    return A.like(diags, offsets)


def dia_transpose(S: SparseDIA) -> SparseDIA:
    """Transpose of a square DIA operator on its device: the (o) diagonal
    of S^T at row j is S's (-o) diagonal at row j + o, a shift of each
    diagonal filled with zeros (on a row-sharded S, read from the
    neighbours' rows)."""
    if isinstance(S, ShardedDIA):
        return S.transpose()
    n, m = S.shape
    offsets = tuple(-o for o in reversed(S.offsets))
    diags = []
    for o in offsets:
        src = S.diags[S.offsets.index(-o)]
        pad = src.new_zeros(abs(o))
        diags.append(torch.cat([src[o:], pad]) if o >= 0
                     else torch.cat([pad, src[:o]]))
    return SparseDIA(torch.stack(diags), offsets, (m, n))


def _class_arrays(cgrid):
    """Per-node coordinate arrays of a grid (host, int32)."""
    coords = np.unravel_index(np.arange(int(np.prod(cgrid))), cgrid)
    return [c.astype(np.int32) for c in coords]


def _probe_tables(cgrid):
    """The host tables of the comb probes of a coarse grid: the (3^d, nc)
    class indicators, and for each coarse-stencil offset in ascending order
    the row of the probe results that feeds it at each node (``sel``) and
    whether the neighbour lies in the grid (``valid``)."""
    d = len(cgrid)
    nc = int(np.prod(cgrid))
    _, strides = _grid_offsets(cgrid)
    coords = _class_arrays(cgrid)
    classes = list(itertools.product(range(3), repeat=d))
    combs = np.ones((len(classes), nc), dtype=bool)
    for i, cls in enumerate(classes):
        for k in range(d):
            combs[i] &= (coords[k] % 3) == cls[k]
    entries = []
    for deltas in itertools.product((-1, 0, 1), repeat=d):
        off = sum(dd * s for dd, s in zip(deltas, strides))
        # the class of node i's neighbour, in the mixed radix of
        # itertools.product's order (last coordinate fastest)
        sel = np.zeros(nc, dtype=np.int64)
        valid = np.ones(nc, dtype=bool)
        for k in range(d):
            sel = sel * 3 + (coords[k] + deltas[k]) % 3
            valid &= (coords[k] + deltas[k] >= 0) & \
                (coords[k] + deltas[k] < cgrid[k])
        entries.append((off, sel, valid))
    entries.sort(key=lambda t: t[0])          # stable, as the JAX code's
    return (combs, tuple(t[0] for t in entries),
            np.stack([t[1] for t in entries]),
            np.stack([t[2] for t in entries]))


def device_rap(P, R, A: SparseDIA, cgrid, layout=None) -> SparseDIA:
    """A_c = R A P on A's device by 3^d comb-vector probes (exact for
    coarse stencils within the 3^d neighbourhood).  ``layout``: the coarse
    level's over a mesh; a row-sharded one gets this rank's rows of the
    probes' tables and of A_c (a :class:`ShardedDIA`)."""
    with profiling.span("probe_tables", host=True):
        combs, offsets, sel, valid = _probe_tables(cgrid)
    nc = combs.shape[1]
    sharded = layout is not None and layout.sharded
    if sharded:
        mine = slice(layout.start, layout.start + layout.nl)
        combs, sel, valid = combs[:, mine], sel[:, mine], valid[:, mine]
    dev, dt = A.device, A.dtype
    combs = torch.as_tensor(combs, device=dev).to(dt)
    Y = torch.stack([R.matvec(A.matvec(P.matvec(c))) for c in combs])
    diags = torch.gather(Y, 0, torch.as_tensor(sel, device=dev)) \
        * torch.as_tensor(valid, device=dev).to(dt)
    if sharded:
        return ShardedDIA(diags, offsets, layout)
    return SparseDIA(diags, offsets, (nc, nc))


def _geometric_masks(grid, two_colors, dtype, device):
    """(ncolors, n) 0/1 color masks of a grid: the checkerboard, or the
    2^d parity classes."""
    with profiling.span("masks", host=True):
        n = int(np.prod(grid))
        coords = _class_arrays(grid)
        colors = np.zeros(n, dtype=np.int64)
        for c in coords:
            colors = colors + c if two_colors else colors * 2 + (c % 2)
        if two_colors:
            colors %= 2
        nc = 2 if two_colors else 2 ** len(grid)
        masks = np.zeros((nc, n), dtype=np.float32)
        masks[colors, np.arange(n)] = 1.0
    return torch.as_tensor(masks, device=device).to(dtype)


def _tentative(wmap, cur_grid, blk, n, nc, fine, coarse, like=None):
    """``(T, T^T)`` on one device (``fine`` None), or over a mesh with
    the fine and coarse levels' layouts; ``like``: the pair of an earlier
    call on the same level, whose index tables are reused."""
    if fine is None:
        return (GridRepeatOp(wmap, cur_grid, blk, (n, nc)),
                GridPoolOp(wmap, cur_grid, blk, (nc, n)))
    if fine.sharded:
        if like is not None:
            return like[0].with_wmap(wmap), like[1].with_wmap(wmap)
        return (ShardedGridRepeatOp(wmap, cur_grid, blk, fine, coarse),
                ShardedGridPoolOp(wmap, cur_grid, blk, fine, coarse))
    return (GatheredOp(GridRepeatOp(wmap, cur_grid, blk, (n, nc)), fine,
                       coarse),
            GatheredOp(GridPoolOp(wmap, cur_grid, blk, (nc, n)), coarse,
                       fine))


def _build_level(A_l, B_l, cur_grid, blk, deg, omega, dtype, fine=None,
                 coarse=None):
    """One level of the device setup: ``(P, R, A_c, B_c, dinv)``.  Over a
    mesh, ``fine`` and ``coarse`` are the two levels' layouts."""
    n = int(np.prod(cur_grid))
    with profiling.span("rho", host=False):
        dvec = A_l.diagonal()
        dinv = torch.where(dvec != 0,
                           1.0 / torch.where(dvec != 0, dvec, 1), 0)
        rho = device_power_rho(A_l, dinv)
    with profiling.span("smoothing", host=False):
        S = device_smoothing_factor(A_l, omega / rho)
        ST = dia_transpose(S)

    cgrid = tuple(-(-g // b) for g, b in zip(cur_grid, blk))
    nc = int(np.prod(cgrid))
    with profiling.span("tentative", host=False):
        ones = torch.ones(B_l.shape[0], dtype=dtype, device=A_l.device)
        rep1, pool1 = _tentative(ones, cur_grid, blk, n, nc, fine, coarse)
        agg_nrm = torch.sqrt(torch.clamp(pool1.matvec(torch.abs(B_l) ** 2),
                                         min=1e-30))
        wmap = B_l * rep1.matvec(1.0 / agg_nrm)
        T, Tt = _tentative(wmap, cur_grid, blk, n, nc, fine, coarse,
                           like=(rep1, pool1))
    if deg > 0:
        P = ComposedOp([S] * deg + [T], (n, nc))
        R = ComposedOp([Tt] + [ST] * deg, (nc, n))
    else:
        P, R = T, Tt
    with profiling.span("rap", host=False):
        Ac = device_rap(P, R, A_l, cgrid, coarse)
    return P, R, Ac, agg_nrm, dinv


@profiling.setup_spans
def structured_sa_setup(A, grid, block=None, omega=4.0 / 3.0, degree=1,
                        max_levels=10, max_coarse=200,
                        presmoother_sweep="symmetric",
                        coarse_solver="pinv", dtype=torch.float32,
                        mesh=None, mesh_axis=None, device="cuda"):
    """Build an SA hierarchy for a stencil matrix with the numeric setup on
    ``device``.  ``A`` may be a scipy matrix or a :class:`SparseDIA`;
    ``dtype`` (numpy or torch) is the type of every device array.

    Keywords and defaults are the JAX package's.  Each level's P is
    ``S^degree T`` and R its transpose, as composed DIA and grid operators;
    the smoothers are mask-form Gauss-Seidel with geometric colors (the
    checkerboard for a cross stencil, 2^d colors otherwise).  Only the
    coarsest level carries a host matrix ``A_csr``.

    ``mesh`` (``parallel.make_mesh``) spreads the construction over its
    ranks, on the mesh's device: every rank of the mesh calls this with
    the same arguments and gets the same hierarchy, each level row-sharded
    while its size divides the ranks (``layout`` on each level), and its
    solves take and return whole vectors.  The one-rank mesh of a process
    without a process group builds on one device."""
    if mesh is not None:
        from ..parallel.sharding import _check_mesh

        mesh = _check_mesh(mesh)
        device = mesh.device
        if not mesh.distributed:
            mesh = None
    dtype = torch_dtype(dtype)
    if not isinstance(A, SparseDIA):
        A = SparseDIA.from_scipy(sp.csr_matrix(A), dtype=numpy_dtype(dtype),
                                 device="cpu" if mesh else device)
    diags, offsets, shape = A.diags.to(dtype), A.offsets, A.shape

    grid = tuple(int(g) for g in grid)
    if int(np.prod(grid)) != shape[0]:
        raise ValueError(f"grid {grid} has {int(np.prod(grid))} nodes but "
                         f"A is {shape[0]}x{shape[1]}")
    d = len(grid)
    if block is None:
        block = (3,) * d

    # Exactness guards of the comb-probe RAP: P = S^degree T spreads each
    # coarse basis function `degree` fine cells beyond its block, so the
    # coarse stencil stays within the 3^d neighbourhood iff 2*degree <
    # min(block); and A itself must live on the fine 3^d stencil.
    if 2 * degree >= min(block):
        raise ValueError(
            f"structured_sa_setup: comb-probe RAP is exact only when "
            f"2*degree < min(block); got degree={degree}, block={block}. "
            f"Use a larger block or the host-staged "
            f"smoothed_aggregation_solver for this configuration.")
    valid_offs, _ = _grid_offsets(grid)
    if not set(offsets) <= set(valid_offs):
        bad = sorted(set(offsets) - set(valid_offs))
        raise ValueError(
            f"structured_sa_setup: A has offsets {bad} outside the 3^{d} "
            f"stencil of grid {grid}; the comb-probe RAP would be inexact. "
            f"Use the host-staged smoothed_aggregation_solver instead.")

    def layout_of(n):
        """A level's layout over the mesh: row-sharded while n divides
        the ranks (None on one device)."""
        if mesh is None:
            return None
        from ..parallel.mesh import Layout

        return Layout(mesh, n, n % mesh.size == 0)

    lay = layout_of(shape[0])
    if lay is not None and lay.sharded:
        A_dev = ShardedDIA(lay.local(diags.T).T.contiguous().to(device),
                           offsets, lay)
    else:
        A_dev = SparseDIA(diags.to(device), offsets, shape)

    levels = []
    B = torch.ones(shape[0] if lay is None else lay.nl, dtype=dtype,
                   device=device)
    cur_grid = grid
    while len(levels) < max_levels - 1 and A_dev.shape[0] > max_coarse:
        with profiling.span("setup.level", level=len(levels),
                            rows=A_dev.shape[0]):
            cgrid = tuple(-(-g // b) for g, b in zip(cur_grid, block))
            clay = layout_of(int(np.prod(cgrid)))
            P, R, A_c, B_c, dinv = _build_level(A_dev, B, cur_grid, block,
                                                degree, omega, dtype, lay,
                                                clay)
            strides = [int(np.prod(cur_grid[k + 1:])) for k in range(d)]
            cross = {0} | set(strides) | {-s for s in strides}
            masks = _geometric_masks(cur_grid, set(A_dev.offsets) <= cross,
                                     dtype, device)
            if lay is not None:
                masks = lay.local(masks.T).T.contiguous()
            sm = SmootherData(kind="gauss_seidel", iterations=1,
                              sweep=presmoother_sweep, dinv=dinv,
                              color_masks=masks)
            levels.append(Level(A=A_dev, grid=cur_grid, P=P, R=R,
                                presmoother=sm, postsmoother=sm, layout=lay))
            A_dev, B, lay = A_c, B_c, clay
            cur_grid = cgrid

    # the coarsest level's host matrix feeds the dense coarse solve; the
    # finer levels' are rebuilt on demand (Level.host_A)
    with profiling.span("coarsest_csr", host=True):
        A_csr = A_dev.to_scipy()
    levels.append(Level(A=A_dev, grid=cur_grid, A_csr=A_csr, layout=lay))
    ml = MultilevelSolver(levels, coarse_solver=coarse_solver, device=device)
    ml._smoother_config = (("gauss_seidel",
                            {"sweep": presmoother_sweep}),) * 2
    return ml
