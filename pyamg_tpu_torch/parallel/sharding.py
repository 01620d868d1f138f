"""Hierarchies sharded by rows over a mesh of ranks, and their solvers.

Port of ``pyamg_tpu/parallel/sharding.py``.  Every rank runs the same code
on its own rows of each level (SPMD over ``torch.distributed``; see
``mesh.py``), and every entry point takes and returns whole vectors on
every rank, on that rank's device.

* ``shard_solver`` / ``ShardedSolver``: any hierarchy (each rank passes the
  same one) re-expressed as padded-ELL levels built from the host CSR
  matrices, with sizes padded to a multiple of the ranks (times the
  blocksize and a line smoother's whole grid slab): each A, P and R is a
  :class:`~.halo.HaloELL` where the exchange pays and a full-gather ELL
  otherwise; the coarse dense pseudoinverse is replicated and padded.
* ``shard_structured_solver`` / ``StructuredShardedSolver``: a structured
  (DIA and grid-operator) hierarchy re-placed level by level by the JAX
  package's rule: a level is row-sharded when its size divides the ranks
  and is at least ``min_shard_rows``, else whole on every rank.

Smoothers: the weighted Jacobi, Richardson, polynomial, mask-form
Gauss-Seidel and SOR, block Jacobi and block Gauss-Seidel, and the NE/NR
Jacobi steps run on this rank's rows with the level's sharded operators;
gather-form Gauss-Seidel, Schwarz, the line smoothers and the Krylov
smoothers read whole vectors: x and b are gathered, the one-device steps
run on them on every rank (the level's operator applied through its
shards) and each rank keeps its rows.

``ShardedSolver.from_sharded_levels`` assembles the levels that the
general, root-node, adaptive and classical setups build over the ranks
(``setup.py``, ``classical_setup.py``; on one device, whole padded-ELL
levels).

Examples
--------
>>> import numpy as np
>>> from pyamg_tpu_torch.gallery import poisson
>>> from pyamg_tpu_torch import smoothed_aggregation_solver
>>> from pyamg_tpu_torch.parallel import make_mesh, shard_solver
>>> A = poisson((12, 12), format='csr')
>>> ml = smoothed_aggregation_solver(A, device="cpu")
>>> sol = shard_solver(ml, mesh=make_mesh(1, device="cpu"))
>>> x = sol.solve(np.ones(A.shape[0]), tol=1e-8, maxiter=100, accel='cg')
>>> bool(np.linalg.norm(1 - A @ x.numpy()) < 1e-6 * 12)
True
"""

from __future__ import annotations

import math
from dataclasses import replace

import numpy as np
import torch

from ..multilevel import Level, MultilevelSolver
from ..relaxation.device import SmootherData, apply_smoother
from ..sparse.dia import ShardedDIA, SparseDIA
from ..sparse.ell import SparseELL, ell_matvec
from ..sparse.linop import (ComposedOp, GatheredOp, GridPoolOp,
                            GridRepeatOp, ShardedGridPoolOp,
                            ShardedGridRepeatOp)
from .halo import GatherELL, build_halo_ell, gather_ell
from .mesh import Layout, Mesh, make_mesh

__all__ = ["make_mesh", "shard_solver", "ShardedSolver", "pad_to",
           "shard_structured_solver", "StructuredShardedSolver"]

_STRUCTURED_ACCELS = ("cg", "bicgstab", "gmres", "fgmres", None)
# the smoothers whose steps read only this rank's rows and the level's
# sharded operators; every other kind reads whole vectors
_LOCAL_KINDS = ("jacobi", "richardson", "polynomial", "chebyshev",
                "gauss_seidel", "multicolor_gauss_seidel", "sor",
                "block_jacobi", "block_gauss_seidel",
                "multicolor_block_gauss_seidel", "jacobi_ne", "jacobi_nr")


def pad_to(n: int, k: int) -> int:
    """n rounded up to a multiple of k."""
    return -(-n // k) * k


def _pad_ell(E: SparseELL, n_rows_pad: int, n_cols_pad: int) -> SparseELL:
    """E with structurally empty rows and columns appended: padding rows
    hold data 0 and column 0, so SpMV gives 0 there and gathers stay in
    bounds."""
    n, w = E.shape[0], E.width
    data = E.data.new_zeros((n_rows_pad, w))
    cols = E.cols.new_zeros((n_rows_pad, w))
    nnz = E.row_nnz.new_zeros((n_rows_pad,))
    data[:n], cols[:n], nnz[:n] = E.data, E.cols, E.row_nnz
    return SparseELL(data, cols, nnz, (n_rows_pad, n_cols_pad))


def _check_mesh(mesh):
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a pyamg_tpu_torch.parallel.Mesh "
                        f"(make_mesh); got {type(mesh).__name__}")
    if mesh.rank is None:
        raise ValueError("this rank is not a member of the mesh")
    return mesh


def _same_hierarchy(mesh, ml):
    """Raise unless every rank of the mesh passed a hierarchy of the same
    levels, shapes and nonzeros."""
    mine = [(tuple(lvl.host_A().shape), int(lvl.host_A().nnz))
            for lvl in ml.levels]
    if any(other != mine for other in mesh.all_gather_object(mine)):
        raise ValueError("the ranks passed different hierarchies: every "
                         "rank must shard the same one")


# -- smoothers ---------------------------------------------------------------

def _line_pad_quantum(sm) -> int:
    """The row quantum a line smoother needs for padding: one whole
    leading-axis slab of the level's grid (times its dofs a node)."""
    if sm is None or sm.line_tri is None or not sm.grid:
        return 1
    q = sm.line_tri.shape[1] if sm.line_tri.dim() == 5 else 1
    return int(np.prod(sm.grid[1:])) * q


def _pad_lines(sm, n_pad):
    """``(line_tri, grid)`` of a line smoother padded to ``n_pad`` rows by
    whole axis-0 slabs: the tridiagonal systems gain decoupled identity
    rows (lines along axis 0) or whole identity lines (along another
    axis), so the padding's correction is zero and the original lines'
    solves are unchanged."""
    tri, grid = sm.line_tri, sm.grid
    blocked = tri.dim() == 5               # (3, q, q, nlines, L)
    q = tri.shape[1] if blocked else 1
    slab = int(np.prod(grid[1:])) * q
    if int(np.prod(grid)) * q == n_pad:
        return tri, grid
    if n_pad % slab:
        raise ValueError(f"padded size {n_pad} is not a whole number of grid "
                         f"slabs ({slab} rows) for the {sm.kind!r} line "
                         "smoother")
    g0 = n_pad // slab
    tri = tri.cpu().numpy()
    if sm.line_axis % len(grid) == 0:
        # lines run along the padded axis: each gains an identity tail
        L = tri.shape[-1]
        new = np.zeros(tri.shape[:-1] + (g0,), dtype=tri.dtype)
        new[..., :L] = tri
        if blocked:
            for i in range(q):
                new[1, i, i, :, L:] = 1.0
            new[2, :, :, :, L - 1:] = 0.0
        else:
            new[1, :, L:] = 1.0
            new[2, :, L - 1:] = 0.0
    else:
        # whole new lines after the original ones
        ax = 3 if blocked else 1
        nlines = tri.shape[ax]
        shape = list(tri.shape)
        shape[ax] = g0 * int(np.prod(grid[1:])) // int(grid[sm.line_axis])
        new = np.zeros(shape, dtype=tri.dtype)
        if blocked:
            new[:, :, :, :nlines] = tri
            for i in range(q):
                new[1, i, i, nlines:] = 1.0
        else:
            new[:, :nlines] = tri
            new[1, nlines:] = 1.0
    return (torch.as_tensor(new, device=sm.line_tri.device),
            (g0,) + tuple(grid[1:]))


def _padded(v, n_pad, dim=0):
    """v with zeros appended along ``dim`` up to ``n_pad``."""
    if v is None or v.shape[dim] == n_pad:
        return v
    shape = list(v.shape)
    shape[dim] = n_pad - v.shape[dim]
    return torch.cat([v, v.new_zeros(shape)], dim=dim)


class _WholeView:
    """A sharded operator applied to whole vectors on every rank (a
    full-gather ELL reads the whole x it is given)."""

    def __init__(self, op, layout):
        self.op, self.layout = op, layout
        self.shape, self.dtype = op.shape, op.dtype

    def astype(self, dtype):
        return _WholeView(self.op.astype(dtype), self.layout)

    def matvec(self, x):
        lay, op = self.layout, self.op
        if isinstance(op, GatherELL):
            return lay.full(ell_matvec(op.data, op.cols, x))
        return lay.full(op.matvec(lay.local(x)))


class WholeVectorSmoother:
    """A sharded level's smoother whose steps read whole vectors: x and b
    are gathered, the one-device steps run on them on every rank with the
    level's operator applied through its shards, and each rank keeps its
    rows.  ``sm`` holds the whole (padded) smoother state."""

    def __init__(self, sm: SmootherData, layout):
        self.sm, self.layout = sm, layout
        self.kind, self.iterations = sm.kind, sm.iterations

    def astype(self, dtype):
        return WholeVectorSmoother(self.sm.astype(dtype), self.layout)

    def apply(self, A, x, b):
        lay = self.layout
        xf = apply_smoother(self.sm, _WholeView(A, lay), lay.full(x),
                            lay.full(b))
        return lay.local(xf)


def _shard_smoother(sm, layout, at_op=None):
    """A level's smoother on ``layout`` (padded to ``layout.n`` rows):
    this rank's rows of its state, or the whole state behind a
    :class:`WholeVectorSmoother`.  ``at_op(AT)`` places the NE/NR
    smoothers' A^H."""
    if sm is None or sm.kind in ("none", None):
        return sm
    n_pad = layout.n
    AT = None if sm.AT is None else at_op(sm.AT)
    if sm.kind in _LOCAL_KINDS and sm.color_rows is None:
        def mine(v, dim=0):
            v = _padded(v, n_pad, dim)
            if v is None or not layout.sharded:
                return v
            return v.narrow(dim, layout.start, layout.nl).contiguous()

        bd = sm.block_dinv
        if bd is not None:
            bs = bd.shape[-1]
            bd = _padded(bd, n_pad // bs)
            if layout.sharded:
                bd = bd[layout.start // bs:(layout.start + layout.nl) // bs]
        return replace(sm, dinv=mine(sm.dinv),
                       color_masks=mine(sm.color_masks, 1), block_dinv=bd,
                       dinv_ne=mine(sm.dinv_ne), AT=AT)
    whole = replace(sm, dinv=_padded(sm.dinv, n_pad),
                    AT=None if AT is None else _WholeView(AT, layout))
    if sm.line_tri is not None:
        tri, grid = _pad_lines(sm, n_pad)
        whole = replace(whole, line_tri=tri, grid=grid)
    if sm.dof_slots is not None and sm.dof_slots.shape[0] < n_pad:
        # padding dofs read the appended zero of the corrections
        extra = n_pad - sm.dof_slots.shape[0]
        fill = sm.subdomain_idx.numel()
        whole = replace(
            whole,
            dof_slots=torch.cat([sm.dof_slots, sm.dof_slots.new_full(
                (extra, sm.dof_slots.shape[1]), fill)]),
            dof_weight=_padded(sm.dof_weight, n_pad))
    return WholeVectorSmoother(whole, layout)


# -- padded-ELL hierarchies ----------------------------------------------------

def _host_csr(op):
    """The host CSR matrix of a level's operator."""
    return op.to_scipy().tocsr()


class ShardedSolver:
    """A :class:`MultilevelSolver` over padded-ELL levels sharded by rows
    over a mesh of ranks (on one device: the padded levels the general
    setups build).

    ``solve`` pads the right-hand side to the padded size of level 0, runs
    the inner solver's cycle and Krylov loop, and returns the solution's
    first ``n_orig`` entries, as a tensor on this rank's device (every
    rank gets the whole x)."""

    def __init__(self, ml: MultilevelSolver, mesh, axis_name: str = "rows",
                 halo: str = "pack"):
        mesh = _check_mesh(mesh)
        if halo not in ("pack", "gather"):
            raise ValueError("halo must be 'pack' or 'gather'")
        _same_hierarchy(mesh, ml)
        self.mesh, self.halo = mesh, halo
        self.axis = mesh.axis_name      # the mesh's one axis, as named
        self.device = mesh.device
        self.n_orig = ml.levels[0].host_A().shape[0]
        nd = mesh.size

        sizes = []
        for lvl in ml.levels:
            quantum = nd * max(getattr(lvl, "blocksize", 1) or 1, 1)
            for sm in (lvl.presmoother, lvl.postsmoother):
                quantum = math.lcm(quantum, _line_pad_quantum(sm))
            sizes.append(pad_to(lvl.host_A().shape[0], quantum))
        self.sizes = sizes
        layouts = [Layout(mesh, n, True) for n in sizes]

        def place(M, rows, cols):
            """This rank's rows of M padded to the layouts: a HaloELL
            where the exchange pays, else the full-gather form."""
            E = _pad_ell(SparseELL.from_scipy(M, device="cpu"), rows.n,
                         cols.n)
            if halo == "pack":
                H = build_halo_ell(E, mesh, self.axis)
                if H is not None:
                    return H
            return gather_ell(E, mesh)

        levels = []
        for i, lvl in enumerate(ml.levels):
            lay = layouts[i]
            new = Level(A_csr=lvl.host_A(), layout=lay)
            new.A = place(new.A_csr, lay, lay)
            if i + 1 < len(ml.levels):
                new.P_csr = getattr(lvl, "P_csr", None)
                new.R_csr = getattr(lvl, "R_csr", None)
                if new.P_csr is None:
                    new.P_csr, new.R_csr = _host_csr(lvl.P), _host_csr(lvl.R)
                new.P = place(new.P_csr, lay, layouts[i + 1])
                new.R = place(new.R_csr, layouts[i + 1], lay)

            def at_op(AT, lay=lay):
                return place(_host_csr(AT), lay, lay)

            new.presmoother = _shard_smoother(lvl.presmoother, lay, at_op)
            new.postsmoother = _shard_smoother(lvl.postsmoother, lay, at_op)
            levels.append(new)
        self._finalize(levels, None, ml.coarse_solver_spec)

    @classmethod
    def from_sharded_levels(cls, levels, sizes, mesh, axis_name=None,
                            n_orig=None, coarse=None):
        """Assemble from levels a setup built on ``mesh`` (the JAX
        package's signature; ``axis_name`` names the mesh's one axis):
        each level's operators already padded to ``sizes`` and placed --
        this rank's rows, as :class:`~.halo.HaloELL` or
        :class:`~.halo.GatherELL` on the level's ``layout``, over a
        process group; whole padded SparseELLs on the one-rank mesh
        without one.  ``coarse``: the coarsest level's padded
        pseudoinverse (a tensor); by default it is computed from that
        level's ``A_csr`` on every rank."""
        self = object.__new__(cls)
        self.sizes, self.n_orig = list(sizes), int(n_orig)
        self.mesh = mesh if mesh.distributed else None
        self.axis = axis_name or mesh.axis_name
        self.device = mesh.device
        self._finalize(levels, coarse)
        return self

    def _finalize(self, levels, coarse, coarse_spec="pinv"):
        self.inner = MultilevelSolver(levels, coarse_solver=coarse_spec,
                                      device=self.device)
        if coarse is None:
            A_c = levels[-1].A_csr
            nc = A_c.shape[0]
            pinv = np.zeros((self.sizes[-1],) * 2, dtype=A_c.dtype)
            pinv[:nc, :nc] = np.linalg.pinv(A_c.toarray())
            coarse = torch.as_tensor(pinv, device=self.device)
        self.inner._coarse_mat = coarse

    @property
    def levels(self):
        return self.inner.levels

    def cycle_fn(self, cycle="V"):
        return self.inner.cycle_fn(cycle)

    def _pad_vec(self, b):
        b = torch.as_tensor(b, device=self.device).reshape(-1)
        out = b.new_zeros(self.sizes[0])
        out[:self.n_orig] = b
        return out

    def solve(self, b, **kw):
        """``MultilevelSolver.solve`` on the padded system; same keyword
        arguments.  Returns x (or ``(x, info)`` with ``return_info``)."""
        out = self.inner.solve(self._pad_vec(b), **kw)
        if isinstance(out, tuple):
            return (out[0][:self.n_orig],) + tuple(out[1:])
        return out[:self.n_orig]

    def __repr__(self):
        nd = 1 if self.mesh is None else self.mesh.size
        return f"ShardedSolver(devices={nd}, levels={len(self.levels)})\n" \
            + repr(self.inner)


def shard_solver(ml: MultilevelSolver, mesh=None, n_devices=None,
                 axis_name: str = "rows", halo: str = "pack") -> ShardedSolver:
    """Shard a hierarchy by rows over a mesh of ranks (by default the
    ranks of the process group, or its first ``n_devices``).  Every rank
    passes the same hierarchy."""
    if mesh is None:
        mesh = make_mesh(n_devices, axis_name)
    return ShardedSolver(ml, mesh, axis_name, halo=halo)


# -- structured hierarchies ------------------------------------------------------

def _whole(op):
    """The whole-vector form of an operator placed over a mesh."""
    if isinstance(op, ShardedDIA):
        return SparseDIA(op.full_diags(), op.offsets, op.shape)
    if isinstance(op, GatheredOp):
        return op.op
    if isinstance(op, ShardedGridRepeatOp):
        return GridRepeatOp(op.layout.full(op.wmap), op.fine_grid, op.block,
                            op.shape)
    if isinstance(op, ShardedGridPoolOp):
        return GridPoolOp(op.in_layout.full(op.wmap), op.fine_grid, op.block,
                          op.shape, conj=op.conj)
    if isinstance(op, ComposedOp):
        return ComposedOp([_whole(o) for o in op.ops], op.shape)
    return op


def _place(op, out_layout, in_layout):
    """``op`` (whole, or placed over the mesh) with its output on
    ``out_layout`` and its input on ``in_layout``."""
    if isinstance(op, ComposedOp):
        by_size = {in_layout.n: in_layout, out_layout.n: out_layout}
        return ComposedOp([_place(o, by_size[o.shape[0]], by_size[o.shape[1]])
                           for o in op.ops], op.shape)
    op = _whole(op)
    if not (out_layout.sharded or in_layout.sharded):
        return op
    if isinstance(op, SparseDIA) and out_layout is in_layout:
        lay = out_layout
        return ShardedDIA(lay.local(op.diags.T).T.contiguous(), op.offsets,
                          lay)
    if isinstance(op, GridRepeatOp) and op.wmap.dim() == 1 \
            and out_layout.sharded:
        return ShardedGridRepeatOp(out_layout.local(op.wmap), op.fine_grid,
                                   op.block, out_layout, in_layout)
    if isinstance(op, GridPoolOp) and op.wmap.dim() == 1 \
            and in_layout.sharded:
        return ShardedGridPoolOp(in_layout.local(op.wmap), op.fine_grid,
                                 op.block, in_layout, out_layout,
                                 conj=op.conj)
    return GatheredOp(op, out_layout, in_layout)


def _same_layout(a, b):
    return a.n == b.n and a.sharded == b.sharded


class StructuredShardedSolver:
    """A structured (DIA and grid-operator) hierarchy placed by rows over a
    mesh of ranks, ready to solve.

    Each level is placed by the JAX package's rule: row-sharded when its
    size divides the ranks and is at least ``min_shard_rows``, else whole
    on every rank; the fine level must divide.  A level is rebuilt from
    the caller's (a hierarchy on one device, the same on every rank, or
    one a setup built over the mesh); the caller's levels are left as they
    are.  On the one-rank mesh of a process without a process group the
    hierarchy is solved as it is."""

    def __init__(self, ml: MultilevelSolver, mesh=None, n_devices=None,
                 axis_name: str = "rows", min_shard_rows: int = 4096):
        if mesh is None:
            mesh = make_mesh(n_devices, axis_name,
                             device=getattr(ml, "device", None))
        self.mesh = _check_mesh(mesh)
        self.axis = mesh.axis_name      # the mesh's one axis, as named
        self.n = ml.levels[0].A.shape[0]
        nd = mesh.size
        if not mesh.distributed:
            self.ml = ml
            return
        if self.n % nd:
            raise ValueError(f"fine-level size {self.n} not divisible by "
                             f"{nd} devices")
        layouts = [Layout(mesh, n, n % nd == 0 and n >= min_shard_rows)
                   for n in (lvl.A.shape[0] for lvl in ml.levels)]
        levels = []
        for i, lvl in enumerate(ml.levels):
            lay = layouts[i]
            old = getattr(lvl, "layout", None)
            new = Level(layout=lay, grid=getattr(lvl, "grid", None))
            new.A = lvl.A if old is not None and _same_layout(old, lay) \
                else _place(lvl.A, lay, lay)
            if getattr(lvl, "P", None) is not None:
                new.P = _place(lvl.P, lay, layouts[i + 1])
                new.R = _place(lvl.R, layouts[i + 1], lay)

            def at_op(AT, lay=lay):
                return _place(AT, lay, lay)

            for which in ("presmoother", "postsmoother"):
                sm = getattr(lvl, which)
                if isinstance(sm, WholeVectorSmoother) or (
                        old is not None and old.sharded):
                    sm = _gather_smoother(sm, old)
                setattr(new, which, _shard_smoother(sm, lay, at_op))
            if hasattr(lvl, "A_csr"):
                new.A_csr = lvl.A_csr
            levels.append(new)
        self.ml = MultilevelSolver(levels,
                                   coarse_solver=ml.coarse_solver_spec,
                                   device=mesh.device)
        for key in ("_op_dtype", "_smoother_config"):
            if hasattr(ml, key):
                setattr(self.ml, key, getattr(ml, key))

    @property
    def levels(self):
        return self.ml.levels

    def placement(self):
        """``[(rows, sharded)]`` of the levels."""
        return [(lvl.A.shape[0], bool(getattr(lvl, "layout", None)
                                      and lvl.layout.sharded))
                for lvl in self.levels]

    def solve(self, b, tol=1e-8, maxiter=100, cycle="V", accel="cg",
              residuals=None):
        """Solve A x = b to relative residual ``tol``: stand-alone cycles
        (``accel=None``) or CG, BiCGStab, GMRES or FGMRES with one cycle
        as preconditioner.  ``residuals`` gets the iteration's residual
        norms (one more than the iterations).  Returns the whole x as a
        tensor on this rank's device."""
        if accel not in _STRUCTURED_ACCELS:
            raise ValueError("StructuredShardedSolver supports accel in "
                             "('cg', 'bicgstab', 'gmres', 'fgmres', None)")
        return self.ml.solve(b, tol=tol, maxiter=maxiter, cycle=cycle,
                             accel=accel, residuals=residuals)

    def __repr__(self):
        return (f"StructuredShardedSolver(devices={self.mesh.size})\n"
                + repr(self.ml))


def _gather_smoother(sm, layout):
    """The whole state of a smoother placed over a mesh."""
    if isinstance(sm, WholeVectorSmoother):
        sm = sm.sm
    if sm is None or layout is None or not layout.sharded:
        return sm

    def whole(v, dim=0):
        if v is None:
            return None
        return layout.full(v.movedim(dim, 0).contiguous()).movedim(0, dim)

    bd = sm.block_dinv
    return replace(sm, dinv=whole(sm.dinv),
                   color_masks=whole(sm.color_masks, 1),
                   block_dinv=None if bd is None else layout.full(bd),
                   dinv_ne=whole(sm.dinv_ne),
                   AT=None if sm.AT is None else _whole(sm.AT))


def shard_structured_solver(ml, mesh=None, n_devices=None,
                            axis_name: str = "rows",
                            min_shard_rows: int = 4096):
    """A :class:`StructuredShardedSolver` of a structured hierarchy."""
    return StructuredShardedSolver(ml, mesh=mesh, n_devices=n_devices,
                                   axis_name=axis_name,
                                   min_shard_rows=min_shard_rows)
