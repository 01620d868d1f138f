"""Structured linear operators for the solve phase.

Grid-block aggregation keeps every level grid-structured, so the transfer
operators need no gathers:

* tentative prolongation  T  = per-aggregate broadcast -> ``GridRepeatOp``
  (reshape + repeat_interleave + crop + weight)
* tentative restriction  T^T = per-aggregate reduction -> ``GridPoolOp``
  (weight + pad + pooled sum)
* smoothed P = S T with S = I - omega D^{-1} A -> ``ComposedOp`` of a
  :class:`SparseDIA` with the grid operator.

A transfer pair whose coarse dofs each sit at a distinct fine dof (an
aggregate's root, a C-point) has a fine-embedded form: ``CptProlongOp``
scatters the coarse vector to those positions and applies an (n x n) DIA
operator, ``CptRestrictOp`` applies one and gathers them.

Each operator exposes ``matvec``, ``shape``, ``dtype`` and ``astype``.
Port of ``pyamg_tpu/sparse/linop.py``.

Over a mesh of ranks (``parallel.mesh.Layout``: a level's vectors
row-sharded or whole on every rank), :class:`ShardedGridRepeatOp` and
:class:`ShardedGridPoolOp` are the tentative transfers of a row-sharded
fine level, whose shards do not align with the blocks: the repeat reads
the whole coarse vector, the pool sums this rank's part of every coarse
node and adds the parts over the ranks.  :class:`GatheredOp` applies any
operator to whole vectors on every rank.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..util.utils import torch_dtype

__all__ = ["ComposedOp", "GridRepeatOp", "GridPoolOp", "DenseOp",
           "CptProlongOp", "CptRestrictOp", "ShardedGridRepeatOp",
           "ShardedGridPoolOp", "GatheredOp"]


class ComposedOp:
    """``matvec = ops[0] @ (ops[1] @ (... @ x))``: right-to-left."""

    def __init__(self, ops, shape):
        self.ops = tuple(ops)
        self.shape: Tuple[int, int] = tuple(shape)

    @property
    def dtype(self):
        return self.ops[0].dtype

    def matvec(self, x):
        for op in reversed(self.ops):
            x = op.matvec(x)
        return x

    def astype(self, dtype):
        return ComposedOp([op.astype(dtype) for op in self.ops], self.shape)

    def to_scipy(self):
        mats = [op.to_scipy() for op in self.ops]
        return functools.reduce(lambda a, b: (a @ b).tocsr(), mats)


def _coarse_grid(fine_grid, block):
    return tuple(-(-g // b) for g, b in zip(fine_grid, block))


def _pool_pads(fine_grid, cg, block):
    """``F.pad`` widths (last axis first) that round each grid axis up to a
    whole number of blocks."""
    pads = []
    for d in reversed(range(len(cg))):
        pads += [0, cg[d] * block[d] - fine_grid[d]]
    return tuple(pads)


class GridRepeatOp:
    """Tentative prolongation on a d-dim grid with block aggregation.

    ``matvec(xc)``: reshape xc to the coarse grid, repeat each axis by its
    block size, crop to the fine grid, flatten, and scale by the per-fine-dof
    weight map (the normalized near-nullspace values that fit_candidates
    produces).

    A 2-D ``wmap`` (n_fine_dofs, K) is the multi-candidate form: each coarse
    grid node carries K values (node-major) and each fine dof value is the
    K-term dot product with its weight row.  ``node_dofs`` (q) is the number
    of fine dofs per grid node (node-major)."""

    def __init__(self, wmap, fine_grid, block, shape, node_dofs=1):
        self.wmap = wmap
        self.fine_grid = tuple(int(g) for g in fine_grid)
        self.block = tuple(int(b) for b in block)
        self.shape: Tuple[int, int] = tuple(shape)
        self.node_dofs = int(node_dofs)

    @property
    def dtype(self):
        return self.wmap.dtype

    @property
    def coarse_grid(self):
        return _coarse_grid(self.fine_grid, self.block)

    def astype(self, dtype):
        return GridRepeatOp(self.wmap.to(torch_dtype(dtype)), self.fine_grid,
                            self.block, self.shape, self.node_dofs)

    def matvec(self, xc):
        cg = self.coarse_grid
        crop = tuple(slice(0, g) for g in self.fine_grid)
        if self.wmap.dim() == 1:
            y = xc.reshape(cg)
            for ax, b in enumerate(self.block):
                if b > 1:
                    y = torch.repeat_interleave(y, b, dim=ax)
            return self.wmap * y[crop].reshape(-1)
        K = self.wmap.shape[1]
        q = self.node_dofs
        y = xc.reshape(cg + (K,))
        for ax, b in enumerate(self.block):
            if b > 1:
                y = torch.repeat_interleave(y, b, dim=ax)
        y = y[crop].reshape(-1, K)                 # (n_nodes, K)
        if q == 1:
            return (self.wmap * y).sum(dim=1)
        w = self.wmap.reshape(-1, q, K)            # (n_nodes, q, K)
        return torch.einsum("nqk,nk->nq", w, y).reshape(-1)

    def to_scipy(self):
        import scipy.sparse as sp

        n_f, _n_c = self.shape
        q = self.node_dofs
        cg = self.coarse_grid
        coords = np.unravel_index(np.arange(n_f // q), self.fine_grid)
        cidx = np.ravel_multi_index(
            tuple(c // b for c, b in zip(coords, self.block)), cg)
        w = self.wmap.cpu().numpy()
        if w.ndim == 1:
            return sp.coo_matrix(
                (w, (np.arange(n_f), cidx)), shape=self.shape).tocsr()
        K = w.shape[1]
        cdof = np.repeat(cidx, q)
        rows = np.repeat(np.arange(n_f), K)
        cols = (cdof[:, None] * K + np.arange(K)[None, :]).ravel()
        return sp.coo_matrix(
            (w.ravel(), (rows, cols)), shape=self.shape).tocsr()


class GridPoolOp:
    """Tentative restriction T^T (``conj=False``) or T^H (``conj=True``):
    weight, then sum-pool over each block.  The multi-candidate and
    node-blocked forms mirror :class:`GridRepeatOp`."""

    def __init__(self, wmap, fine_grid, block, shape, node_dofs=1,
                 conj=True):
        self.wmap = wmap
        self.fine_grid = tuple(int(g) for g in fine_grid)
        self.block = tuple(int(b) for b in block)
        self.shape: Tuple[int, int] = tuple(shape)     # (n_coarse, n_fine)
        self.node_dofs = int(node_dofs)
        self.conj = bool(conj)

    @property
    def dtype(self):
        return self.wmap.dtype

    @property
    def coarse_grid(self):
        return _coarse_grid(self.fine_grid, self.block)

    def astype(self, dtype):
        return GridPoolOp(self.wmap.to(torch_dtype(dtype)), self.fine_grid,
                          self.block, self.shape, self.node_dofs, self.conj)

    def _pool(self, w, cg):
        for ax, b in enumerate(self.block):
            if b > 1:
                w = w.reshape(w.shape[:ax] + (cg[ax], b)
                              + w.shape[ax + 1:]).sum(dim=ax + 1)
        return w.reshape(-1)

    def matvec(self, xf):
        cg = self.coarse_grid
        wmap = torch.conj(self.wmap) if self.conj else self.wmap
        pads = _pool_pads(self.fine_grid, cg, self.block)
        if wmap.dim() == 1:
            w = (wmap * xf).reshape(self.fine_grid)
            return self._pool(F.pad(w, pads), cg)
        K = wmap.shape[1]
        q = self.node_dofs
        w = wmap * xf[:, None]                   # (n_dofs, K)
        if q > 1:
            w = w.reshape(-1, q, K).sum(dim=1)   # (n_nodes, K)
        w = w.reshape(self.fine_grid + (K,))
        return self._pool(F.pad(w, (0, 0) + pads), cg)

    def to_scipy(self):
        T = GridRepeatOp(self.wmap, self.fine_grid, self.block,
                         (self.shape[1], self.shape[0]),
                         node_dofs=self.node_dofs).to_scipy()
        return (T.conj() if self.conj else T).T.tocsr()


class DenseOp:
    """Small dense operator (a coarse level's A when no DIA form fits)."""

    def __init__(self, mat, shape):
        self.mat = mat
        self.shape: Tuple[int, int] = tuple(shape)

    @property
    def dtype(self):
        return self.mat.dtype

    def astype(self, dtype):
        return DenseOp(self.mat.to(torch_dtype(dtype)), self.shape)

    def matvec(self, x):
        return self.mat @ x

    @property
    def nnz(self) -> int:
        return int(torch.count_nonzero(self.mat))

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix(self.mat.cpu().numpy())


class CptProlongOp:
    """Prolongation as a fine-embedded DIA operator.

    P (n_fine x n_coarse) has irregular coarse column ids, but coarse dof j
    sits at the fine dof ``cpts[j]``: with P's columns re-indexed to those
    positions it is an (n x n) operator whose offsets are the fine-grid
    distances to nearby roots, banded where the level itself is.  Applying
    P scatters the coarse vector onto the positions and runs one DIA
    matvec."""

    def __init__(self, dia, cpts, shape):
        self.dia = dia                      # SparseDIA (n_fine, n_fine)
        self.cpts = cpts                    # (n_coarse,) int64 positions
        self.shape: Tuple[int, int] = tuple(shape)

    @property
    def dtype(self):
        return self.dia.dtype

    def astype(self, dtype):
        return CptProlongOp(self.dia.astype(dtype), self.cpts, self.shape)

    def matvec(self, xc):
        xf = torch.zeros(self.shape[0], dtype=xc.dtype, device=xc.device)
        xf[self.cpts] = xc
        return self.dia.matvec(xf)

    def to_scipy(self):
        Pf = self.dia.to_scipy().tocsc()
        return Pf[:, self.cpts.cpu().numpy()].tocsr()


class CptRestrictOp:
    """The restriction of a :class:`CptProlongOp` pair: one DIA matvec,
    then a gather of the coarse dofs' positions."""

    def __init__(self, dia, cpts, shape):
        self.dia = dia                      # SparseDIA (n_fine, n_fine)
        self.cpts = cpts                    # (n_coarse,) int64 positions
        self.shape: Tuple[int, int] = tuple(shape)

    @property
    def dtype(self):
        return self.dia.dtype

    def astype(self, dtype):
        return CptRestrictOp(self.dia.astype(dtype), self.cpts, self.shape)

    def matvec(self, r):
        return self.dia.matvec(r)[self.cpts]

    def to_scipy(self):
        RfT = self.dia.to_scipy().tocsr()
        return RfT[self.cpts.cpu().numpy(), :].tocsr()


def _coarse_index(fine_grid, block, start, count):
    """The coarse node of fine nodes ``start .. start + count`` (row-major
    grids), as an int64 numpy array."""
    coords = np.unravel_index(np.arange(start, start + count), fine_grid)
    return np.ravel_multi_index(
        tuple(c // b for c, b in zip(coords, block)),
        _coarse_grid(fine_grid, block)).astype(np.int64)


class ShardedGridRepeatOp:
    """The one-candidate :class:`GridRepeatOp` onto a row-sharded fine
    level: ``wmap`` holds this rank's fine rows; the coarse vector is
    gathered whole (when its level is sharded) and read at each row's
    coarse node."""

    def __init__(self, wmap, fine_grid, block, fine_layout, coarse_layout,
                 cidx=None):
        self.wmap = wmap
        self.fine_grid = tuple(int(g) for g in fine_grid)
        self.block = tuple(int(b) for b in block)
        self.layout, self.in_layout = fine_layout, coarse_layout
        self.shape = (fine_layout.n, coarse_layout.n)
        if cidx is None:
            cidx = torch.as_tensor(_coarse_index(
                self.fine_grid, self.block, fine_layout.start,
                fine_layout.nl), device=wmap.device)
        self.cidx = cidx

    @property
    def dtype(self):
        return self.wmap.dtype

    def with_wmap(self, wmap):
        """The same transfer with weights ``wmap`` (the index table is
        kept)."""
        return ShardedGridRepeatOp(wmap, self.fine_grid, self.block,
                                   self.layout, self.in_layout, self.cidx)

    def astype(self, dtype):
        return self.with_wmap(self.wmap.to(torch_dtype(dtype)))

    def matvec(self, xc):
        return self.wmap * self.in_layout.full(xc)[self.cidx]


class ShardedGridPoolOp:
    """The one-candidate :class:`GridPoolOp` from a row-sharded fine
    level: this rank sums the weighted entries of its rows into every
    coarse node they touch (a gather table, so the sums have a fixed
    order), the parts are added over the ranks, and this rank keeps its
    coarse rows."""

    def __init__(self, wmap, fine_grid, block, fine_layout, coarse_layout,
                 conj=True, tables=None):
        self.wmap = wmap
        self.fine_grid = tuple(int(g) for g in fine_grid)
        self.block = tuple(int(b) for b in block)
        self.in_layout, self.layout = fine_layout, coarse_layout
        self.shape = (coarse_layout.n, fine_layout.n)
        self.conj = bool(conj)
        if tables is None:
            nl = fine_layout.nl
            cidx = _coarse_index(self.fine_grid, self.block,
                                 fine_layout.start, nl)
            order = np.argsort(cidx, kind="stable")
            nodes, first, counts = np.unique(cidx[order], return_index=True,
                                             return_counts=True)
            table = np.full((len(nodes), int(counts.max())), nl,
                            dtype=np.int64)
            group = np.repeat(np.arange(len(nodes)), counts)
            table[group, np.arange(nl) - first[group]] = order
            tables = (torch.as_tensor(nodes, device=wmap.device),
                      torch.as_tensor(table, device=wmap.device))
        self.tables = tables

    @property
    def dtype(self):
        return self.wmap.dtype

    def with_wmap(self, wmap):
        """The same transfer with weights ``wmap`` (the gather table is
        kept)."""
        return ShardedGridPoolOp(wmap, self.fine_grid, self.block,
                                 self.in_layout, self.layout, self.conj,
                                 self.tables)

    def astype(self, dtype):
        return self.with_wmap(self.wmap.to(torch_dtype(dtype)))

    def matvec(self, xf):
        wmap = torch.conj(self.wmap) if self.conj else self.wmap
        w = wmap * xf
        w = torch.cat([w, w.new_zeros(1)])
        nodes, table = self.tables
        part = w.new_zeros(self.shape[0])
        part[nodes] = w[table].sum(dim=1)
        return self.layout.local(self.in_layout.mesh.all_reduce(part))


class GatheredOp:
    """Any operator over a mesh, applied to whole vectors on every rank:
    x is gathered (where ``in_layout`` is sharded), ``op`` applied, and
    this rank's rows of the result kept (where ``out_layout`` is)."""

    def __init__(self, op, out_layout, in_layout):
        self.op = op
        self.layout, self.in_layout = out_layout, in_layout
        self.shape: Tuple[int, int] = tuple(op.shape)

    @property
    def dtype(self):
        return self.op.dtype

    @property
    def nnz(self) -> int:
        return self.op.nnz

    def astype(self, dtype):
        return GatheredOp(self.op.astype(dtype), self.layout, self.in_layout)

    def matvec(self, x):
        return self.layout.local(self.op.matvec(self.in_layout.full(x)))

    def to_scipy(self):
        return self.op.to_scipy()
