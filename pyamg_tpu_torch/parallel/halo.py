"""Row-sharded padded-ELL operators with a halo exchange.

Port of ``pyamg_tpu/parallel/halo.py``.  Each rank holds its row slab of a
padded ELL operator whose columns index a vector row-sharded over the same
ranks.  The columns are remapped on the host into
``concat([x_local, halo])`` coordinates, where ``halo`` holds exactly the
out-of-slab entries this rank's rows read, received from their owners in
one ``all_to_all_single``: each rank sends each other rank exactly the
entries that rank reads (the JAX package packs one width for every rank
and gathers every pack everywhere).  ``matvec`` reads exactly the values
the full-vector gather reads.

``rmatvec`` (``A^H y``) scatter-adds into the local and halo coordinates
and sends the halo sums back to their owners, so the normal-equation
Krylov methods (``cgnr``, ``cgne``) work on a sharded hierarchy.

:class:`GatherELL` is the full-gather form: the rank's rows with global
columns, multiplied after an all-gather of x.
"""

from __future__ import annotations

import numpy as np
import torch

from ..sparse.ell import ell_matvec
from ..util.utils import torch_dtype
from .mesh import Exchange, Layout

__all__ = ["HaloELL", "GatherELL", "build_halo_ell", "gather_ell",
           "place_rows", "host_ell_rows"]


def _scipy_rows(data, gcols, nnz, row0, shape):
    """A CSR matrix of ``shape`` holding rows ``row0 ..`` from ELL slabs
    with global columns."""
    import scipy.sparse as sp

    n, w = data.shape
    valid = np.arange(w)[None, :] < nnz[:, None]
    rows = np.broadcast_to((row0 + np.arange(n))[:, None], (n, w))
    return sp.coo_matrix((data[valid], (rows[valid], gcols[valid])),
                         shape=shape).tocsr()


class _RowSlabELL:
    """What both sharded ELL forms share: the rank's ``(nl, w)`` slab,
    the layouts of the rows and of the columns' vector, the global
    shape."""

    def __init__(self, data, cols, row_nnz, shape, rows, cols_layout):
        self.data, self.cols, self.row_nnz = data, cols, row_nnz
        self.shape = (int(shape[0]), int(shape[1]))
        self.layout = rows                 # the output's layout
        self.in_layout = cols_layout       # x's layout
        self.mesh = rows.mesh

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def nnz(self) -> int:
        return self._nnz

    def to_scipy(self):
        """The whole operator as a host CSR matrix (a collective: every
        rank of the mesh calls it and gets the same matrix)."""
        mine = _scipy_rows(self.data.cpu().numpy(), self.global_cols(),
                           self.row_nnz.cpu().numpy(), self.layout.start,
                           self.shape)
        return sum(self.mesh.all_gather_object(mine)).tocsr()


class HaloELL(_RowSlabELL):
    """Row-sharded padded-ELL operator with a per-pair halo exchange.

    ``cols`` index ``concat([x_local, halo])``; ``exchange`` receives the
    halo (``recv_cols``: the global column of each halo entry, for
    :meth:`global_cols`)."""

    def __init__(self, data, cols, row_nnz, shape, rows, cols_layout,
                 exchange, recv_cols, nnz):
        super().__init__(data, cols, row_nnz, shape, rows, cols_layout)
        self.exchange = exchange
        self.recv_cols = recv_cols
        self._nnz = int(nnz)

    @property
    def halo_width(self) -> int:
        """Entries this rank receives a matvec."""
        return self.exchange.n_recv

    def astype(self, dtype) -> "HaloELL":
        return HaloELL(self.data.to(torch_dtype(dtype)), self.cols,
                       self.row_nnz, self.shape, self.layout,
                       self.in_layout, self.exchange, self.recv_cols,
                       self._nnz)

    def global_cols(self) -> np.ndarray:
        """This rank's rows' original global column indices (host)."""
        cols = self.cols.cpu().numpy().astype(np.int64)
        ml = self.in_layout.nl
        local = cols < ml
        halo = self.recv_cols[np.clip(cols - ml, 0,
                                      max(len(self.recv_cols) - 1, 0))] \
            if len(self.recv_cols) else np.zeros_like(cols)
        return np.where(local, cols + self.in_layout.start, halo)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``A x`` from this rank's rows of x."""
        xx = torch.cat([x, self.exchange(x)])
        return ell_matvec(self.data, self.cols, xx)

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        XX = torch.cat([X, self.exchange(X)])
        return torch.einsum("nw,nwk->nk", self.data, XX[self.cols])

    def rmatvec(self, y: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``A^H y`` from this rank's rows of y."""
        ml = self.in_layout.nl
        vals = (self.data.conj() * y[:, None]).reshape(-1)
        out = vals.new_zeros(ml + self.exchange.n_recv)
        out.index_add_(0, self.cols.reshape(-1), vals)
        return out[:ml] + self.exchange.reverse(out[ml:], ml)

    def __repr__(self):
        return (f"HaloELL(shape={self.shape}, width={self.width}, "
                f"halo={self.halo_width}, dtype={self.dtype})")


class GatherELL(_RowSlabELL):
    """Row-sharded padded-ELL operator with global columns: the matvec
    all-gathers x (the JAX package's gather-ELL on a mesh)."""

    def __init__(self, data, cols, row_nnz, shape, rows, cols_layout, nnz):
        super().__init__(data, cols, row_nnz, shape, rows, cols_layout)
        self._nnz = int(nnz)

    def astype(self, dtype) -> "GatherELL":
        return GatherELL(self.data.to(torch_dtype(dtype)), self.cols,
                         self.row_nnz, self.shape, self.layout,
                         self.in_layout, self._nnz)

    def global_cols(self) -> np.ndarray:
        return self.cols.cpu().numpy().astype(np.int64)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return ell_matvec(self.data, self.cols, self.in_layout.full(x))

    def rmatvec(self, y: torch.Tensor) -> torch.Tensor:
        vals = (self.data.conj() * y[:, None]).reshape(-1)
        out = vals.new_zeros(self.in_layout.n)
        out.index_add_(0, self.cols.reshape(-1), vals)
        return self.in_layout.local(self.mesh.all_reduce(out))

    def __repr__(self):
        return (f"GatherELL(shape={self.shape}, width={self.width}, "
                f"dtype={self.dtype})")


def _host_slab(E):
    """Host arrays ``(data, cols, nnz, valid)`` of a padded SparseELL,
    with padding slots at column 0 (the JAX package's padding)."""
    data = E.data.cpu().numpy()
    cols = E.cols.cpu().numpy().astype(np.int64)
    nnz = E.row_nnz.cpu().numpy()
    valid = np.arange(cols.shape[1])[None, :] < nnz[:, None]
    return data, np.where(valid, cols, 0), nnz, valid


def _layouts(E, mesh, n_cols):
    """The row-sharded layouts of E's rows and of x (``n_cols`` entries,
    by default E's columns); raises unless both divide the ranks."""
    n, m = E.shape[0], E.shape[1] if n_cols is None else int(n_cols)
    if n % mesh.size or m % mesh.size:
        raise ValueError(f"operator {E.shape} not padded for {mesh.size} "
                         "ranks")
    return Layout(mesh, n, True), Layout(mesh, m, True)


def _exchange_tables(rows_e, cols_e, mesh, n, m, max_halo_frac, force):
    """The per-pair exchange of a row-sharded operator of ``(n, m)`` whose
    stored entries are ``(rows_e, cols_e)`` (every rank's; host arrays):
    ``(exchange, recv_cols)``, or None where the JAX package's rule
    declines it (see :func:`build_halo_ell`)."""
    nd, r = mesh.size, mesh.rank
    nl, ml = n // nd, m // nd
    rs = rows_e // nl
    owner = cols_e // ml
    outside = owner != rs

    # need[p][q]: the sorted columns of rank q's slab that rank p reads
    keys = (rs * nd + owner)[outside]
    uniq = np.unique(keys * m + cols_e[outside])
    pair, col = uniq // m, uniq % m
    reader, own = pair // nd, pair % nd
    H = max(1, max(len(np.unique(col[own == q])) for q in range(nd)))
    if not force and (nd - 1) * H >= max_halo_frac * (m - ml):
        return None

    recv_cols = col[reader == r]               # ascending: by owner, column
    recv_counts = [int(((reader == r) & (own == q)).sum()) for q in range(nd)]
    mine = own == r
    send = col[mine] - r * ml                  # ordered by reader, column
    send_counts = [int((mine & (reader == p)).sum()) for p in range(nd)]
    exchange = Exchange(mesh, torch.as_tensor(send, device=mesh.device),
                        send_counts, recv_counts)
    return exchange, recv_cols


def _remap(c, valid, recv_cols, r, ml):
    """This rank's column slab ``c`` (global columns) in
    ``concat([x_local, halo])`` coordinates; padding slots at 0."""
    remap = c - r * ml
    out = valid & (c // ml != r)
    if out.any():
        remap[out] = ml + np.searchsorted(recv_cols, c[out])
    remap[~valid] = 0
    return remap


def build_halo_ell(E, mesh, axis=None, n_cols=None,
                   max_halo_frac: float = 0.9, force: bool = False):
    """A :class:`HaloELL` of this rank's rows of the padded SparseELL
    ``E`` (the whole operator, on every rank of ``mesh``), or None where
    the exchange would not pay.

    E's rows and ``n_cols`` (x's length, by default E's columns) must be
    multiples of the ranks; ``axis`` names the mesh's one axis.  The
    decline rule is the JAX package's: with H the largest number of one
    rank's entries that the other ranks read, the exchange is declined
    when ``(nd - 1) * H >= max_halo_frac * (m - m / nd)``, unless
    ``force``."""
    rows, cols_layout = _layouts(E, mesh, n_cols)
    r = mesh.rank
    n, m = rows.n, cols_layout.n
    data, cols, nnz, valid = _host_slab(E)
    rows_e, _ = np.nonzero(valid)
    tables = _exchange_tables(rows_e, cols[valid], mesh, n, m,
                              max_halo_frac, force)
    if tables is None:
        return None
    exchange, recv_cols = tables
    lo, hi = rows.start, rows.start + rows.nl
    remap = _remap(cols[lo:hi], valid[lo:hi], recv_cols, r, cols_layout.nl)
    dev = mesh.device
    return HaloELL(torch.as_tensor(data[lo:hi], device=dev),
                   torch.as_tensor(remap, device=dev),
                   torch.as_tensor(nnz[lo:hi], device=dev), (n, m), rows,
                   cols_layout, exchange, recv_cols, int(nnz.sum()))


def gather_ell(E, mesh, n_cols=None) -> GatherELL:
    """The full-gather form of this rank's rows of the padded SparseELL
    ``E`` (the whole operator, on every rank of ``mesh``)."""
    rows, cols_layout = _layouts(E, mesh, n_cols)
    data, cols, nnz, _ = _host_slab(E)
    lo, hi = rows.start, rows.start + rows.nl
    dev = mesh.device
    return GatherELL(torch.as_tensor(data[lo:hi], device=dev),
                     torch.as_tensor(cols[lo:hi], device=dev),
                     torch.as_tensor(nnz[lo:hi], device=dev),
                     (rows.n, cols_layout.n), rows, cols_layout,
                     int(nnz.sum()))


def host_ell_rows(M, lo, hi, width):
    """Rows ``lo .. hi`` of the sorted host CSR ``M`` as ELL slabs
    ``(cols, nnz, valid)``: ``width`` wide, global columns, padding slots
    at column 0."""
    ptr = M.indptr[lo:hi + 1]
    nnz = np.diff(ptr).astype(np.int32)
    rows = np.repeat(np.arange(hi - lo), nnz)
    slot = np.arange(ptr[-1] - ptr[0]) - np.repeat(ptr[:-1] - ptr[0], nnz)
    cols = np.zeros((hi - lo, width), dtype=np.int64)
    cols[rows, slot] = M.indices[ptr[0]:ptr[-1]]
    valid = np.arange(width)[None, :] < nnz[:, None]
    return cols, nnz, valid


def place_rows(pattern, data, rows: Layout, cols_layout: Layout):
    """This rank's rows of a row-sharded operator from its whole host
    pattern (``pattern``: a sorted CSR of ``(rows.n, cols_layout.n)``,
    the same on every rank) and this rank's value slab ``data`` (its rows
    in the pattern's slot order, on this rank's device): a
    :class:`HaloELL` where the exchange pays (the rule of
    :func:`build_halo_ell`), else the full-gather :class:`GatherELL`.
    Only the exchange tables are built: every column table comes from the
    host pattern, and no value moves."""
    mesh = rows.mesh
    n, m = rows.n, cols_layout.n
    if pattern.shape != (n, m):
        raise ValueError(f"pattern {pattern.shape} is not the operator's "
                         f"({n}, {m})")
    lo, hi = rows.start, rows.start + rows.nl
    cols, nnz, valid = host_ell_rows(pattern, lo, hi, data.shape[1])
    dev = data.device
    rows_e = np.repeat(np.arange(n), np.diff(pattern.indptr))
    tables = _exchange_tables(rows_e, pattern.indices.astype(np.int64), mesh,
                              n, m, 0.9, False)
    nnz_d = torch.as_tensor(nnz, device=dev)
    if tables is None:
        return GatherELL(data, torch.as_tensor(cols, device=dev), nnz_d,
                         (n, m), rows, cols_layout, pattern.nnz)
    exchange, recv_cols = tables
    remap = _remap(cols, valid, recv_cols, mesh.rank, cols_layout.nl)
    return HaloELL(data, torch.as_tensor(remap, device=dev), nnz_d, (n, m),
                   rows, cols_layout, exchange, recv_cols, pattern.nnz)
