"""Masked products of row-sharded matrices over a mesh of ranks.

The setups over ranks keep every level's matrices row-sharded: each rank
holds its rows of A, S, T, P, A P, R and the coarse A as a padded-ELL
value slab on its device, and every rank holds the whole *pattern* of
each on the host (the host integer stages run on every rank and give the
same patterns everywhere).  The JAX package lets XLA insert the row
exchanges of its sharded products; here they are explicit, and built from
the host patterns alone:

* :class:`RowFetch` -- fetch the rows of a row-sharded slab B that this
  rank's rows of A name.  The send and receive tables come from A's host
  pattern (no communication builds them); each fetch is one
  ``all_to_all_single`` of B's rows (:class:`~.mesh.Exchange`).  The
  fetched rows and this rank's own rows sit in ascending global order,
  either as the whole window ``[first, last]`` of rows A's slab reads
  (where A is banded, its columns then shift by one constant and keep
  their few offsets, so the product stays on the banded kernel) or as the
  rows named alone (where the window would hold many rows nobody reads);
* :func:`masked_spgemm_mesh` -- this rank's rows of the masked ``A B`` on
  ``masked_spgemm_auto`` (K4' or K5' on CUDA): A's slots in their order,
  B's rows as exact copies, so every output entry sums its terms in the
  one-device order;
* :func:`transpose_onto_mesh` -- R = P^T on R's row slab: the P rows its
  pattern names are fetched, then transposed locally;
* :func:`host_values` -- a slab's values read back onto every rank's host
  (an all-gather): the JAX package's one read-back a level.

On the one-rank mesh of a process without a process group every fetch is
the slab itself and the products are the one-device products.
"""

from __future__ import annotations

import collections

import numpy as np
import scipy.sparse as sp
import torch

from ..sparse.ell import SparseELL
from ..sparse.spgemm_device import ell_transpose_onto, masked_spgemm_auto
from ..util.utils import numpy_dtype, torch_dtype
from .halo import host_ell_rows, place_rows
from .mesh import Exchange, Layout

__all__ = ["RowSlab", "RowFetch", "upload_rows", "masked_spgemm_mesh",
           "transpose_onto_mesh", "host_values", "operator", "vector_norm",
           "fetch_for", "routes"]

# the latest products' routes, in call order: its rows, A's width, the
# rows of B on the slab and in all, the fetch's form and rows fetched, the
# kernel launched -- read by the smoke and the tests
routes = collections.deque(maxlen=4096)
# a fetch takes the whole window of rows a slab names while it holds at
# most this many times the rows named
WINDOW_SLACK = 1.5


class RowSlab:
    """This rank's rows of a row-sharded padded-ELL matrix of ``(rows.n,
    n_cols)`` and the whole matrix's host pattern.

    ``ell`` holds the rows ``rows.start .. rows.start + rows.nl`` with
    global columns (shape ``(nl, n_cols)``); ``pattern`` is the sorted
    host CSR of every rank's rows, the same on every rank."""

    def __init__(self, ell: SparseELL, pattern, rows: Layout):
        self.ell, self.pattern, self.rows = ell, pattern, rows

    @property
    def data(self):
        return self.ell.data

    def with_data(self, data) -> "RowSlab":
        """The same rows and pattern with other values."""
        E = self.ell
        return RowSlab(SparseELL(data, E.cols, E.row_nnz, E.shape),
                       self.pattern, self.rows)

    def row_ids(self) -> torch.Tensor:
        """The global index of each row of the slab, on its device."""
        return torch.arange(self.rows.start, self.rows.start + self.rows.nl,
                            dtype=self.ell.cols.dtype,
                            device=self.ell.cols.device)

    def diagonal(self) -> torch.Tensor:
        """This rank's rows of the main diagonal (0 where not stored)."""
        E = self.ell
        return torch.where(E.cols == self.row_ids()[:, None], E.data,
                           0).sum(dim=1)

    def valid_mask(self) -> torch.Tensor:
        return self.ell.valid_mask()


def _pad_pattern(M, shape):
    """The sorted CSR ``M`` with empty rows and columns appended up to
    ``shape``."""
    M = sp.csr_matrix(M)
    if M.shape != tuple(shape):
        M = M.copy()
        M.resize(shape)
    M.sort_indices()
    return M


def upload_rows(M, rows: Layout, n_cols=None, dtype=None,
                values=True) -> RowSlab:
    """This rank's rows of the host matrix ``M`` (padded with empty rows
    and columns to ``(rows.n, n_cols)``) as a :class:`RowSlab` on the
    mesh's device: ``dtype`` values (``values=False``: zeros, for an
    output pattern), as wide as M's longest row.  The slots follow
    ``from_scipy``: a real row's padding slots name the row itself, a
    padding row's name column 0."""
    n_cols = M.shape[1] if n_cols is None else int(n_cols)
    n_real = M.shape[0]
    M = _pad_pattern(M, (rows.n, n_cols))
    lo, hi = rows.start, rows.start + rows.nl
    nnz_all = np.diff(M.indptr)
    w = max(1, int(nnz_all.max()) if nnz_all.size else 0)
    cols, nnz, valid = host_ell_rows(M, lo, hi, w)
    own = np.arange(lo, hi)
    cols = np.where(valid, cols, np.where(own < n_real, own, 0)[:, None])
    dt = numpy_dtype(dtype) if dtype is not None else M.dtype
    dev = rows.mesh.device
    if values:
        data = np.zeros((hi - lo, w), dtype=dt)
        ptr = M.indptr
        data[valid] = M.data[ptr[lo]:ptr[hi]].astype(dt)
        data = torch.as_tensor(data, device=dev)
    else:
        data = torch.zeros((), dtype=torch_dtype(dt),
                           device=dev).expand(hi - lo, w)
    ell = SparseELL(data, torch.as_tensor(cols.astype(np.int32), device=dev),
                    torch.as_tensor(nnz, device=dev), (hi - lo, n_cols))
    pattern = M.copy()
    pattern.data = np.ones_like(pattern.data, dtype=np.float64)
    return RowSlab(ell, pattern, rows)


class RowFetch:
    """The rows of a row-sharded matrix B (pattern ``b_pattern``, on
    ``b_rows``, its slabs ``b_width`` wide) that this rank's rows of a
    matrix A of pattern ``a_pattern`` (on ``a_rows``, ``a_width`` wide)
    name.

    Every rank computes every rank's row set from the host patterns: the
    window from the first to the last row a rank's slab names, with the
    rank's own rows, where it holds at most ``WINDOW_SLACK`` times the
    rows named (this rank's own among them), else just those rows.  The
    fetched rows' columns come from B's host pattern, so a fetch moves B's
    values alone.  ``local_cols`` is A's column slab in the fetched rows'
    coordinates; ``form`` names the choice ("window", "rows", or "local"
    on one rank)."""

    def __init__(self, a_pattern, a_rows: Layout, a_width: int, b_pattern,
                 b_rows: Layout, b_width: int):
        mesh = a_rows.mesh
        nd, r = mesh.size, mesh.rank
        nb, nlb = b_rows.n, b_rows.nl
        if a_pattern.shape[1] != nb or b_pattern.shape[0] != nb:
            raise ValueError(f"A's pattern {a_pattern.shape} does not name "
                             f"the rows of B's {b_pattern.shape}")
        self.n_own = nlb
        if not mesh.distributed or nd == 1:
            self.exchange, self.form, self.n_left = None, "local", 0
            self.n_ext, self.local_cols = nb, None
            return
        # which rows of B every rank reads: one flag a (rank, row)
        counts = np.diff(a_pattern.indptr)
        rank_of = np.repeat(np.arange(a_pattern.shape[0]) // a_rows.nl,
                            counts)
        flags = np.zeros((nd, nb), dtype=bool)
        flags[rank_of, a_pattern.indices] = True
        for p in range(nd):
            f = flags[p]
            f[p * nlb:(p + 1) * nlb] = True
            named = np.flatnonzero(f)
            first, last = int(named[0]), int(named[-1])
            window = last + 1 - first <= WINDOW_SLACK * named.size
            if window:
                f[first:last + 1] = True
            if p == r:
                self.form = "window" if window else "rows"
        # rank r sends rank p the rows of its slab in p's set, ascending
        send, send_counts, recv_counts = [], [], []
        for p in range(nd):
            mine = np.flatnonzero(flags[p, r * nlb:(r + 1) * nlb]) \
                if p != r else np.zeros(0, np.int64)
            send.append(mine)
            send_counts.append(mine.size)
            recv_counts.append(0 if p == r else
                               int(flags[r, p * nlb:(p + 1) * nlb].sum()))
        self.exchange = Exchange(
            mesh, torch.as_tensor(np.concatenate(send), device=mesh.device),
            send_counts, recv_counts)
        ext = np.flatnonzero(flags[r])         # fetched and own rows
        self.n_left = int(sum(recv_counts[:r]))
        self.n_ext = ext.size
        lo, hi = a_rows.start, a_rows.start + a_rows.nl
        cols, _, valid = host_ell_rows(a_pattern, lo, hi, a_width)
        dev = mesh.device
        self.local_cols = torch.as_tensor(
            np.where(valid, np.searchsorted(ext, cols), 0).astype(np.int32),
            device=dev)
        # the fetched rows' columns and counts, from B's host pattern
        Bx = b_pattern[ext]
        bcols, bnnz, bvalid = host_ell_rows(Bx, 0, ext.size, b_width)
        bcols = np.where(bvalid, bcols,
                         np.where(ext < b_pattern.shape[0], ext, 0)[:, None])
        self.b_cols = torch.as_tensor(bcols.astype(np.int32), device=dev)
        self.b_nnz = torch.as_tensor(bnnz, device=dev)

    def values(self, data: torch.Tensor) -> torch.Tensor:
        """B's value slab (this rank's rows) extended by the rows this
        rank reads, in ascending global order (one exchange)."""
        if self.exchange is None:
            return data
        got = self.exchange(data)
        k = self.n_left
        return torch.cat([got[:k], data, got[k:]])

    def operands(self, A: "RowSlab", B: "RowSlab"):
        """``(A_local, B_ext)``: A's slab on the fetched rows'
        coordinates and B's fetched rows, ready for a one-device
        product."""
        if self.exchange is None:
            return A.ell, B.ell
        Ae = A.ell
        A_loc = SparseELL(Ae.data, self.local_cols, Ae.row_nnz,
                          (Ae.shape[0], self.n_ext))
        B_ext = SparseELL(self.values(B.data), self.b_cols, self.b_nnz,
                          (self.n_ext, B.ell.shape[1]))
        return A_loc, B_ext


def fetch_for(A: RowSlab, B: RowSlab) -> RowFetch:
    """The :class:`RowFetch` of B's rows that A's slab reads."""
    return RowFetch(A.pattern, A.rows, A.ell.width, B.pattern, B.rows,
                    B.ell.width)


def masked_spgemm_mesh(A: RowSlab, B: RowSlab, pattern: RowSlab,
                       fetch: RowFetch = None, plan=None,
                       product=None) -> RowSlab:
    """This rank's rows of ``(A @ B)`` restricted to ``pattern`` (A's
    rows; B's columns): B's rows that A's slab names are fetched
    (``fetch``, built here unless given), then the one-device product
    runs on the rank's slab: ``product`` (by default
    ``masked_spgemm_auto``: K4' or K5' on CUDA, ``plan`` its route for
    products that repeat).  The route taken joins ``routes``."""
    from ..sparse import spgemm_kernel

    if fetch is None:
        fetch = fetch_for(A, B)
    if product is None:
        product = masked_spgemm_auto
    A_loc, B_ext = fetch.operands(A, B)
    before = dict(spgemm_kernel.launches)
    out = product(A_loc, B_ext, pattern.ell) if plan is None \
        else product(A_loc, B_ext, pattern.ell, plan=plan)
    kernel = next((k for k, v in spgemm_kernel.launches.items()
                   if v != before.get(k)), "plain")
    routes.append(dict(rows=A_loc.shape[0], w_a=A_loc.width,
                       b_rows=B_ext.shape[0], b_total=B.rows.n,
                       fetch=fetch.form,
                       fetched=fetch.n_ext - fetch.n_own
                       if fetch.exchange is not None else 0,
                       kernel=kernel))
    return pattern.with_data(out.data)


def transpose_onto_mesh(P: RowSlab, patR: RowSlab) -> RowSlab:
    """R = P^T on R's row slab (``patR``: R's pattern, row-sharded on
    P's column layout): the P rows R's slab names are fetched, then each
    slot (j, i) of R takes P[i, j] by a gather and a compare
    (``ell_transpose_onto`` on the rank's slab)."""
    fetch = fetch_for(patR, P)
    R_loc, P_ext = fetch.operands(patR, P)
    out = ell_transpose_onto(P_ext, R_loc, row0=patR.rows.start)
    return patR.with_data(out.data)


def host_values(slab: RowSlab):
    """The whole matrix of ``slab`` on every rank's host, as a CSR with
    the host pattern's structure (its stored zeros kept): the rank slabs'
    values are gathered over the ranks (one collective)."""
    mesh = slab.rows.mesh
    vals = mesh.all_gather(slab.data.contiguous(), host=True).numpy()
    M = slab.pattern
    w = vals.shape[1]
    valid = np.arange(w)[None, :] < np.diff(M.indptr)[:, None]
    return sp.csr_matrix((vals[valid], M.indices.copy(), M.indptr.copy()),
                         shape=M.shape)


def operator(slab: RowSlab, cols: Layout):
    """The operator of a slab for matvecs: on the one-rank mesh of a
    process without a process group the slab's own SparseELL (the whole
    matrix), else a :class:`~.halo.HaloELL` (or the full-gather
    :class:`~.halo.GatherELL` where the exchange does not pay) whose
    columns index ``cols``'s row-sharded vectors."""
    if not slab.rows.mesh.distributed:
        return slab.ell
    return place_rows(slab.pattern, slab.data, slab.rows, cols)


def vector_norm(v: torch.Tensor, rows: Layout) -> torch.Tensor:
    """The 2-norm of the whole vector whose rows ``v`` are: on one rank
    ``torch.linalg.vector_norm``, over several the root of the summed
    squares."""
    if rows.mesh.size == 1:
        return torch.linalg.vector_norm(v)
    return rows.norm(v)
