"""Construct sparse matrices from local stencils on regular grids.

Port of ``pyamg_tpu/gallery/stencil.py`` (numpy, unchanged): a direct CSR
assembly, one batch of entries per stencil offset, with out-of-grid
neighbors dropped (homogeneous Dirichlet truncation).  The matrix carries
its grid as ``A.grid``, which selects the structured-grid setup path.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["stencil_grid"]


def stencil_grid(S, grid, dtype=None, format=None):
    """Sparse matrix for a local (2k+1)^d stencil applied on a regular grid.

    Parameters
    ----------
    S : ndarray with odd extents; ``S[k, ..., k]`` is the diagonal entry.
    grid : tuple of grid dimensions, e.g. ``(100, 100)``.
    format : scipy sparse format string ('csr' default).

    Returns
    -------
    scipy sparse matrix of shape (prod(grid), prod(grid)).

    Examples
    --------
    >>> stencil_grid([-1.0, 2.0, -1.0], (4,)).toarray()
    array([[ 2., -1.,  0.,  0.],
           [-1.,  2., -1.,  0.],
           [ 0., -1.,  2., -1.],
           [ 0.,  0., -1.,  2.]])
    """
    S = np.asarray(S, dtype=dtype)
    grid = tuple(int(g) for g in grid)
    if S.ndim != len(grid):
        raise ValueError("stencil rank must match grid rank")
    if min(grid) < 1:
        raise ValueError(f"invalid grid shape: {grid}")
    if any(s % 2 == 0 for s in S.shape):
        raise ValueError("stencil must have odd extents in every dimension")

    N = int(np.prod(grid))
    centers = tuple(s // 2 for s in S.shape)
    strides = np.array([int(np.prod(grid[d + 1:])) for d in range(len(grid))],
                       dtype=np.int64)

    coords = np.unravel_index(np.arange(N, dtype=np.int64), grid)

    # Direct CSR assembly, no COO sort: with stencil offsets ordered by
    # their flat column delta, every row's entries come out column-sorted
    # (col = row + delta).  Per-row slot = indptr[row] + rank of the offset
    # among that row's valid offsets.  The old COO path paid an O(nnz log)
    # lexsort in sum_duplicates — 2.2 s of the 6 s assembly at 1024^2 9-pt.
    offs = []
    for off_idx in np.argwhere(S != 0):
        off = off_idx - np.array(centers)
        offs.append((int(off @ strides), off, S[tuple(off_idx)]))
    offs.sort(key=lambda t: t[0])

    K = len(offs)
    V = np.empty((K, N), dtype=bool)
    for kk, (_delta, off, _val) in enumerate(offs):
        valid = np.ones(N, dtype=bool)
        for d, o in enumerate(off):
            if o:
                valid &= (coords[d] + o >= 0) & (coords[d] + o < grid[d])
        V[kk] = valid
    rank = V.cumsum(axis=0, dtype=np.int16)         # ranks <= K
    counts = rank[-1].astype(np.int64) if K else np.zeros(N, np.int64)
    indptr = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    nnz = int(indptr[N])
    # indptr holds values up to nnz, so the index dtype must be keyed on
    # nnz, not N (a 27-point 450^3 stencil has nnz > 2^31 with N < 2^31)
    idx_dt = (np.int32 if max(N, nnz) < np.iinfo(np.int32).max
              else np.int64)
    indices = np.empty(nnz, dtype=idx_dt)
    data = np.empty(nnz, dtype=S.dtype)
    base = indptr[:-1]
    for kk, (delta, _off, val) in enumerate(offs):
        rowsk = np.flatnonzero(V[kk])
        p = base[rowsk] + (rank[kk, rowsk].astype(np.int64) - 1)
        indices[p] = (rowsk + delta).astype(idx_dt)
        data[p] = val

    A = sp.csr_matrix((data, indices, indptr.astype(idx_dt)), shape=(N, N))
    A.has_sorted_indices = True
    # distinct offsets can alias the same flat column delta only on grids
    # smaller than the stencil extents (where their validity regions are
    # disjoint anyway) — canonicalize just in case on such tiny grids
    if len({d for d, _o, _v in offs}) != K \
            or any(int(abs(o)) >= g for (_d, off, _v) in offs
                   for o, g in zip(off, grid)):
        A.sum_duplicates()
        A.sort_indices()
    fmt = format or "csr"
    A = A.asformat(fmt)
    try:
        A.grid = grid       # structured-grid metadata for the setup fast path
    except AttributeError:
        pass
    return A
