"""'New ideal' interpolation: local least-squares approximations of ideal
interpolation, and the solver built on them.

Port of ``pyamg_tpu/aggregation/rootnode_nii.py``.  Ideal interpolation
is ``P* = [-A_FF^-1 A_FC; I]``; each F row is approximated by a small dense
least-squares solve over the F point's neighbourhood and the C points next
to it.  The JAX package solves them one row at a time in a Python loop;
here every local system is gathered at once, zero-padded to the largest
size found and solved as one batched pseudo-inverse (in chunks over a pool
of threads, since numpy's batched SVD releases the GIL).

Examples
--------
>>> import numpy as np
>>> from pyamg_tpu_torch.gallery import poisson
>>> P = ben_ideal_interpolation(poisson((16,), format='csr'),
...                             np.arange(0, 16, 2))
>>> P.shape
(16, 8)
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import scipy.sparse as sp

from ..multilevel import Level, MultilevelSolver
from ..relaxation.smoothing import change_smoothers
from ..sparse import device_operator
from ..util.utils import to_csr
from .aggregation import _aggregate, _strength

__all__ = ["newideal_solver", "ben_ideal_interpolation"]

# local systems solved per task of the thread pool
_CHUNK = 32768


def _ragged(indptr, rows):
    """``(owner, slot)`` of the stored entries of CSR rows ``rows``: the
    position in ``rows`` each entry belongs to, and its CSR index."""
    starts = indptr[rows]
    lens = indptr[rows + 1] - starts
    owner = np.repeat(np.arange(rows.size), lens)
    slot = np.arange(owner.size) - np.repeat(np.cumsum(lens) - lens, lens) \
        + starts[owner]
    return owner, slot


def _position(keys, table):
    """Index of each of ``keys`` in the sorted unique array ``table``, -1
    where absent."""
    pos = np.searchsorted(table, keys)
    pos = np.minimum(pos, max(table.size - 1, 0))
    found = table.size > 0
    return np.where(found & (table[pos] == keys), pos, -1) if found \
        else np.full(keys.shape, -1)


def _first_rows_of_pinv(AFF, nF, eps):
    """Row 0 of ``pinv(AFF[r])`` for each system r, singular values at or
    below ``eps * nF[r] * sigma_max`` cut (``np.linalg.lstsq``'s default
    cutoff on the unpadded system; the zero padding only adds zero
    singular values)."""
    m = AFF.shape[0]
    rcond = eps * nF.astype(float)

    def solve(lo):
        hi = min(lo + _CHUNK, m)
        return np.linalg.pinv(AFF[lo:hi], rcond=rcond[lo:hi])[:, 0, :]

    starts = range(0, m, _CHUNK)
    workers = min(len(starts), os.cpu_count() or 1)
    if workers <= 1:
        return np.concatenate([solve(lo) for lo in starts]) if m \
            else np.zeros((0, AFF.shape[2]), dtype=AFF.dtype)
    with ThreadPoolExecutor(workers) as pool:
        return np.concatenate(list(pool.map(solve, starts)))


def ben_ideal_interpolation(A, Cnodes, C=None, max_nbr=12):
    """Local least-squares approximation of ideal interpolation: CSR P of
    shape (n, n_C), C rows the identity.

    For each F point i, the local F set is i followed by its F neighbours
    in the strength matrix ``C`` (A when None), in their stored order, cut
    to ``max_nbr``; the local C set is every C neighbour in A of the local
    F set, sorted.  Row i of P is the first row of the minimum-norm
    solution W of ``A_FF W = -A_FC`` on those sets (the entries of ``|w|
    <= 1e-12 max|w|`` dropped); a row with an empty C set stays empty.
    """
    A = to_csr(A)
    n = A.shape[0]
    Cnodes = np.asarray(Cnodes, dtype=np.int64)
    isC = np.zeros(n, dtype=bool)
    isC[Cnodes] = True
    cmap = np.cumsum(isC) - 1          # fine C index -> coarse index
    S = to_csr(C) if C is not None else A
    Fpts = np.flatnonzero(~isC)
    nrow = Fpts.size

    # local F sets: (nrow, NF), -1 padded; column 0 the F point itself
    owner, slot = _ragged(S.indptr, Fpts)
    j = S.indices[slot].astype(np.int64)
    keep = ~isC[j] & (j != Fpts[owner])
    owner, j = owner[keep], j[keep]
    rank = np.arange(owner.size) - np.searchsorted(owner, owner)
    keep = rank < max_nbr - 1
    owner, j, rank = owner[keep], j[keep], rank[keep]
    nF = np.minimum(np.bincount(owner, minlength=nrow) + 1, max_nbr)
    NF = int(nF.max()) if nrow else 1
    locF = np.full((nrow, NF), -1, dtype=np.int64)
    locF[:, 0] = Fpts
    locF[owner, rank + 1] = j

    # every stored entry of A in a row of a local F set: (system, row in
    # the system, column, value)
    sys_r, sys_k = np.nonzero(locF >= 0)
    f = locF[sys_r, sys_k]
    ent_owner, ent = _ragged(A.indptr, f)
    r, k = sys_r[ent_owner], sys_k[ent_owner]
    col = A.indices[ent].astype(np.int64)
    val = A.data[ent]

    # local C sets: the sorted unique (system, C column) pairs
    isc = isC[col]
    ckey = np.unique(r[isc] * n + col[isc])
    c_owner = ckey // n
    nC = np.bincount(c_owner, minlength=nrow)
    cstart = np.concatenate([[0], np.cumsum(nC)])
    NC = int(nC.max()) if nrow else 0

    # the systems with a C set, zero-padded to (NF, NF) and (NF, NC)
    has_c = nC > 0
    sys_of = np.cumsum(has_c) - 1
    m = int(has_c.sum())
    AFF = np.zeros((m, NF, NF), dtype=A.dtype)
    AFC = np.zeros((m, NF, max(NC, 1)), dtype=A.dtype)
    order = np.argsort(sys_r * n + f)
    fkey, fslot = (sys_r * n + f)[order], sys_k[order]
    in_f = _position(r * n + col, fkey)
    sel = (in_f >= 0) & has_c[r]
    AFF[sys_of[r[sel]], k[sel], fslot[in_f[sel]]] = val[sel]
    sel = isc & has_c[r]
    cpos = _position(r[sel] * n + col[sel], ckey) - cstart[r[sel]]
    AFC[sys_of[r[sel]], k[sel], cpos] = val[sel]

    eps = np.finfo(A.dtype).eps
    w = -np.einsum("rk,rkc->rc", _first_rows_of_pinv(AFF, nF[has_c], eps),
                   AFC)
    wmax = np.abs(w).max(axis=1) if m else np.zeros(0)
    nz = np.abs(w) > 1e-12 * np.maximum(wmax, 1e-300)[:, None]
    nz &= np.arange(w.shape[1])[None, :] < nC[has_c][:, None]
    rows_f, slots = np.nonzero(nz)
    Fsys = Fpts[has_c]
    cols_f = cmap[ckey[cstart[:-1][has_c][rows_f] + slots] % n]

    P = sp.coo_matrix(
        (np.concatenate([np.ones(Cnodes.size, dtype=A.dtype),
                         w[rows_f, slots]]),
         (np.concatenate([Cnodes, Fsys[rows_f]]),
          np.concatenate([cmap[Cnodes], cols_f]))),
        shape=(n, int(isC.sum()))).tocsr()
    return P


def _galerkin(R, A, P):
    """``R A P`` as CSR, explicit zeros dropped."""
    Ac = (R @ A @ P).tocsr()
    Ac.eliminate_zeros()
    return Ac


def newideal_solver(A, B=None, strength="symmetric", aggregate="standard",
                    presmoother=("gauss_seidel", {"sweep": "symmetric"}),
                    postsmoother=("gauss_seidel", {"sweep": "symmetric"}),
                    max_levels=10, max_coarse=100, coarse_solver="pinv",
                    keep=False, device="cuda", **kwargs):
    """A hierarchy whose P is :func:`ben_ideal_interpolation` on the
    aggregates' root nodes (the C points), ``R = P^H`` and ``A_c = R A
    P``, on ``device``.  Levels are added while A has more than
    ``max_coarse`` rows and the coarse A is smaller; every level's A, P
    and R take ``device_operator``'s form, in A's dtype."""
    A = to_csr(A)
    levels = [Level()]
    levels[0].A_csr = A
    levels[0].B = (np.ones((A.shape[0], 1), dtype=A.dtype)
                   if B is None else np.asarray(B, dtype=A.dtype))
    levels[0].blocksize = 1
    levels[0].symmetry = "hermitian"

    while (len(levels) < max_levels
           and levels[-1].A_csr.shape[0] > max_coarse):
        lvl = levels[-1]
        Ak = lvl.A_csr
        C = _strength(Ak, lvl.B, strength)
        AggOp, Cnodes = _aggregate(C, Ak, lvl.B, aggregate)
        if Cnodes is None or len(Cnodes) == 0 or AggOp.shape[1] == 0:
            break
        P = ben_ideal_interpolation(Ak, Cnodes, C=C)
        lvl.P_csr = P
        lvl.R_csr = P.conjugate().T.tocsr()
        if keep:
            lvl.AggOp = AggOp
            lvl.Cnodes = Cnodes
        A_coarse = _galerkin(lvl.R_csr, Ak, P)
        if A_coarse.shape[0] >= Ak.shape[0]:
            break
        levels.append(Level(A_csr=A_coarse, blocksize=1,
                            symmetry="hermitian",
                            B=np.ones((A_coarse.shape[0], 1),
                                      dtype=A.dtype)))

    for lvl in levels:
        lvl.A = device_operator(lvl.A_csr, device=device)
        if hasattr(lvl, "P_csr"):
            lvl.P = device_operator(lvl.P_csr, device=device)
            lvl.R = device_operator(lvl.R_csr, device=device)

    ml = MultilevelSolver(levels, coarse_solver=coarse_solver, device=device)
    change_smoothers(ml, presmoother, postsmoother)
    return ml
