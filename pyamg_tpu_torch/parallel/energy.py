"""Energy-minimization prolongation smoothing with its numeric phase on
the device, row-sharded over a mesh of ranks.

The host keeps the integer stages (every rank runs them on the whole
level): the pattern ``|C|^degree |T|``, the per-row constraint Gram
pseudo-inverses, T's embedding into the pattern's slots and the per-slot
coarse-candidate components.  Each rank's device runs the fixed-pattern CG
on its rows of padded-ELL slabs:

* its product ``A D`` (D the search direction on the pattern) is a
  pattern-masked SpGEMM on the hand-written kernels
  (``parallel/products.masked_spgemm_mesh``: the rows of D that the
  rank's rows of A name are fetched every iteration, one exchange, then
  the banded kernel where A has at most 64 offsets, else the gather
  kernel), its fetch tables and route built once per level;
* the constraint projection gathers nothing: ``B[pattern.cols]`` is
  gathered once on the host and each rank uploads its rows of the K
  component slabs;
* the CG's dots and stopping test are device tensors summed (or, for the
  largest residual, maximized) over the ranks, so every rank takes the
  same steps and no iteration reads a number back to the host.

Early stopping is kept with ``where`` masks over exactly ``maxiter``
steps, so the iterate sequence is the host flat path's
(``aggregation.smooth._cg_prolongation_flat``) up to summation order.

Port of ``pyamg_tpu/parallel/energy.py``.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..sparse.ell import SparseELL
from ..sparse.spgemm_device import masked_spgemm_auto, spgemm_plan
from .mesh import Layout, one_rank_mesh
from .products import fetch_for, masked_spgemm_mesh, upload_rows
from .sharding import _check_mesh, pad_to

__all__ = ["energy_smooth_sharded"]


def _energy_cg(product, tvals, Bg, G, dinv, fmask, tol, maxiter, mesh):
    """The fixed-pattern energy CG from T's values ``tvals`` (this rank's
    rows, (n, w)): ``product(vals)`` is the values of ``A D`` on the
    pattern; ``Bg`` (K, n, w) the per-slot coarse-candidate components,
    ``G`` (K, K, n) the per-row Gram pseudo-inverses, ``fmask`` (n,) the
    F-row mask of the root-node form or None; the dots and the largest
    residual are taken over ``mesh``'s ranks.  Returns P's values."""
    K = Bg.shape[0]

    def project(vals):
        if fmask is not None:
            vals = vals * fmask[:, None]
        UB = [torch.sum(vals * Bg[k], dim=1) for k in range(K)]
        coef = [sum(UB[l] * G[l, k] for l in range(K)) for k in range(K)]
        return vals - sum(coef[k][:, None] * Bg[k] for k in range(K))

    def dot(x, y):
        return mesh.all_reduce(torch.vdot(x.reshape(-1), y.reshape(-1)))

    def amax(x):
        return mesh.all_reduce(x.abs().max(), op="max")

    rvals = project(-product(tvals))
    normr0 = torch.clamp(amax(rvals), min=1e-30)
    pvals, ptvals = tvals, torch.zeros_like(tvals)
    oldsum = torch.zeros((), dtype=tvals.dtype, device=tvals.device)
    live = torch.ones((), dtype=torch.bool, device=tvals.device)
    for _ in range(int(maxiter)):
        live = live & (amax(rvals) >= tol * normr0)
        zvals = rvals * dinv[:, None]
        newsum = dot(rvals, zvals)
        live = live & (newsum != 0)
        ptvals = torch.where(
            oldsum == 0, zvals,
            zvals + (newsum / torch.where(oldsum == 0, 1, oldsum)) * ptvals)
        ap = project(product(ptvals))
        d = dot(ptvals, ap)
        live = live & (d != 0)
        alpha = torch.where(live, newsum / torch.where(d == 0, 1, d), 0.0)
        pvals = pvals + alpha * ptvals
        rvals = rvals - alpha * ap
        oldsum = torch.where(live, newsum, oldsum)
    return pvals


def _slot_keys(M, nc):
    """``col + nc * row`` of each stored entry of a sorted CSR matrix."""
    n = M.shape[0]
    return M.indices.astype(np.int64) + np.int64(nc) * np.repeat(
        np.arange(n, dtype=np.int64), np.diff(M.indptr))


def energy_smooth_sharded(A, T_host, C_host, B_coarse, mesh=None,
                          axis_name="rows", degree=1, maxiter=4, tol=1e-8,
                          weighting="local", fmask_host=None, PI_host=None,
                          dt=np.float32):
    """Energy-minimized P: ``(P, pattern_csr)``.

    ``A``: the level's operator, either this rank's rows
    (:class:`~.products.RowSlab`, as the setups pass it) or the whole
    padded operator as a :class:`SparseELL` (on every rank of ``mesh``,
    whose rows each rank then takes; by default the one rank of A's
    device).  ``T_host``, ``C_host`` and ``B_coarse``: the tentative
    prolongator, the strength matrix and the coarse candidates on the
    host.  ``fmask_host`` and ``PI_host`` carry the root-node contract
    (the reference's ``Cpt_params``): the F-row mask, and the C-point
    identity block added outside the minimization.  ``weighting``:
    ``"local"`` or ``"diagonal"``.  Every product runs
    ``masked_spgemm_mesh`` (the JAX package's ``mm`` argument has no
    counterpart).  P comes back as A came: this rank's rows as a
    ``RowSlab``, or a ``SparseELL`` of the whole-operator form's rows
    (its shape the pattern's, padded to the ranks)."""
    from ..aggregation.smooth import _grow_pattern
    from ..util.utils import compute_BtBinv

    whole = isinstance(A, SparseELL)
    if whole:
        mesh = one_rank_mesh(A.device, axis_name) if mesh is None \
            else _check_mesh(mesh)
        A = upload_rows(A.to_scipy(), Layout(mesh, A.shape[0], True),
                        dtype=A.dtype)
    elif mesh is not None and _check_mesh(mesh) is not A.rows.mesh:
        raise ValueError("A's rows lie on another mesh")
    rows = A.rows
    mesh = rows.mesh
    if weighting not in ("local", "diagonal"):
        raise ValueError("distributed energy smoothing supports weighting "
                         "in ('local', 'diagonal'); got " + repr(weighting))
    n, nc = T_host.shape
    n_pad, nc_pad = rows.n, pad_to(max(nc, 1), mesh.size)
    lo, hi = rows.start, rows.start + rows.nl

    # ---- host: integer / symbolic stage --------------------------------
    T = sp.csr_matrix(T_host).astype(dt)
    T.sort_indices()
    pattern = _grow_pattern(C_host, T, degree)
    if PI_host is not None:
        IF = sp.diags(np.asarray(fmask_host, dtype=np.float64))
        pattern = (IF @ pattern).tocsr()
        PIpat = sp.csr_matrix(PI_host).copy()
        PIpat.data = np.ones_like(PIpat.data)
        pattern = (pattern + PIpat).tocsr()
        pattern.data = np.ones_like(pattern.data)
    pattern.sort_indices()
    B = np.asarray(B_coarse)
    K = B.shape[1]
    BtBinv = compute_BtBinv(B, pattern)                 # (n, K, K) f64

    pat_s = upload_rows(pattern, rows, nc_pad, dtype=dt, values=False)
    w = pat_s.ell.width

    # T embedded into pattern slots (both sorted CSR: searchsorted keys)
    key_pat, key_T = _slot_keys(pattern, nc), _slot_keys(T, nc)
    pos = np.searchsorted(key_pat, key_T)
    if pos.max(initial=-1) >= pattern.nnz \
            or not (key_pat[pos] == key_T).all():
        raise ValueError("T's pattern escapes the energy pattern")
    prow = np.repeat(np.arange(n), np.diff(pattern.indptr))
    offs = np.arange(pattern.nnz) - np.repeat(pattern.indptr[:-1],
                                              np.diff(pattern.indptr))

    def mine(a, axis=0):
        """Rows lo .. hi of a whole host array, zero past row n."""
        a = np.moveaxis(a, axis, 0)
        out = np.zeros((hi - lo,) + a.shape[1:], dtype=a.dtype)
        out[:max(0, min(hi, n) - lo)] = a[lo:min(hi, n)]
        return np.ascontiguousarray(np.moveaxis(out, 0, axis))

    tslab = np.zeros((n, w), dtype=dt)
    tslab[prow[pos], offs[pos]] = T.data

    # per-slot coarse-candidate components (host gather, structure-static)
    Bg = np.zeros((K, n, w), dtype=dt)
    Bg[:, prow, offs] = B[pattern.indices].T.astype(dt)
    G = np.moveaxis(BtBinv.astype(dt), 0, -1)

    def upload(a):
        return torch.as_tensor(a, device=mesh.device)

    tvals, Bg_d, G_d = upload(mine(tslab)), upload(mine(Bg, 1)), \
        upload(mine(G, 2))
    fmask_d = None if fmask_host is None \
        else upload(mine(np.asarray(fmask_host, dtype=dt)))

    # ---- device: weighting and the whole CG -----------------------------
    if weighting == "local":
        Dv = torch.where(A.valid_mask(), A.data.abs(), 0).sum(dim=1)
    else:
        Dv = A.diagonal()
    dinv = torch.where(Dv != 0, 1.0 / torch.where(Dv != 0, Dv, 1), 0)

    # A and the pattern stay the same through the CG: fetch tables and
    # route once
    fetch = fetch_for(A, pat_s)
    plan = spgemm_plan(*fetch.operands(A, pat_s.with_data(tvals)),
                       pat_s.ell)

    def product(vals):
        # this module's masked_spgemm_auto, looked up at each call, so
        # that a wrapper put in its place sees each product
        return masked_spgemm_mesh(A, pat_s.with_data(vals), pat_s,
                                  fetch=fetch, plan=plan,
                                  product=masked_spgemm_auto).data

    pvals = _energy_cg(product, tvals, Bg_d, G_d, dinv, fmask_d,
                       torch.tensor(tol, dtype=tvals.dtype,
                                    device=mesh.device), maxiter, mesh)
    if PI_host is not None:
        # P = I_F P + P_I  (P_I's slots lie inside the pattern)
        PI = sp.csr_matrix(PI_host).astype(dt)
        PI.sort_indices()
        ppos = np.searchsorted(key_pat, _slot_keys(PI, nc))
        pislab = np.zeros((n, w), dtype=dt)
        pislab[prow[ppos], offs[ppos]] = PI.data
        pvals = pvals * (fmask_d[:, None] if fmask_d is not None else 1.0) \
            + upload(mine(pislab))
    P = pat_s.with_data(pvals)
    return (P.ell if whole else P), pattern
