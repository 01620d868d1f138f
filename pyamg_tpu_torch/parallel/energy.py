"""Energy-minimization prolongation smoothing with its numeric phase on
the device.

The host keeps the integer stages: the pattern ``|C|^degree |T|``, the
per-row constraint Gram pseudo-inverses, T's embedding into the pattern's
slots and the per-slot coarse-candidate components.  The device runs the
whole fixed-pattern CG over padded-ELL slabs:

* its product ``A D`` (D the search direction on the pattern) is a
  pattern-masked SpGEMM on the hand-written kernels
  (``sparse/spgemm_device.masked_spgemm_auto``: the banded kernel where A
  has at most 64 offsets, else the gather kernel), routed once per level;
* the constraint projection gathers nothing: ``B[pattern.cols]`` is
  gathered once on the host and uploaded as K component slabs;
* the CG's dots and stopping test stay device tensors, so no iteration
  reads a number back to the host.

Early stopping is kept with ``where`` masks over exactly ``maxiter``
steps, so the iterate sequence is the host flat path's
(``aggregation.smooth._cg_prolongation_flat``) up to summation order.

Port of ``pyamg_tpu/parallel/energy.py`` on one device.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..sparse.ell import SparseELL
from ..sparse.spgemm_device import masked_spgemm_auto, spgemm_plan
from ..util.utils import not_ported

__all__ = ["energy_smooth_sharded"]


def _energy_cg(product, tvals, Bg, G, dinv, fmask, tol, maxiter):
    """The fixed-pattern energy CG from T's values ``tvals`` (n, w):
    ``product(vals)`` is the values of ``A D`` on the pattern; ``Bg``
    (K, n, w) the per-slot coarse-candidate components, ``G`` (K, K, n) the
    per-row Gram pseudo-inverses, ``fmask`` (n,) the F-row mask of the
    root-node form or None.  Returns P's values."""
    K = Bg.shape[0]

    def project(vals):
        if fmask is not None:
            vals = vals * fmask[:, None]
        UB = [torch.sum(vals * Bg[k], dim=1) for k in range(K)]
        coef = [sum(UB[l] * G[l, k] for l in range(K)) for k in range(K)]
        return vals - sum(coef[k][:, None] * Bg[k] for k in range(K))

    def dot(x, y):
        return torch.vdot(x.reshape(-1), y.reshape(-1))

    rvals = project(-product(tvals))
    normr0 = torch.clamp(rvals.abs().max(), min=1e-30)
    pvals, ptvals = tvals, torch.zeros_like(tvals)
    oldsum = torch.zeros((), dtype=tvals.dtype, device=tvals.device)
    live = torch.ones((), dtype=torch.bool, device=tvals.device)
    for _ in range(int(maxiter)):
        live = live & (rvals.abs().max() >= tol * normr0)
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


def energy_smooth_sharded(A_ell, T_host, C_host, B_coarse, mesh=None,
                          axis_name="rows", degree=1, maxiter=4, tol=1e-8,
                          weighting="local", fmask_host=None, PI_host=None,
                          dt=np.float32):
    """Energy-minimized P on A_ell's device: ``(P_ell, pattern_csr)``.

    ``A_ell``: the level's operator as a :class:`SparseELL`; ``T_host``,
    ``C_host`` and ``B_coarse``: the tentative prolongator, the strength
    matrix and the coarse candidates on the host.  ``fmask_host`` and
    ``PI_host`` carry the root-node contract (the reference's
    ``Cpt_params``): the F-row mask, and the C-point identity block added
    outside the minimization.  ``weighting``: ``"local"`` or
    ``"diagonal"``.  Every product runs ``masked_spgemm_auto`` (the JAX
    package's ``mm`` argument has no counterpart: on a CPU device that is
    the plain form).  ``mesh`` other than None is not ported."""
    from ..aggregation.smooth import _grow_pattern
    from ..util.utils import compute_BtBinv

    if mesh is not None:
        raise not_ported("energy smoothing over a mesh of several devices",
                         "the distributed path")
    device = A_ell.device
    n, nc = T_host.shape

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

    pat_ell = SparseELL.from_scipy(pattern, dtype=dt, device=device)
    w = pat_ell.width

    # T embedded into pattern slots (both sorted CSR: searchsorted keys)
    key_pat, key_T = _slot_keys(pattern, nc), _slot_keys(T, nc)
    pos = np.searchsorted(key_pat, key_T)
    if pos.max(initial=-1) >= pattern.nnz \
            or not (key_pat[pos] == key_T).all():
        raise ValueError("T's pattern escapes the energy pattern")
    rows = np.repeat(np.arange(n), np.diff(pattern.indptr))
    offs = np.arange(pattern.nnz) - np.repeat(pattern.indptr[:-1],
                                              np.diff(pattern.indptr))
    tslab = np.zeros((n, w), dtype=dt)
    tslab[rows[pos], offs[pos]] = T.data

    # per-slot coarse-candidate components (host gather, structure-static)
    Bg = np.zeros((K, n, w), dtype=dt)
    Bg[:, rows, offs] = B[pattern.indices].T.astype(dt)
    G = np.moveaxis(BtBinv.astype(dt), 0, -1)

    def upload(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    tvals, Bg_d, G_d = upload(tslab), upload(Bg), upload(G)
    fmask_d = None if fmask_host is None \
        else upload(np.asarray(fmask_host, dtype=dt))

    # ---- device: weighting and the whole CG -----------------------------
    if weighting == "local":
        Dv = torch.where(A_ell.valid_mask(), A_ell.data.abs(), 0).sum(dim=1)
    elif weighting == "diagonal":
        Dv = A_ell.diagonal()
    else:
        raise ValueError("distributed energy smoothing supports weighting "
                         "in ('local', 'diagonal'); got " + repr(weighting))
    dinv = torch.where(Dv != 0, 1.0 / torch.where(Dv != 0, Dv, 1), 0)

    # A and the pattern stay the same through the CG: route once
    plan = spgemm_plan(A_ell, pat_ell, pat_ell)

    def product(vals):
        D = SparseELL(vals, pat_ell.cols, pat_ell.row_nnz, pat_ell.shape)
        return masked_spgemm_auto(A_ell, D, pat_ell, plan=plan).data

    pvals = _energy_cg(product, tvals, Bg_d, G_d, dinv, fmask_d,
                       torch.tensor(tol, dtype=tvals.dtype, device=device),
                       maxiter)
    if PI_host is not None:
        # P = I_F P + P_I  (P_I's slots lie inside the pattern)
        PI = sp.csr_matrix(PI_host).astype(dt)
        PI.sort_indices()
        ppos = np.searchsorted(key_pat, _slot_keys(PI, nc))
        pislab = np.zeros((n, w), dtype=dt)
        pislab[rows[ppos], offs[ppos]] = PI.data
        pvals = pvals * (fmask_d[:, None] if fmask_d is not None else 1.0) \
            + upload(pislab)
    P_ell = SparseELL(pvals, pat_ell.cols, pat_ell.row_nnz, pat_ell.shape)
    return P_ell, pattern
