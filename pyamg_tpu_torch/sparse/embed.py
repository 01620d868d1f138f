"""Fine-embedded DIA transfer operators.

A transfer pair (P: n_f x n_c, R: n_c x n_f) whose coarse dofs each sit at
a distinct fine dof -- smoothed aggregation's aggregate roots -- can be
re-indexed into (n x n) stencil operators: P's coarse column j goes to the
fine position of coarse dof j, and so does R's row j.  On grid-ordered
problems the embedded pattern is banded (its offsets are the fine-grid
distances to nearby roots), so applying P or R is one DIA matvec on the
hand-written kernel plus an n_c-sized scatter or gather, instead of a
gather per stored entry.

Port of ``pyamg_tpu/sparse/embed.py``; returns None (the caller then takes
``device_operator``'s form) when the embedded pattern is not banded enough
or its bands would store more than ten times the entries.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..util.utils import numpy_dtype
from .device_op import DENSE_MAX, DIA_MEM_BUDGET, DIA_MEM_FLOOR
from .dia import SparseDIA
from .linop import CptProlongOp, CptRestrictOp

__all__ = ["embedded_dia_transfers", "root_embedded_transfers"]


def embedded_dia_transfers(P_csr, cpt_dofs, dtype=None, max_offsets=96,
                           restrict="transpose", R_csr=None, device="cuda"):
    """``(CptProlongOp, CptRestrictOp)`` of a transfer pair, or None.

    ``cpt_dofs``: the fine position of each coarse dof (distinct).
    ``dtype``: numpy or torch dtype of the device arrays (cast on the
    host).  ``max_offsets``: the cap on the embedded pattern's diagonals.
    ``restrict``: ``"transpose"`` (R = P.T, symmetric SA),
    ``"conj_transpose"`` (R = P^H, hermitian SA) or ``"explicit"`` (the
    independent ``R_csr`` (n_c, n_f) of a nonsymmetric hierarchy, its rows
    embedded at the same positions, under the same cap)."""
    if restrict not in ("transpose", "conj_transpose", "explicit"):
        raise ValueError(f"unknown restrict mode {restrict!r}")
    n, nc = P_csr.shape
    cpts = np.asarray(cpt_dofs).astype(np.int64, copy=False).ravel()
    if cpts.size != nc or nc == 0:
        return None

    npdt = numpy_dtype(dtype)
    # the DIA chooser's fill rule: never store more than 10x the entries,
    # with a floor under which the bands are cheap whatever they hold
    mem_cap = max(DIA_MEM_BUDGET * max(P_csr.nnz, 1), DIA_MEM_FLOOR)
    Pf = sp.csr_matrix((P_csr.data, cpts[P_csr.indices], P_csr.indptr),
                       shape=(n, n))
    try:
        pf_diags, pf_offs = SparseDIA.host_diags(Pf, dtype=npdt,
                                                 max_offsets=max_offsets)
    except ValueError:
        return None
    if len(pf_offs) * n > mem_cap:
        return None
    if restrict == "explicit":
        if R_csr is None:
            return None
        Rc = sp.coo_matrix(R_csr)
        RfT = sp.csr_matrix((Rc.data, (cpts[Rc.row], Rc.col)), shape=(n, n))
        try:
            rt_diags, rt_offs = SparseDIA.host_diags(
                RfT, dtype=npdt, max_offsets=max_offsets)
        except ValueError:
            return None
        if len(rt_offs) * n > mem_cap:
            return None
    else:
        rt_diags, rt_offs = SparseDIA.host_transpose(pf_diags, pf_offs,
                                                     (n, n))
        if restrict == "conj_transpose" and np.iscomplexobj(rt_diags):
            rt_diags = rt_diags.conj()

    cpts_dev = torch.as_tensor(cpts, device=device)
    Pdia = SparseDIA(torch.as_tensor(pf_diags, device=device), pf_offs,
                     (n, n))
    Rdia = SparseDIA(torch.as_tensor(rt_diags, device=device), rt_offs,
                     (n, n))
    return (CptProlongOp(Pdia, cpts_dev, (n, nc)),
            CptRestrictOp(Rdia, cpts_dev, (nc, n)))


def root_embedded_transfers(lvl, dtype=None, max_offsets=None,
                            device="cuda"):
    """The aggregate-root embedding of an SA level's transfers, or None.

    Uses ``lvl.root_dofs`` (the fine position of every coarse dof, recorded
    when the hierarchy was extended) and the level's symmetry, so that the
    embedded restriction equals the host ``R_csr``: P^H on a hermitian
    hierarchy, P.T on a symmetric one, ``R_csr`` itself on a nonsymmetric
    one."""
    root_dofs = getattr(lvl, "root_dofs", None)
    if root_dofs is None:
        return None
    P = lvl.P_csr
    if P.shape[1] != np.asarray(root_dofs).size:
        return None
    if P.shape[0] <= DENSE_MAX and P.shape[1] <= DENSE_MAX:
        return None       # tiny level: one dense matmul beats scatter + DIA
    if max_offsets is None:
        # small levels tolerate wide bands (their DIA arrays stay small);
        # large levels keep the tight cap
        n = P.shape[0]
        max_offsets = 96 if n > 1 << 18 else (256 if n > 1 << 14 else 1024)
    sym = getattr(lvl, "symmetry", "hermitian")
    mode = {"hermitian": "conj_transpose",
            "symmetric": "transpose"}.get(sym, "explicit")
    return embedded_dia_transfers(
        P, root_dofs, dtype=dtype, max_offsets=max_offsets, restrict=mode,
        R_csr=lvl.R_csr if mode == "explicit" else None, device=device)
