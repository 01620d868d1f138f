"""Classical (Ruge-Stuben) AMG setup with its numeric phase on the device.

Port of ``classical_setup_sharded`` from
``pyamg_tpu/parallel/classical_setup.py`` on one device.  The host keeps
the integer graph stages in numpy/scipy: strength thresholding, the C/F
splitting, the interpolation pattern with its map onto A's ELL slots, and
every symbolic product pattern.  The device runs the O(nnz)
floating-point stages over padded-ELL slabs: the squarings of the
evolution measure, the direct or standard interpolation values, R = P^T
onto its host-symbolic pattern and the Galerkin product R (A P), every
masked product on the hand-written kernels
(``sparse/spgemm_device.masked_spgemm_auto``: the banded kernel for A of
at most 64 offsets, the gather kernel otherwise).  Per level the host
reads back one numeric array: the coarse operator's values, which the next
level's strength and splitting need.

Examples
--------
>>> import numpy as np
>>> from pyamg_tpu_torch.gallery import poisson
>>> from pyamg_tpu_torch.parallel import classical_setup_sharded
>>> A = poisson((12, 12), format='csr')
>>> sol = classical_setup_sharded(A, max_coarse=20, device="cpu")
>>> b = np.ones(A.shape[0])
>>> x = sol.solve(b, tol=1e-8, maxiter=100, accel='cg')
>>> r = np.linalg.norm(b - A @ x.double().numpy())
>>> bool(r < 1e-4 * np.linalg.norm(b))    # float32 operators
True
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..multilevel import Level
from ..relaxation.device import SmootherData
from ..sparse.ell import SparseELL
from ..sparse.spgemm_device import (ell_transpose_onto, masked_spgemm_auto,
                                    masked_spgemm_ell)
from ..util.utils import not_ported, unpack_arg
from .setup import _DISTRIBUTED, _ell_smoother, _pattern_csr
from .sharding import ShardedSolver, _pad_ell, pad_to

__all__ = ["classical_setup_sharded"]


# ---------------------------------------------------------------------------
# device stages (slabs on A's, or a pattern's, ELL layout)
# ---------------------------------------------------------------------------

def _isdiag(Ac, valid):
    rows = torch.arange(Ac.shape[0], dtype=Ac.dtype, device=Ac.device)
    return valid & (Ac == rows[:, None])


def _direct_interp_slab(Ad, Ac, valid, strongC):
    """Direct-interpolation weights on A's own ELL layout: per row, alpha
    (beta) = the sum of all negative (positive) off-diagonal entries over
    the strong C ones, the positive mass lumped into the diagonal when no
    strong C entry is positive; a strong C slot holds ``-(alpha or beta) /
    a_ii * a_ij``, every other slot 0."""
    isdiag = _isdiag(Ac, valid)
    offd = valid & ~isdiag
    neg = Ad < 0

    def rowsum(mask):
        return torch.where(mask, Ad, 0).sum(dim=1)

    san, sap = rowsum(neg & offd), rowsum(~neg & offd)
    diag = rowsum(isdiag)
    ssn, ssp = rowsum(strongC & neg), rowsum(strongC & ~neg)
    no_pos = ssp == 0
    diag = diag + torch.where(no_pos, sap, 0)
    alpha = torch.where(ssn != 0, san / torch.where(ssn != 0, ssn, 1), 0)
    beta = torch.where(no_pos, 0, sap / torch.where(ssp != 0, ssp, 1))
    dsafe = torch.where(diag != 0, diag, 1)
    coeff = torch.where(neg, (-alpha / dsafe)[:, None],
                        (-beta / dsafe)[:, None])
    return torch.where(strongC, coeff * Ad, 0)


def _gather_slots(W, amap, identity=1.0):
    """A slab gathered from W's slots by a host-built slot map: ``amap >=
    0`` takes ``W[row, amap]``, -1 ``identity`` (a C point's row of P),
    anything else 0."""
    g = torch.gather(W, 1, amap.clamp(min=0))
    return torch.where(amap >= 0, g, identity * (amap == -1).to(W.dtype))


def _std_distribute(SFd, denomd, validSF):
    """``a_ij / denom(i, j)`` on the strong F-F pattern, and per row the
    strong F mass whose denominator is zero (lumped)."""
    nz = denomd != 0
    B = torch.where(nz, SFd / torch.where(nz, denomd, 1), 0)
    return B, torch.where(validSF & ~nz, SFd, 0).sum(dim=1)


def _std_diag(Ad, Ac, validA, SCd, SFd, lump):
    """``d_i = a_ii + weak off-diagonal mass + lumped mass``."""
    isdiag = _isdiag(Ac, validA)
    offsum_A = torch.where(validA & ~isdiag, Ad, 0).sum(dim=1)
    offsum_S = SCd.sum(dim=1) + SFd.sum(dim=1)
    return torch.where(isdiag, Ad, 0).sum(dim=1) + (offsum_A - offsum_S) \
        + lump


def _std_final_P(w, diag, amap):
    """P's values: ``-w / d`` gathered onto P's slots (0 on rows with
    ``d == 0``; -1 slots are C-point identities)."""
    nz = diag != 0
    vals = torch.where(nz[:, None], -w / torch.where(nz, diag, 1)[:, None],
                       0)
    return _gather_slots(vals, amap)


# ---------------------------------------------------------------------------
# host integer helpers (pattern membership, slot maps, slabs)
# ---------------------------------------------------------------------------

def _csr_keys(M):
    rows = np.repeat(np.arange(M.shape[0], dtype=np.int64),
                     np.diff(M.indptr))
    return rows, rows * M.shape[1] + M.indices.astype(np.int64)


def _in_sorted(kS, kQ):
    if kS.size == 0:
        return np.zeros(kQ.shape, dtype=bool)
    pos = np.minimum(np.searchsorted(kS, kQ), kS.size - 1)
    return kS[pos] == kQ


def _slab_from_csr(Q, vals, n_pad, width, fill, dtype=np.int64):
    """The per-entry values of CSR Q scattered into an (n_pad, width)
    slab, ``fill`` elsewhere."""
    nnz_r = np.diff(Q.indptr)
    slab = np.full((n_pad, width), fill, dtype=dtype)
    rows = np.repeat(np.arange(Q.shape[0]), nnz_r)
    slab[rows, np.arange(Q.nnz) - np.repeat(Q.indptr[:-1], nnz_r)] = vals
    return slab


def _slot_positions(M):
    """The position of each entry within its row, of a sorted CSR."""
    return (np.arange(M.nnz)
            - np.repeat(M.indptr[:-1], np.diff(M.indptr))).astype(np.int64)


def _enc_csr(rows, cols, slots, shape):
    """A CSR whose data carries slot indices + 2 (so that the -1 and -2
    marks survive): sorting the indices permutes the map with them."""
    M = sp.csr_matrix((slots.astype(np.float64) + 2.0, (rows, cols)),
                      shape=shape)
    M.sort_indices()
    return M


def _device_masked_power(mm, device):
    """``strength._masked_power`` with every squaring of ``(I - c D^-1
    A)^T`` a masked product on ``device`` (the host builds the symbolic
    patterns only); one read-back per squaring."""
    def impl(Atilde_T, nsquare, mask):
        M = sp.csr_matrix(Atilde_T)
        M.sort_indices()
        n = M.shape[0]
        for step in range(nsquare):
            if step == nsquare - 1:
                pat = _pattern_csr(mask, (n, n))
            else:
                pm = _pattern_csr(M)
                pat = _pattern_csr(pm @ pm, (n, n))
            M_ell = SparseELL.from_scipy(M, device=device)
            out = mm(M_ell, M_ell, SparseELL.from_scipy(
                pat, dtype=np.float32, device=device))
            M = out.to_scipy()[:n, :n].tocsr()
            M.sort_indices()
        if nsquare == 0:
            pat = _pattern_csr(mask)
            M = M.multiply(sp.csr_matrix(
                (np.ones(pat.nnz), pat.indices, pat.indptr),
                shape=pat.shape)).tocsr()
        M.eliminate_zeros()
        M.sort_indices()
        return M

    return impl


# ---------------------------------------------------------------------------
# the constructor
# ---------------------------------------------------------------------------

def classical_setup_sharded(A, mesh=None, n_devices=None,
                            strength=("classical", {"theta": 0.25}),
                            CF="RS", interpolation="direct",
                            smoother=("multicolor_gauss_seidel",
                                      {"iterations": 1,
                                       "sweep": "symmetric"}),
                            dtype=None, max_levels=10, max_coarse=500,
                            spgemm="auto", device="cuda"):
    """Ruge-Stuben setup with the numeric phase on ``device``.

    Arguments as in the JAX package, on one device (``mesh=None``,
    ``n_devices`` None or 1).  ``strength``: "classical", "symmetric",
    "evolution" (its squarings on the device) or None; ``CF``: "RS",
    "PMIS", "PMISc", "CLJP", "CLJPc" or "MIS"; ``interpolation``: "direct"
    or "standard".  ``spgemm="auto"`` runs every masked product on the
    hand-written kernels (in plain PyTorch on a CPU device); ``"xla"``
    runs the plain form ``masked_spgemm_ell`` on any device.  ``dtype``
    (default float32) is the type of the host operators and of every
    device array.  Returns a
    :class:`~pyamg_tpu_torch.parallel.sharding.ShardedSolver`."""
    from ..classical import split as split_mod
    from ..strength import (classical_strength_of_connection,
                            evolution_strength_of_connection,
                            symmetric_strength_of_connection)

    if mesh is not None or n_devices not in (None, 1):
        raise not_ported("a classical setup over a mesh of several devices",
                         _DISTRIBUTED)
    nd = 1
    dt = np.dtype(dtype or np.float32)
    if spgemm not in ("auto", "xla"):
        raise ValueError(f"spgemm must be 'auto' or 'xla'; got {spgemm!r}")

    def mm(A_op, B_op, pattern):
        # the module's names are looked up at each call, so that a wrapper
        # a caller puts in their place sees every product
        if spgemm == "auto":
            return masked_spgemm_auto(A_op, B_op, pattern)
        return masked_spgemm_ell(A_op, B_op, pattern)

    s_name, s_kw = unpack_arg(strength)
    cf_name, cf_kw = unpack_arg(CF)
    i_name, _ = unpack_arg(interpolation)
    sm_name, sm_kw = unpack_arg(smoother)
    if i_name not in ("direct", "standard"):
        raise ValueError("the device classical setup supports interpolation "
                         f"in ('direct', 'standard'); got {i_name!r}")
    if sm_name not in ("jacobi", "multicolor_gauss_seidel"):
        raise ValueError("the device classical setup supports smoother in "
                         f"('jacobi', 'multicolor_gauss_seidel'); got "
                         f"{sm_name!r}")
    splittings = {"RS": split_mod.RS, "PMIS": split_mod.PMIS,
                  "PMISc": split_mod.PMISc, "CLJP": split_mod.CLJP,
                  "CLJPc": split_mod.CLJPc, "MIS": split_mod.MIS}
    if cf_name not in splittings:
        raise ValueError(f"unknown C/F splitting method {CF!r}")
    if s_name not in ("classical", "symmetric", "evolution", "ode", None):
        raise ValueError("the device classical setup supports strength in "
                         "('classical', 'symmetric', 'evolution', None); "
                         f"got {s_name!r}")

    def strength_matrix(A_h):
        if s_name == "classical":
            return classical_strength_of_connection(A_h, **s_kw)
        if s_name == "symmetric":
            return symmetric_strength_of_connection(A_h, **s_kw)
        if s_name in ("evolution", "ode"):
            return evolution_strength_of_connection(
                A_h, _masked_power_impl=_device_masked_power(mm, device),
                **s_kw)
        return A_h.copy()

    def ell(M, rows=None, cols=None, dtype=dt):
        E = SparseELL.from_scipy(M, dtype=dtype, device=device)
        return E if rows is None else _pad_ell(E, rows, cols)

    def slab(Q, vals, n_pad, width, fill):
        return torch.as_tensor(_slab_from_csr(Q, vals, n_pad, width, fill),
                               device=device)

    def slot_map(enc, n_pad, width):
        return slab(enc, enc.data.astype(np.int64) - 2, n_pad, width, -2)

    A_host = sp.csr_matrix(A).astype(dt)
    A_host.sort_indices()
    n_orig = A_host.shape[0]

    levels, sizes = [], []
    while len(levels) < max_levels - 1 and A_host.shape[0] > max_coarse:
        n = A_host.shape[0]
        n_pad = pad_to(n, nd)

        # ---- host: integer graph stage ---------------------------------
        C = sp.csr_matrix(strength_matrix(A_host))
        C.sort_indices()
        splitting = np.asarray(splittings[cf_name](C, **cf_kw))
        ncp = int(splitting.sum())
        if ncp == 0 or ncp == n:
            break                                  # degenerate split
        cpts = np.flatnonzero(splitting)
        cmap = np.cumsum(splitting) - splitting
        rowsA, kA = _csr_keys(A_host)
        _, kC = _csr_keys(C)
        offd_e = _in_sorted(kC, kA) & (rowsA != A_host.indices)
        strongC_e = offd_e & (splitting[A_host.indices] == 1)
        slotsA = _slot_positions(A_host)

        # ---- device: numeric stage ---------------------------------------
        A_ell = ell(A_host, n_pad, n_pad)
        valid = A_ell.valid_mask()
        nc_pad = pad_to(ncp, nd)

        if i_name == "direct":
            strong = slab(A_host, strongC_e, n_pad, A_ell.width,
                          False).bool()
            W = _direct_interp_slab(A_ell.data, A_ell.cols, valid, strong)
            selF = strongC_e & (splitting[rowsA] == 0)
            P_enc = _enc_csr(
                np.concatenate([rowsA[selF], cpts]),
                np.concatenate([cmap[A_host.indices[selF]], cmap[cpts]]),
                np.concatenate([slotsA[selF],
                                np.full(cpts.size, -1, np.int64)]),
                (n, ncp))
            patP = _pattern_csr(P_enc, (n_pad, nc_pad))
            patP_ell = ell(patP)
            P_data = _gather_slots(W, slot_map(P_enc, n_pad,
                                               patP_ell.width))
        else:
            # standard interpolation: its two pair quantities are masked
            # products on the strong F-F and strong C patterns
            valnz = A_host.data != 0
            sC_e = strongC_e & valnz
            sF_e = offd_e & (splitting[A_host.indices] == 0) & valnz
            SC_enc = _enc_csr(rowsA[sC_e], A_host.indices[sC_e],
                              slotsA[sC_e], (n, n))
            SF_enc = _enc_csr(rowsA[sF_e], A_host.indices[sF_e],
                              slotsA[sF_e], (n, n))
            patSC = _pattern_csr(SC_enc, (n_pad, n_pad))
            patSF_ell = ell(_pattern_csr(SF_enc, (n_pad, n_pad)))
            patSC_ell = ell(patSC)
            patSCT_ell = ell(_pattern_csr(patSC.T, (n_pad, n_pad)))

            SCd = _gather_slots(A_ell.data, slot_map(
                SC_enc, n_pad, patSC_ell.width), identity=0.0)
            SFd = _gather_slots(A_ell.data, slot_map(
                SF_enc, n_pad, patSF_ell.width), identity=0.0)
            SC_ell = SparseELL(SCd, patSC_ell.cols, patSC_ell.row_nnz,
                               patSC_ell.shape)
            Pind = SparseELL(patSC_ell.valid_mask().to(SCd.dtype),
                             patSC_ell.cols, patSC_ell.row_nnz,
                             patSC_ell.shape)
            denom = mm(Pind, ell_transpose_onto(SC_ell, patSCT_ell),
                       patSF_ell)
            Bd, lump = _std_distribute(SFd, denom.data,
                                       patSF_ell.valid_mask())
            contrib = mm(SparseELL(Bd, patSF_ell.cols, patSF_ell.row_nnz,
                                   patSF_ell.shape), SC_ell, patSC_ell)
            w = SCd + contrib.data
            diag = _std_diag(A_ell.data, A_ell.cols, valid, SCd, SFd, lump)

            rows_sc = np.repeat(np.arange(n), np.diff(SC_enc.indptr))
            keepP = splitting[rows_sc] == 0
            P_enc = _enc_csr(
                np.concatenate([rows_sc[keepP], cpts]),
                np.concatenate([cmap[SC_enc.indices[keepP]], cmap[cpts]]),
                np.concatenate([_slot_positions(SC_enc)[keepP],
                                np.full(cpts.size, -1, np.int64)]),
                (n, ncp))
            patP = _pattern_csr(P_enc, (n_pad, nc_pad))
            patP_ell = ell(patP)
            P_data = _std_final_P(w, diag, slot_map(P_enc, n_pad,
                                                    patP_ell.width))

        P_ell = SparseELL(P_data, patP_ell.cols, patP_ell.row_nnz,
                          patP_ell.shape)

        # ---- Galerkin triple product on the device -----------------------
        patA = _pattern_csr(A_host, (n_pad, n_pad))
        patR = _pattern_csr(patP.T)
        patAP = _pattern_csr(patA @ patP)
        R_ell = ell_transpose_onto(P_ell, ell(patR))
        AP = mm(A_ell, P_ell, ell(patAP))
        Ac_ell = mm(R_ell, AP, ell(_pattern_csr(patR @ patAP)))

        # ---- the one numeric read-back: coarse values for the next level
        Ac_host = Ac_ell.to_scipy()[:ncp, :ncp].tocsr()
        Ac_host.eliminate_zeros()
        Ac_host.sort_indices()

        d = A_ell.diagonal()
        dinv = torch.where(d != 0, 1.0 / torch.where(d != 0, d, 1), 0)
        lvl = Level(A_csr=A_host, A=A_ell, P=P_ell, R=R_ell,
                    splitting=splitting)
        lvl.presmoother = lvl.postsmoother = _ell_smoother(
            sm_name, sm_kw, patA[:n, :n].tocsr(), dinv, n_pad, dt, device)
        levels.append(lvl)
        sizes.append(n_pad)
        if Ac_host.shape[0] == n:
            break                                  # coarsening stalled
        A_host = Ac_host

    # coarsest level: solved by the padded dense pseudoinverse
    n_pad = pad_to(A_host.shape[0], nd)
    last = Level(A_csr=A_host, A=ell(A_host, n_pad, n_pad))
    last.presmoother = last.postsmoother = SmootherData(kind="none")
    levels.append(last)
    sizes.append(n_pad)
    return ShardedSolver.from_sharded_levels(levels, sizes, n_orig, device)
