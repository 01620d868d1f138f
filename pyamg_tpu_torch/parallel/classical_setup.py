"""Classical (Ruge-Stuben) AMG setup with its numeric phase on the device,
row-sharded over a mesh of ranks.

Port of ``classical_setup_sharded`` from
``pyamg_tpu/parallel/classical_setup.py``.  Every rank runs the host
integer stages on the whole level in numpy/scipy: strength thresholding,
the C/F splitting, the interpolation pattern with its map onto A's ELL
slots, and every symbolic product pattern.  Each rank's device runs the
O(nnz) floating-point stages on its rows of padded-ELL slabs: the
squarings of the evolution measure, the direct or standard interpolation
values, R = P^T onto its host-symbolic pattern and the Galerkin product
R (A P), every masked product on the hand-written kernels
(``parallel/products.masked_spgemm_mesh`` over
``sparse/spgemm_device.masked_spgemm_auto``: the banded kernel for A of
at most 64 offsets, the gather kernel otherwise), reading the rows of B
its rows of A name from the other ranks.  Per level the host reads back
one numeric array, onto every rank: the coarse operator's values, which
the next level's strength and splitting need (and one a squaring of the
evolution measure).

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

from ..sparse.spgemm_device import masked_spgemm_auto, masked_spgemm_ell
from ..util.utils import unpack_arg
from .mesh import Layout
from .products import (host_values, masked_spgemm_mesh, operator,
                       transpose_onto_mesh, upload_rows)
from .setup import (_dinv, _ell_smoother, _level, _pattern_csr,
                    _pattern_rows, _setup_mesh, _with_coarsest)
from .sharding import pad_to

__all__ = ["classical_setup_sharded"]


# ---------------------------------------------------------------------------
# device stages (slabs on A's, or a pattern's, ELL layout)
# ---------------------------------------------------------------------------

def _isdiag(Ac, valid, row0=0):
    """The diagonal slots of a slab of rows ``row0 ..`` (global columns)."""
    rows = torch.arange(row0, row0 + Ac.shape[0], dtype=Ac.dtype,
                        device=Ac.device)
    return valid & (Ac == rows[:, None])


def _direct_interp_slab(Ad, Ac, valid, strongC, row0=0):
    """Direct-interpolation weights on A's own ELL layout (a slab of rows
    ``row0 ..``): per row, alpha
    (beta) = the sum of all negative (positive) off-diagonal entries over
    the strong C ones, the positive mass lumped into the diagonal when no
    strong C entry is positive; a strong C slot holds ``-(alpha or beta) /
    a_ii * a_ij``, every other slot 0."""
    isdiag = _isdiag(Ac, valid, row0)
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


def _std_diag(Ad, Ac, validA, SCd, SFd, lump, row0=0):
    """``d_i = a_ii + weak off-diagonal mass + lumped mass`` (A's slab of
    rows ``row0 ..``)."""
    isdiag = _isdiag(Ac, validA, row0)
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


def _mesh_masked_power(mm, mesh):
    """``strength._masked_power`` with every squaring of ``(I - c D^-1
    A)^T`` a masked product over ``mesh``'s ranks (``mm(A_s, B_s,
    pattern_s)`` on row slabs; the host builds the symbolic patterns
    only); each squaring's values are read back onto every rank."""
    def impl(Atilde_T, nsquare, mask):
        M = sp.csr_matrix(Atilde_T)
        M.sort_indices()
        n = M.shape[0]
        n_pad = pad_to(n, mesh.size)
        rows = Layout(mesh, n_pad, True)
        for step in range(nsquare):
            if step == nsquare - 1:
                pat = _pattern_csr(mask, (n_pad, n_pad))
            else:
                pm = _pattern_csr(M)
                pat = _pattern_csr(pm @ pm, (n_pad, n_pad))
            M_s = upload_rows(M, rows, n_pad)
            out = mm(M_s, M_s, _pattern_rows(pat, rows, np.float32))
            M = host_values(out)[:n, :n].tocsr()
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
                            axis_name: str = "rows",
                            strength=("classical", {"theta": 0.25}),
                            CF="RS", interpolation="direct",
                            smoother=("multicolor_gauss_seidel",
                                      {"iterations": 1,
                                       "sweep": "symmetric"}),
                            dtype=None, max_levels=10, max_coarse=500,
                            spgemm="auto", device="cuda"):
    """Ruge-Stuben setup with the numeric phase on the device, row-sharded
    over a mesh of ranks.

    Arguments as in the JAX package.  ``mesh``: a :class:`~.mesh.Mesh`;
    by default :func:`~.mesh.make_mesh` over the process group's ranks
    (or its first ``n_devices``), and without a group one rank on
    ``device``.  ``strength``: "classical", "symmetric", "evolution" (its
    squarings over the ranks) or None; ``CF``: "RS", "PMIS", "PMISc",
    "CLJP", "CLJPc" or "MIS"; ``interpolation``: "direct" or "standard".
    ``spgemm="auto"`` runs every masked product on the hand-written
    kernels (in plain PyTorch on a CPU device); ``"xla"`` runs the plain
    form ``masked_spgemm_ell`` on any device.  ``dtype`` (default
    float32) is the type of the host operators and of every device
    array.  Returns a
    :class:`~pyamg_tpu_torch.parallel.sharding.ShardedSolver`."""
    from ..classical import split as split_mod
    from ..strength import (classical_strength_of_connection,
                            evolution_strength_of_connection,
                            symmetric_strength_of_connection)

    mesh = _setup_mesh(mesh, n_devices, axis_name, device)
    nd = mesh.size
    dt = np.dtype(dtype or np.float32)
    if spgemm not in ("auto", "xla"):
        raise ValueError(f"spgemm must be 'auto' or 'xla'; got {spgemm!r}")

    def mm(A_s, B_s, pattern_s):
        # the module's names are looked up at each call, so that a wrapper
        # a caller puts in their place sees every product
        return masked_spgemm_mesh(
            A_s, B_s, pattern_s, product=masked_spgemm_auto
            if spgemm == "auto" else masked_spgemm_ell)

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
                A_h, _masked_power_impl=_mesh_masked_power(mm, mesh),
                **s_kw)
        return A_h.copy()

    def slab(Q, vals, rows, width, fill):
        """This rank's rows of per-entry values of the CSR Q."""
        full = _slab_from_csr(Q, vals, rows.n, width, fill)
        return torch.as_tensor(full[rows.start:rows.start + rows.nl],
                               device=mesh.device)

    def slot_map(enc, rows, width):
        return slab(enc, enc.data.astype(np.int64) - 2, rows, width, -2)

    def width(Q):
        return max(1, int(np.diff(Q.indptr).max()) if Q.shape[0] else 0)

    A_host = sp.csr_matrix(A).astype(dt)
    A_host.sort_indices()
    n_orig = A_host.shape[0]

    levels, sizes = [], []
    while len(levels) < max_levels - 1 and A_host.shape[0] > max_coarse:
        n = A_host.shape[0]
        n_pad = pad_to(n, nd)
        rows = Layout(mesh, n_pad, True)

        # ---- host: integer graph stage (the same on every rank) --------
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
        nc_pad = pad_to(ncp, nd)
        crows = Layout(mesh, nc_pad, True)

        # ---- device: numeric stage on this rank's rows --------------------
        A_s = upload_rows(A_host, rows, n_pad, dt)
        Ad, Ac, valid = A_s.data, A_s.ell.cols, A_s.valid_mask()
        row0 = rows.start
        wA = A_s.ell.width

        if i_name == "direct":
            strong = slab(A_host, strongC_e, rows, wA, False).bool()
            W = _direct_interp_slab(Ad, Ac, valid, strong, row0)
            selF = strongC_e & (splitting[rowsA] == 0)
            P_enc = _enc_csr(
                np.concatenate([rowsA[selF], cpts]),
                np.concatenate([cmap[A_host.indices[selF]], cmap[cpts]]),
                np.concatenate([slotsA[selF],
                                np.full(cpts.size, -1, np.int64)]),
                (n, ncp))
            patP = _pattern_csr(P_enc, (n_pad, nc_pad))
            P_data = _gather_slots(W, slot_map(P_enc, rows, width(patP)))
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
            patSF = _pattern_csr(SF_enc, (n_pad, n_pad))
            patSC_s = _pattern_rows(patSC, rows, dt)
            patSF_s = _pattern_rows(patSF, rows, dt)
            patSCT_s = _pattern_rows(_pattern_csr(patSC.T, (n_pad, n_pad)),
                                     rows, dt)

            SCd = _gather_slots(Ad, slot_map(SC_enc, rows, width(patSC)),
                                identity=0.0)
            SFd = _gather_slots(Ad, slot_map(SF_enc, rows, width(patSF)),
                                identity=0.0)
            SC_s = patSC_s.with_data(SCd)
            Pind = patSC_s.with_data(patSC_s.valid_mask().to(SCd.dtype))
            denom = mm(Pind, transpose_onto_mesh(SC_s, patSCT_s), patSF_s)
            Bd, lump = _std_distribute(SFd, denom.data,
                                       patSF_s.valid_mask())
            contrib = mm(patSF_s.with_data(Bd), SC_s, patSC_s)
            w = SCd + contrib.data
            diag = _std_diag(Ad, Ac, valid, SCd, SFd, lump, row0)

            rows_sc = np.repeat(np.arange(n), np.diff(SC_enc.indptr))
            keepP = splitting[rows_sc] == 0
            P_enc = _enc_csr(
                np.concatenate([rows_sc[keepP], cpts]),
                np.concatenate([cmap[SC_enc.indices[keepP]], cmap[cpts]]),
                np.concatenate([_slot_positions(SC_enc)[keepP],
                                np.full(cpts.size, -1, np.int64)]),
                (n, ncp))
            patP = _pattern_csr(P_enc, (n_pad, nc_pad))
            P_data = _std_final_P(w, diag, slot_map(P_enc, rows,
                                                    width(patP)))

        P_s = _pattern_rows(patP, rows, dt).with_data(P_data)

        # ---- Galerkin triple product over the ranks -----------------------
        patA = _pattern_csr(A_host, (n_pad, n_pad))
        patR = _pattern_csr(patP.T)
        patAP = _pattern_csr(patA @ patP)
        R_s = transpose_onto_mesh(P_s, _pattern_rows(patR, crows, dt))
        AP = mm(A_s, P_s, _pattern_rows(patAP, rows, dt))
        Ac_s = mm(R_s, AP, _pattern_rows(_pattern_csr(patR @ patAP), crows,
                                         dt))

        # ---- the one numeric read-back: coarse values for the next level
        Ac_host = host_values(Ac_s)[:ncp, :ncp].tocsr()
        Ac_host.eliminate_zeros()
        Ac_host.sort_indices()

        lvl = _level(A_host, operator(A_s, rows), P_s, R_s, rows, crows,
                     splitting=splitting)
        lvl.presmoother = lvl.postsmoother = _ell_smoother(
            sm_name, sm_kw, patA[:n, :n].tocsr(), _dinv(A_s.diagonal()),
            rows, dt)
        levels.append(lvl)
        sizes.append(n_pad)
        if Ac_host.shape[0] == n:
            break                                  # coarsening stalled
        A_host = Ac_host

    return _with_coarsest(levels, sizes, A_host, mesh, n_orig, dt)
