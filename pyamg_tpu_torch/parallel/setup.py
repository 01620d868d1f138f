"""General (unstructured-capable) smoothed-aggregation setup with its
numeric phase on the device.

Port of ``general_sa_setup_sharded`` from ``pyamg_tpu/parallel/setup.py``
on one device.  The host keeps the integer graph stages (strength,
aggregation, the tentative fit, the graph coloring and the symbolic
product patterns, in numpy/scipy); the device runs every O(nnz)
floating-point stage over padded-ELL slabs: rho(D^-1 A) by power
iteration, the Jacobi smoothing values S = I - (omega/rho) D^-1 A, the
masked products P = S T, A P and R (A P) on the hand-written kernels
(``sparse/spgemm_device.masked_spgemm_auto``), and R = P^T onto its
host-symbolic pattern.  Per level the host reads back one numeric array:
the coarse operator's values, which the next level's strength needs.

Examples
--------
>>> import numpy as np
>>> from pyamg_tpu_torch.gallery import poisson
>>> from pyamg_tpu_torch.parallel import general_sa_setup_sharded
>>> A = poisson((12, 12), format='csr')
>>> sol = general_sa_setup_sharded(A, max_coarse=20, device="cpu")
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
from ..sparse.ell import SparseELL, ell_matvec
from ..sparse.spgemm_device import ell_transpose_onto, masked_spgemm_auto
from ..util.utils import not_ported, unpack_arg
from .sharding import ShardedSolver, _pad_ell, pad_to

__all__ = ["general_sa_setup_sharded", "rootnode_setup_sharded",
           "adaptive_sa_setup_sharded"]

_DISTRIBUTED = "the distributed path"


def _ell_power_rho(data, cols, dinv, v0, n_iter=30):
    """rho(D^-1 A) by ``n_iter`` steps of power iteration on the ELL
    operator, from ``v0`` (the Jacobi smoothing weight's estimate)."""
    v, lam = v0, torch.ones((), dtype=v0.dtype, device=v0.device)
    for _ in range(n_iter):
        w = dinv * ell_matvec(data, cols, v)
        lam = torch.linalg.vector_norm(w)
        v = w / torch.clamp(lam, min=1e-30)
    return lam


def _jacobi_smoothing_vals(Ad, Ac, valid, c):
    """Value slab of S = I - c D^-1 A on A's own ELL structure, and D^-1
    (0 where the diagonal is 0)."""
    rows = torch.arange(Ad.shape[0], dtype=Ac.dtype, device=Ac.device)
    isdiag = valid & (Ac == rows[:, None])
    diag = torch.where(isdiag, Ad, 0).sum(dim=1)
    dinv = torch.where(diag != 0, 1.0 / torch.where(diag != 0, diag, 1), 0)
    S = (-c) * dinv[:, None] * Ad
    return torch.where(isdiag, S + 1.0, S), dinv


def _pattern_csr(X, shape=None):
    """The sparsity pattern of X (values 1.0, sorted indices), resized to
    ``shape`` when given."""
    Xp = sp.csr_matrix(X).copy()
    Xp.data = np.ones_like(Xp.data, dtype=np.float64)
    if shape is not None and shape != Xp.shape:
        Xp.resize(shape)
    Xp.sort_indices()
    return Xp


def _galerkin_patterns(patA, patT):
    """Host-symbolic patterns of P = S T (S on A's pattern), R = P^T, A P
    and R (A P)."""
    patP = _pattern_csr(patA @ patT)
    patR = _pattern_csr(patP.T)
    patAP = _pattern_csr(patA @ patP)
    return patP, patR, patAP, _pattern_csr(patR @ patAP)


def _ensure_stored_diagonal(M):
    """M with an explicit zero stored on every missing diagonal entry.

    The device smoothing values place the identity of S = I - c D^-1 A at
    stored diagonal slots only: a missing slot would zero that row of P
    where the serial setup keeps P = T.  An explicit zero gives dinv = 0
    and an S row e_i, the serial semantics."""
    rows = np.repeat(np.arange(M.shape[0]), np.diff(M.indptr))
    has = np.zeros(M.shape[0], dtype=bool)
    has[rows[M.indices == rows]] = True
    if has.all():
        return M
    miss = np.flatnonzero(~has)
    coo = M.tocoo()
    return sp.coo_matrix(
        (np.concatenate([coo.data, np.zeros(miss.size, dtype=M.dtype)]),
         (np.concatenate([coo.row, miss]), np.concatenate([coo.col, miss]))),
        shape=M.shape).tocsr()            # coo->csr keeps explicit zeros


def _ell_smoother(sm_name, sm_kw, A_pat_csr, dinv, n_pad, dt, device):
    """SmootherData of a padded-ELL level: Jacobi, or multicolor
    Gauss-Seidel with masks from a host coloring of A's pattern."""
    from ..relaxation.smoothing import _color_masks

    if sm_name == "jacobi":
        return SmootherData(kind="jacobi", dinv=dinv,
                            omega=float(sm_kw.get("omega", 1.0)),
                            iterations=int(sm_kw.get("iterations", 1)))
    masks = _color_masks(A_pat_csr, dtype=dt)
    m = np.zeros((masks.shape[0], n_pad), dtype=masks.dtype)
    m[:, :masks.shape[1]] = masks
    return SmootherData(kind="multicolor_gauss_seidel", dinv=dinv,
                        color_masks=torch.as_tensor(m, device=device),
                        iterations=int(sm_kw.get("iterations", 1)),
                        sweep=sm_kw.get("sweep", "symmetric"))


def general_sa_setup_sharded(A, B=None, mesh=None, n_devices=None,
                             strength=("symmetric", {"theta": 0.0}),
                             aggregate="standard", omega=4.0 / 3.0,
                             smooth=("jacobi", {}),
                             max_levels=10, max_coarse=100,
                             smoother=("multicolor_gauss_seidel",
                                       {"iterations": 1,
                                        "sweep": "symmetric"}),
                             dtype=None, rho_iters=30, device="cuda"):
    """Smoothed-aggregation setup with the numeric phase on ``device``.

    Arguments as in the JAX package, on one device (``mesh=None``,
    ``n_devices`` None or 1).  The masked products run on the
    hand-written kernels (in plain PyTorch on a CPU device).  ``dtype``
    (default float32) is the type of every device array.  Returns a
    :class:`~pyamg_tpu_torch.parallel.sharding.ShardedSolver`."""
    from ..aggregation.aggregate import naive_aggregation, \
        standard_aggregation
    from ..aggregation.tentative import fit_candidates
    from ..strength import (classical_strength_of_connection,
                            symmetric_strength_of_connection)

    if mesh is not None or n_devices not in (None, 1):
        raise not_ported("a setup over a mesh of several devices",
                         _DISTRIBUTED)
    nd = 1
    dt = np.dtype(dtype or np.float32)

    s_name, s_kw = unpack_arg(strength)
    agg_name, agg_kw = unpack_arg(aggregate)
    p_name, _ = unpack_arg(smooth)
    sm_name, sm_kw = unpack_arg(smoother)
    if p_name == "energy":
        raise not_ported("smooth='energy' in the device setup", _DISTRIBUTED)
    if p_name != "jacobi":
        raise ValueError("the device setup supports smooth in ('jacobi', "
                         f"'energy'); got {p_name!r}")
    if sm_name not in ("jacobi", "multicolor_gauss_seidel"):
        raise ValueError("the device setup supports smoother in ('jacobi', "
                         f"'multicolor_gauss_seidel'); got {sm_name!r}")
    if agg_name not in ("standard", "naive"):
        raise ValueError("the device setup supports aggregate in "
                         f"('standard', 'naive'); got {agg_name!r}")
    if s_name not in ("symmetric", "classical", None):
        raise ValueError(f"unsupported strength {s_name!r} for the device "
                         "setup")
    strength_fn = classical_strength_of_connection \
        if s_name == "classical" else symmetric_strength_of_connection
    agg_fn = standard_aggregation if agg_name == "standard" \
        else naive_aggregation

    def ell(M, rows=None, cols=None):
        E = SparseELL.from_scipy(M, dtype=dt, device=device)
        return E if rows is None else _pad_ell(E, rows, cols)

    A_host = _ensure_stored_diagonal(sp.csr_matrix(A).astype(dt))
    A_host.sort_indices()
    n_orig = A_host.shape[0]
    Bcur = (np.ones((n_orig, 1), dtype=dt) if B is None
            else np.asarray(B, dtype=dt).reshape(n_orig, -1))

    levels, sizes = [], []
    while len(levels) < max_levels - 1 and A_host.shape[0] > max_coarse:
        n = A_host.shape[0]
        n_pad = pad_to(n, nd)

        # ---- host: integer graph stage ---------------------------------
        C = strength_fn(A_host, **s_kw) if s_name else A_host
        AggOp, _roots = agg_fn(C, **agg_kw)
        if AggOp.shape[1] == 0:
            break
        T, Bc = fit_candidates(AggOp, Bcur)
        T = sp.csr_matrix(T).astype(dt)
        nc = T.shape[1]
        nc_pad = pad_to(max(nc, 1), nd)
        patA = _pattern_csr(A_host, (n_pad, n_pad))

        # ---- device: numeric stage ---------------------------------------
        A_ell = ell(A_host, n_pad, n_pad)
        d = A_ell.diagonal()          # padded rows: 0 -> dinv 0 -> inert
        dinv = torch.where(d != 0, 1.0 / torch.where(d != 0, d, 1), 0)
        v0 = torch.as_tensor(np.sin(np.arange(1, n_pad + 1)), device=device)
        rho = float(_ell_power_rho(A_ell.data, A_ell.cols, dinv,
                                   v0.to(A_ell.dtype), n_iter=rho_iters))
        S_data, dinv = _jacobi_smoothing_vals(
            A_ell.data, A_ell.cols, A_ell.valid_mask(),
            torch.tensor(omega / max(rho, 1e-30), dtype=A_ell.dtype,
                         device=device))
        S_ell = SparseELL(S_data, A_ell.cols, A_ell.row_nnz, A_ell.shape)
        patP, patR, patAP, patAc = _galerkin_patterns(
            patA, _pattern_csr(T, (n_pad, nc_pad)))

        P_ell = masked_spgemm_auto(S_ell, ell(T, n_pad, nc_pad), ell(patP))
        R_ell = ell_transpose_onto(P_ell, ell(patR))
        AP = masked_spgemm_auto(A_ell, P_ell, ell(patAP))
        Ac_ell = masked_spgemm_auto(R_ell, AP, ell(patAc))

        # ---- the one numeric read-back: coarse values for the next level
        Ac_host = Ac_ell.to_scipy()[:nc, :nc].tocsr()
        Ac_host.eliminate_zeros()
        Ac_host.sort_indices()

        lvl = Level(A_csr=A_host, A=A_ell, P=P_ell, R=R_ell)
        sm = _ell_smoother(sm_name, sm_kw, patA[:n, :n].tocsr(), dinv,
                           n_pad, dt, device)
        lvl.presmoother = lvl.postsmoother = sm
        levels.append(lvl)
        sizes.append(n_pad)

        # eliminate_zeros above can drop an exactly-zero coarse diagonal;
        # the next level's smoothing values need the slot stored
        Ac_host = _ensure_stored_diagonal(Ac_host)
        Ac_host.sort_indices()
        A_host, Bcur = Ac_host, Bc

    # coarsest level: solved by the padded dense pseudoinverse
    n_pad = pad_to(A_host.shape[0], nd)
    last = Level(A_csr=A_host, A=ell(A_host, n_pad, n_pad))
    last.presmoother = last.postsmoother = SmootherData(kind="none")
    levels.append(last)
    sizes.append(n_pad)
    return ShardedSolver.from_sharded_levels(levels, sizes, n_orig, device)


def rootnode_setup_sharded(*args, **kwargs):
    """Root-node SA setup with a device numeric phase: not ported yet."""
    raise not_ported("rootnode_setup_sharded", "the other constructors")


def adaptive_sa_setup_sharded(*args, **kwargs):
    """Adaptive SA setup with a device numeric phase: not ported yet."""
    raise not_ported("adaptive_sa_setup_sharded", "the other constructors")
