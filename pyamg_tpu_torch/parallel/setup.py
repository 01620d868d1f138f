"""Smoothed-aggregation setups with their numeric phase on the device.

Port of ``pyamg_tpu/parallel/setup.py``.

* ``structured_sa_setup_sharded``: the structured SA setup of
  ``aggregation/device_setup.py`` (every numeric step on the device, the
  Galerkin product by comb probes), over a mesh of ranks.
* ``general_sa_setup_sharded``: the host keeps the integer graph stages
  (strength, aggregation, the tentative fit, the graph coloring and the
  symbolic product patterns, in numpy/scipy); the device runs every
  O(nnz) floating-point stage over padded-ELL slabs: rho(D^-1 A) by power
  iteration, the Jacobi smoothing values S = I - (omega/rho) D^-1 A or the
  energy-minimization CG (``parallel/energy.py``), the masked products
  P = S T, A P and R (A P) on the hand-written kernels
  (``sparse/spgemm_device.masked_spgemm_auto``), and R = P^T onto its
  host-symbolic pattern.  Per level the host reads back one numeric array:
  the coarse operator's values, which the next level's strength needs.
* ``rootnode_setup_sharded``: the same split for root-node SA (the host
  adds the root selection, ``get_Cpt_params`` and ``scale_T``; the device
  runs the root-constrained energy CG and the Galerkin product).
* ``adaptive_sa_setup_sharded``: candidate relaxation on the device, then
  the general setup on the relaxed candidates.

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
from .mesh import make_mesh
from .sharding import ShardedSolver, _pad_ell, pad_to

__all__ = ["structured_sa_setup_sharded", "general_sa_setup_sharded",
           "rootnode_setup_sharded", "adaptive_sa_setup_sharded"]

_DISTRIBUTED = "the distributed path"


def _one_device(mesh, n_devices, what):
    """Raise for a setup over several devices (not ported)."""
    if mesh is not None or n_devices not in (None, 1):
        raise not_ported(f"{what} over a mesh of several devices",
                         _DISTRIBUTED)


def structured_sa_setup_sharded(A, grid, mesh=None, n_devices=None,
                                axis_name: str = "rows", device=None, **kw):
    """Structured SA setup with every numeric step on the device, spread
    over a mesh of ranks: :func:`~pyamg_tpu_torch.aggregation.
    device_setup.structured_sa_setup` on ``mesh``, by default the ranks
    of the process group (or its first ``n_devices``; without a group,
    one device: ``device``, "cuda" by default).  The remaining keywords
    are its own."""
    from ..aggregation.device_setup import structured_sa_setup

    if mesh is None:
        mesh = make_mesh(n_devices, axis_name, device=device)
    return structured_sa_setup(A, grid, mesh=mesh, **kw)


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


def _transfer_patterns(patA, patP):
    """Host-symbolic patterns of R = P^T, A P and R (A P)."""
    patR = _pattern_csr(patP.T)
    patAP = _pattern_csr(patA @ patP)
    return patR, patAP, _pattern_csr(patR @ patAP)


def _galerkin_patterns(patA, patT):
    """Host-symbolic patterns of P = S T (S on A's pattern), R = P^T, A P
    and R (A P)."""
    patP = _pattern_csr(patA @ patT)
    return (patP,) + _transfer_patterns(patA, patP)


def _energy_kw(p_kw):
    """``energy_smooth_sharded``'s keywords from a ``smooth=('energy',
    {...})`` option, with the JAX package's defaults."""
    return dict(degree=int(p_kw.get("degree", 1)),
                maxiter=int(p_kw.get("maxiter", 4)),
                tol=float(p_kw.get("tol", 1e-8)),
                weighting=p_kw.get("weighting", "local"))


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


def _graph_stages(strength, aggregate):
    """``(strength_of, aggregate_of)``: the host graph stages that the
    ``strength`` and ``aggregate`` options of a device SA setup name."""
    from ..aggregation.aggregate import naive_aggregation, \
        standard_aggregation
    from ..strength import (classical_strength_of_connection,
                            symmetric_strength_of_connection)

    s_name, s_kw = unpack_arg(strength)
    agg_name, agg_kw = unpack_arg(aggregate)
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
    return ((lambda A: strength_fn(A, **s_kw) if s_name else A),
            (lambda C: agg_fn(C, **agg_kw)))


def _ell_maker(dt, device):
    """``ell(M, rows=None, cols=None)``: a scipy matrix as a ``dt``
    padded ELL on ``device``, padded to ``(rows, cols)`` when given."""
    def ell(M, rows=None, cols=None):
        E = SparseELL.from_scipy(M, dtype=dt, device=device)
        return E if rows is None else _pad_ell(E, rows, cols)
    return ell


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
    ``n_devices`` None or 1).  ``smooth``: ``"jacobi"`` or ``("energy",
    {"degree", "maxiter", "tol", "weighting"})``, the energy CG on the
    device (``parallel/energy.py``).  The masked products run on the
    hand-written kernels (in plain PyTorch on a CPU device).  ``dtype``
    (default float32) is the type of every device array.  Returns a
    :class:`~pyamg_tpu_torch.parallel.sharding.ShardedSolver`."""
    from ..aggregation.tentative import fit_candidates

    _one_device(mesh, n_devices, "general_sa_setup_sharded")
    nd = 1
    dt = np.dtype(dtype or np.float32)

    p_name, p_kw = unpack_arg(smooth)
    sm_name, sm_kw = unpack_arg(smoother)
    if p_name not in ("jacobi", "energy"):
        raise ValueError("the device setup supports smooth in ('jacobi', "
                         f"'energy'); got {p_name!r}")
    if sm_name not in ("jacobi", "multicolor_gauss_seidel"):
        raise ValueError("the device setup supports smoother in ('jacobi', "
                         f"'multicolor_gauss_seidel'); got {sm_name!r}")
    strength_of, aggregate_of = _graph_stages(strength, aggregate)
    ell = _ell_maker(dt, device)

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
        C = strength_of(A_host)
        AggOp, _roots = aggregate_of(C)
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
        if p_name == "energy":
            from .energy import energy_smooth_sharded

            P_ell, patP = energy_smooth_sharded(
                A_ell, T, C, Bc, dt=dt, **_energy_kw(p_kw))
            patR, patAP, patAc = _transfer_patterns(
                patA, _pattern_csr(patP, (n_pad, nc_pad)))
        else:
            v0 = torch.as_tensor(np.sin(np.arange(1, n_pad + 1)),
                                 device=device)
            rho = float(_ell_power_rho(A_ell.data, A_ell.cols, dinv,
                                       v0.to(A_ell.dtype), n_iter=rho_iters))
            S_data, dinv = _jacobi_smoothing_vals(
                A_ell.data, A_ell.cols, A_ell.valid_mask(),
                torch.tensor(omega / max(rho, 1e-30), dtype=A_ell.dtype,
                             device=device))
            S_ell = SparseELL(S_data, A_ell.cols, A_ell.row_nnz, A_ell.shape)
            patP, patR, patAP, patAc = _galerkin_patterns(
                patA, _pattern_csr(T, (n_pad, nc_pad)))
            P_ell = masked_spgemm_auto(S_ell, ell(T, n_pad, nc_pad),
                                       ell(patP))
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

    return _with_coarsest(levels, sizes, A_host, nd, n_orig, ell, device)


def rootnode_setup_sharded(A, B=None, mesh=None, n_devices=None,
                           axis_name: str = "rows",
                           strength=("symmetric", {"theta": 0.0}),
                           aggregate="standard",
                           smooth=("energy", {}),
                           max_levels=10, max_coarse=100,
                           smoother=("multicolor_gauss_seidel",
                                     {"iterations": 1,
                                      "sweep": "symmetric"}),
                           dtype=None, device="cuda"):
    """Root-node SA setup with the numeric phase on ``device``.

    The host-integer / device-numeric split of
    :func:`general_sa_setup_sharded`, applied to root-node SA: the host
    keeps strength, aggregation with its roots, the tentative fit,
    ``get_Cpt_params``/``scale_T`` and the injected coarse candidates; the
    device runs the root-constrained energy CG (``parallel/energy.py``,
    with the F-row mask and the C-point identity block of ``Cpt_params``)
    and the Galerkin product.  Scalar operators; ``smooth`` must be
    ``'energy'``, as in the JAX package.  Arguments as there, on one
    device; returns a :class:`~pyamg_tpu_torch.parallel.sharding.
    ShardedSolver`."""
    from ..aggregation.tentative import fit_candidates
    from ..util.utils import get_Cpt_params, scale_T
    from .energy import energy_smooth_sharded

    _one_device(mesh, n_devices, "rootnode_setup_sharded")
    nd = 1
    dt = np.dtype(dtype or np.float32)

    p_name, p_kw = unpack_arg(smooth)
    if p_name != "energy":
        raise ValueError("rootnode requires the 'energy' prolongation "
                         f"smoother (got {p_name!r})")
    sm_name, sm_kw = unpack_arg(smoother)
    strength_of, aggregate_of = _graph_stages(strength, aggregate)
    ell = _ell_maker(dt, device)

    A_host = sp.csr_matrix(A).astype(dt)
    A_host.sort_indices()
    n_orig = A_host.shape[0]
    Bcur = (np.ones((n_orig, 1), dtype=dt) if B is None
            else np.asarray(B, dtype=dt).reshape(n_orig, -1))

    levels, sizes = [], []
    while len(levels) < max_levels - 1 and A_host.shape[0] > max_coarse:
        n = A_host.shape[0]
        n_pad = pad_to(n, nd)

        # ---- host: integer graph stage ---------------------------------
        C = strength_of(A_host)
        AggOp, Cnodes = aggregate_of(sp.csr_matrix(C))
        if AggOp.shape[1] == 0 or Cnodes is None:
            break
        T, _ = fit_candidates(AggOp, Bcur[:, :1])
        Cpt_params = get_Cpt_params(A_host, np.asarray(Cnodes), AggOp,
                                    sp.csr_matrix(T))
        T = scale_T(sp.csr_matrix(T), Cpt_params["P_I"], Cpt_params["I_F"])
        B_coarse = np.asarray(Cpt_params["P_I"].T @ Bcur)
        fmask = np.asarray(
            sp.csr_matrix(Cpt_params["I_F"]).diagonal()).real != 0
        nc = T.shape[1]
        nc_pad = pad_to(max(nc, 1), nd)

        # ---- device: numeric stage ---------------------------------------
        A_ell = ell(A_host, n_pad, n_pad)
        d = A_ell.diagonal()
        dinv = torch.where(d != 0, 1.0 / torch.where(d != 0, d, 1), 0)
        P_ell, patP = energy_smooth_sharded(
            A_ell, sp.csr_matrix(T), sp.csr_matrix(C), B_coarse, dt=dt,
            fmask_host=fmask, PI_host=Cpt_params["P_I"], **_energy_kw(p_kw))
        patA = _pattern_csr(A_host, (n_pad, n_pad))
        patR, patAP, patAc = _transfer_patterns(
            patA, _pattern_csr(patP, (n_pad, nc_pad)))
        R_ell = ell_transpose_onto(P_ell, ell(patR))
        AP = masked_spgemm_auto(A_ell, P_ell, ell(patAP))
        Ac_ell = masked_spgemm_auto(R_ell, AP, ell(patAc))

        Ac_host = Ac_ell.to_scipy()[:nc, :nc].tocsr()
        Ac_host.eliminate_zeros()
        Ac_host.sort_indices()

        lvl = Level(A_csr=A_host, A=A_ell, P=P_ell, R=R_ell,
                    Cpts=Cpt_params["Cpts"])
        sm = _ell_smoother(sm_name, sm_kw, patA[:n, :n].tocsr(), dinv,
                           n_pad, dt, device)
        lvl.presmoother = lvl.postsmoother = sm
        levels.append(lvl)
        sizes.append(n_pad)

        if Ac_host.shape[0] == n:
            break
        # the JAX package's stored-zero diagonal (scipy's sum drops the
        # zeros it adds, so a missing diagonal stays missing)
        has = Ac_host.diagonal() != 0
        if not has.all():
            Ac_host = Ac_host + sp.diags((~has).astype(dt) * 0.0)
            Ac_host = Ac_host.tocsr()
        A_host, Bcur = Ac_host, B_coarse

    return _with_coarsest(levels, sizes, A_host, nd, n_orig, ell, device)


def _with_coarsest(levels, sizes, A_host, nd, n_orig, ell, device):
    """Append the coarsest level (solved by the padded dense
    pseudoinverse) and assemble the solver."""
    n_pad = pad_to(A_host.shape[0], nd)
    last = Level(A_csr=A_host, A=ell(A_host, n_pad, n_pad))
    last.presmoother = last.postsmoother = SmootherData(kind="none")
    return ShardedSolver.from_sharded_levels(
        levels + [last], sizes + [n_pad], n_orig, device)


def _mesh_candidate_relax(Ad, Ac, dinv, x, omega, sweeps=8):
    """Weighted-Jacobi candidate relaxation on A x = 0, each sweep
    renormalized so that strong sweeps cannot underflow x to 0."""
    for _ in range(int(sweeps)):
        x = x - omega * dinv * ell_matvec(Ad, Ac, x)
        x = x / torch.clamp(torch.linalg.vector_norm(x), min=1e-30)
    return x


def adaptive_sa_setup_sharded(A, mesh=None, n_devices=None,
                              axis_name: str = "rows",
                              num_candidates=1, candidate_iters=8,
                              omega=2.0 / 3.0, max_levels=10,
                              max_coarse=100, dtype=None, seed=0,
                              device="cuda", **kw):
    """Adaptive SA setup with the numeric phase on ``device``.

    The initial stage of adaptive SA: ``candidate_iters`` weighted-Jacobi
    sweeps on A x = 0 from ``np.random.default_rng(seed)``'s uniform start
    in [-0.5, 0.5) (the JAX package's numbers), renormalized every sweep,
    with rho(D^-1 A) from 20 power steps started at the first candidate;
    then :func:`general_sa_setup_sharded` on the relaxed candidates, with
    the remaining keywords.  Arguments as in the JAX package, on one
    device."""
    _one_device(mesh, n_devices, "adaptive_sa_setup_sharded")
    dt = np.dtype(dtype or np.float32)

    A_host = sp.csr_matrix(A).astype(dt)
    A_host.sort_indices()
    n = A_host.shape[0]
    A_ell = SparseELL.from_scipy(A_host, dtype=dt, device=device)
    d = A_ell.diagonal()
    dinv = torch.where(d != 0, 1.0 / torch.where(d != 0, d, 1), 0)

    rng = np.random.default_rng(seed)
    cands = []
    rho = None
    for _ in range(max(1, int(num_candidates))):
        x = torch.as_tensor(rng.random(n).astype(dt) - 0.5, device=device)
        if rho is None:
            rho = float(_ell_power_rho(A_ell.data, A_ell.cols, dinv, x,
                                       n_iter=20))
        x = _mesh_candidate_relax(
            A_ell.data, A_ell.cols, dinv, x,
            torch.tensor(omega / max(rho, 1e-30), dtype=A_ell.dtype,
                         device=device),
            sweeps=int(candidate_iters))
        cands.append(x.cpu().numpy())
    Bcur = np.column_stack(cands).astype(dt)

    return general_sa_setup_sharded(A_host, B=Bcur, max_levels=max_levels,
                                    max_coarse=max_coarse, dtype=dt,
                                    device=device, **kw)
