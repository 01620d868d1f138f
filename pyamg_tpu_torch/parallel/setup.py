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
from ..sparse.spgemm_device import masked_spgemm_auto
from ..util import profiling
from ..util.utils import unpack_arg
from .mesh import Layout, make_mesh
from .products import (host_values, masked_spgemm_mesh, operator,
                       transpose_onto_mesh, upload_rows, vector_norm)
from .sharding import ShardedSolver, _check_mesh, pad_to

__all__ = ["structured_sa_setup_sharded", "general_sa_setup_sharded",
           "rootnode_setup_sharded", "adaptive_sa_setup_sharded"]


def _setup_mesh(mesh, n_devices, axis_name, device):
    """The mesh a setup runs on: ``mesh`` (a :class:`~.mesh.Mesh`), else
    :func:`~.mesh.make_mesh` over the process group's ranks (or its first
    ``n_devices``; without a group, one rank on ``device``)."""
    if mesh is None:
        mesh = make_mesh(n_devices, axis_name, device=device)
    return _check_mesh(mesh)


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


def _ell_power_rho(A_op, dinv, v0, rows, n_iter=30):
    """rho(D^-1 A) by ``n_iter`` steps of power iteration on this rank's
    rows of the operator ``A_op``, from ``v0`` (this rank's rows; the
    Jacobi smoothing weight's estimate), the norms summed over the
    ranks."""
    v, lam = v0, torch.ones((), dtype=v0.dtype, device=v0.device)
    for _ in range(n_iter):
        w = dinv * A_op.matvec(v)
        lam = vector_norm(w, rows)
        v = w / torch.clamp(lam, min=1e-30)
    return lam


def _jacobi_smoothing_vals(Ad, Ac, valid, c, row0=0):
    """Value slab of S = I - c D^-1 A on A's own ELL structure, and D^-1
    (0 where the diagonal is 0); the slab's rows are rows ``row0 ..`` of
    A, its columns global."""
    rows = torch.arange(row0, row0 + Ad.shape[0], dtype=Ac.dtype,
                        device=Ac.device)
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


def _ell_smoother(sm_name, sm_kw, A_pat_csr, dinv, rows, dt):
    """SmootherData of a padded-ELL level on this rank's rows: Jacobi, or
    multicolor Gauss-Seidel with masks from a host coloring of A's
    pattern (every rank colors the whole pattern and keeps its rows)."""
    from ..relaxation.smoothing import _color_masks

    if sm_name == "jacobi":
        return SmootherData(kind="jacobi", dinv=dinv,
                            omega=float(sm_kw.get("omega", 1.0)),
                            iterations=int(sm_kw.get("iterations", 1)))
    with profiling.span("coloring", host=True):
        masks = _color_masks(A_pat_csr, dtype=dt)
        m = np.zeros((masks.shape[0], rows.n), dtype=masks.dtype)
        m[:, :masks.shape[1]] = masks
        m = m[:, rows.start:rows.start + rows.nl]
    return SmootherData(kind="multicolor_gauss_seidel", dinv=dinv,
                        color_masks=torch.as_tensor(
                            np.ascontiguousarray(m), device=dinv.device),
                        iterations=int(sm_kw.get("iterations", 1)),
                        sweep=sm_kw.get("sweep", "symmetric"))


def _dinv(d):
    return torch.where(d != 0, 1.0 / torch.where(d != 0, d, 1), 0)


def _pattern_rows(pattern, rows, dt):
    """This rank's rows of an output pattern (values unused)."""
    return upload_rows(pattern, rows, dtype=dt, values=False)


def _galerkin(A_s, P_s, patterns, rows, crows, nc, dt):
    """R = P^T, A P and R (A P) over the mesh on their host-symbolic
    ``patterns`` (of R, A P and R A P); returns ``(R_s, Ac_host)``, the
    coarse operator read back onto every rank's host (stored zeros
    dropped)."""
    patR, patAP, patAc = patterns
    # the one-device product is this module's name, looked up at each
    # call, so that a wrapper put in its place sees each product
    with profiling.span("galerkin", host=False):
        R_s = transpose_onto_mesh(P_s, _pattern_rows(patR, crows, dt))
        AP = masked_spgemm_mesh(A_s, P_s, _pattern_rows(patAP, rows, dt),
                                product=masked_spgemm_auto)
        Ac_s = masked_spgemm_mesh(R_s, AP, _pattern_rows(patAc, crows, dt),
                                  product=masked_spgemm_auto)
    # the wait for the products, then host work on the coarse operator;
    # the products' device times are read once the wait is over
    with profiling.span("readback", host=None):
        Ac_host = host_values(Ac_s)[:nc, :nc].tocsr()
        profiling.resolve_device_times()
        Ac_host.eliminate_zeros()
        Ac_host.sort_indices()
    return R_s, Ac_host


def _level(A_host, A_op, P_s, R_s, rows, crows, **kw):
    """A level of the solver: the operators over the mesh's layouts
    (whole SparseELLs on a one-rank mesh without a group)."""
    lvl = Level(A_csr=A_host, A=A_op, P=operator(P_s, crows),
                R=operator(R_s, rows), **kw)
    if rows.mesh.distributed:
        lvl.layout = rows
    return lvl


@profiling.setup_spans
def general_sa_setup_sharded(A, B=None, mesh=None, n_devices=None,
                             axis_name: str = "rows",
                             strength=("symmetric", {"theta": 0.0}),
                             aggregate="standard", omega=4.0 / 3.0,
                             smooth=("jacobi", {}),
                             max_levels=10, max_coarse=100,
                             smoother=("multicolor_gauss_seidel",
                                       {"iterations": 1,
                                        "sweep": "symmetric"}),
                             dtype=None, rho_iters=30, device="cuda"):
    """Smoothed-aggregation setup with the numeric phase on the device,
    row-sharded over a mesh of ranks.

    Arguments as in the JAX package.  ``mesh``: a :class:`~.mesh.Mesh`;
    by default :func:`~.mesh.make_mesh` over the process group's ranks
    (or its first ``n_devices``), and without a group one rank on
    ``device``.  Every rank runs the host integer stages on the whole
    matrix and keeps, on its device, its rows of each level's A, S, T, P,
    A P, R and coarse A; the masked products run on the hand-written
    kernels on the rank's slab (``parallel/products.py``; plain PyTorch
    on a CPU device).  ``smooth``: ``"jacobi"`` or ``("energy",
    {"degree", "maxiter", "tol", "weighting"})``, the energy CG over the
    ranks (``parallel/energy.py``).  ``dtype`` (default float32) is the
    type of every device array.  Returns a
    :class:`~pyamg_tpu_torch.parallel.sharding.ShardedSolver`."""
    from ..aggregation.tentative import fit_candidates

    mesh = _setup_mesh(mesh, n_devices, axis_name, device)
    nd = mesh.size
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

    A_host = _ensure_stored_diagonal(sp.csr_matrix(A).astype(dt))
    A_host.sort_indices()
    n_orig = A_host.shape[0]
    Bcur = (np.ones((n_orig, 1), dtype=dt) if B is None
            else np.asarray(B, dtype=dt).reshape(n_orig, -1))

    levels, sizes = [], []
    while len(levels) < max_levels - 1 and A_host.shape[0] > max_coarse:
        n = A_host.shape[0]
        with profiling.span("setup.level", level=len(levels), rows=n):
            n_pad = pad_to(n, nd)
            rows = Layout(mesh, n_pad, True)

            # ---- host: integer graph stage (the same on every rank) ----
            with profiling.span("strength", host=True):
                C = strength_of(A_host)
            with profiling.span("aggregate", host=True):
                AggOp, _roots = aggregate_of(C)
            if AggOp.shape[1] == 0:
                break
            with profiling.span("fit_candidates", host=True):
                T, Bc = fit_candidates(AggOp, Bcur)
                T = sp.csr_matrix(T).astype(dt)
            nc = T.shape[1]
            nc_pad = pad_to(max(nc, 1), nd)
            crows = Layout(mesh, nc_pad, True)
            with profiling.span("patterns", host=True):
                patA = _pattern_csr(A_host, (n_pad, n_pad))
                A_pat = patA[:n, :n].tocsr()
                if p_name != "energy":
                    patP, *patterns = _galerkin_patterns(
                        patA, _pattern_csr(T, (n_pad, nc_pad)))

            # ---- device: numeric stage on this rank's rows ----------------
            with profiling.span("upload", host=False):
                A_s = upload_rows(A_host, rows, n_pad, dt)
                A_op = operator(A_s, rows)
                # padded rows: 0 -> dinv 0 -> inert
                dinv = _dinv(A_s.diagonal())
            if p_name == "energy":
                from .energy import energy_smooth_sharded

                with profiling.span("smooth_p", host=False):
                    P_s, patP = energy_smooth_sharded(
                        A_s, T, C, Bc, mesh=mesh, dt=dt, **_energy_kw(p_kw))
                with profiling.span("patterns", host=True):
                    patterns = _transfer_patterns(
                        patA, _pattern_csr(patP, (n_pad, nc_pad)))
            else:
                lo, hi = rows.start, rows.start + rows.nl
                with profiling.span("rho", host=False):
                    v0 = torch.as_tensor(np.sin(np.arange(lo + 1, hi + 1)),
                                         device=mesh.device)
                    rho = float(_ell_power_rho(A_op, dinv,
                                               v0.to(A_s.data.dtype), rows,
                                               n_iter=rho_iters))
                with profiling.span("smooth_p", host=False):
                    S_data, dinv = _jacobi_smoothing_vals(
                        A_s.data, A_s.ell.cols, A_s.valid_mask(),
                        torch.tensor(omega / max(rho, 1e-30),
                                     dtype=A_s.data.dtype,
                                     device=mesh.device), row0=lo)
                    P_s = masked_spgemm_mesh(
                        A_s.with_data(S_data),
                        upload_rows(T, rows, nc_pad, dt),
                        _pattern_rows(patP, rows, dt),
                        product=masked_spgemm_auto)
            R_s, Ac_host = _galerkin(A_s, P_s, patterns, rows, crows, nc, dt)

            lvl = _level(A_host, A_op, P_s, R_s, rows, crows)
            lvl.presmoother = lvl.postsmoother = _ell_smoother(
                sm_name, sm_kw, A_pat, dinv, rows, dt)
            levels.append(lvl)
            sizes.append(n_pad)

            # eliminate_zeros above can drop an exactly-zero coarse
            # diagonal; the next level's smoothing values need the slot
            # stored
            Ac_host = _ensure_stored_diagonal(Ac_host)
            Ac_host.sort_indices()
            A_host, Bcur = Ac_host, Bc

    return _with_coarsest(levels, sizes, A_host, mesh, n_orig, dt)


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
    """Root-node SA setup with the numeric phase on the device,
    row-sharded over a mesh of ranks.

    The host-integer / device-numeric split of
    :func:`general_sa_setup_sharded`, applied to root-node SA: the host
    keeps strength, aggregation with its roots, the tentative fit,
    ``get_Cpt_params``/``scale_T`` and the injected coarse candidates; the
    ranks run the root-constrained energy CG (``parallel/energy.py``,
    with the F-row mask and the C-point identity block of ``Cpt_params``)
    and the Galerkin product on their rows.  Scalar operators; ``smooth``
    must be ``'energy'``, as in the JAX package.  Arguments as there, the
    mesh as in :func:`general_sa_setup_sharded`; returns a
    :class:`~pyamg_tpu_torch.parallel.sharding.ShardedSolver`."""
    from ..aggregation.tentative import fit_candidates
    from ..util.utils import get_Cpt_params, scale_T
    from .energy import energy_smooth_sharded

    mesh = _setup_mesh(mesh, n_devices, axis_name, device)
    nd = mesh.size
    dt = np.dtype(dtype or np.float32)

    p_name, p_kw = unpack_arg(smooth)
    if p_name != "energy":
        raise ValueError("rootnode requires the 'energy' prolongation "
                         f"smoother (got {p_name!r})")
    sm_name, sm_kw = unpack_arg(smoother)
    strength_of, aggregate_of = _graph_stages(strength, aggregate)

    A_host = sp.csr_matrix(A).astype(dt)
    A_host.sort_indices()
    n_orig = A_host.shape[0]
    Bcur = (np.ones((n_orig, 1), dtype=dt) if B is None
            else np.asarray(B, dtype=dt).reshape(n_orig, -1))

    levels, sizes = [], []
    while len(levels) < max_levels - 1 and A_host.shape[0] > max_coarse:
        n = A_host.shape[0]
        n_pad = pad_to(n, nd)
        rows = Layout(mesh, n_pad, True)

        # ---- host: integer graph stage (the same on every rank) --------
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
        crows = Layout(mesh, nc_pad, True)

        # ---- device: numeric stage on this rank's rows --------------------
        A_s = upload_rows(A_host, rows, n_pad, dt)
        A_op = operator(A_s, rows)
        dinv = _dinv(A_s.diagonal())
        P_s, patP = energy_smooth_sharded(
            A_s, sp.csr_matrix(T), sp.csr_matrix(C), B_coarse, mesh=mesh,
            dt=dt, fmask_host=fmask, PI_host=Cpt_params["P_I"],
            **_energy_kw(p_kw))
        patA = _pattern_csr(A_host, (n_pad, n_pad))
        R_s, Ac_host = _galerkin(
            A_s, P_s,
            _transfer_patterns(patA, _pattern_csr(patP, (n_pad, nc_pad))),
            rows, crows, nc, dt)

        lvl = _level(A_host, A_op, P_s, R_s, rows, crows,
                     Cpts=Cpt_params["Cpts"])
        lvl.presmoother = lvl.postsmoother = _ell_smoother(
            sm_name, sm_kw, patA[:n, :n].tocsr(), dinv, rows, dt)
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

    return _with_coarsest(levels, sizes, A_host, mesh, n_orig, dt)


def _with_coarsest(levels, sizes, A_host, mesh, n_orig, dt):
    """Append the coarsest level (solved by the padded dense
    pseudoinverse, replicated on every rank) and assemble the solver."""
    n_pad = pad_to(A_host.shape[0], mesh.size)
    rows = Layout(mesh, n_pad, True)
    last = Level(A_csr=A_host,
                 A=operator(upload_rows(A_host, rows, n_pad, dt), rows))
    if mesh.distributed:
        last.layout = rows
    last.presmoother = last.postsmoother = SmootherData(kind="none")
    return ShardedSolver.from_sharded_levels(
        levels + [last], sizes + [n_pad], mesh, mesh.axis_name, n_orig)


def _mesh_candidate_relax(A_op, dinv, x, omega, rows, sweeps=8):
    """Weighted-Jacobi candidate relaxation on A x = 0 (this rank's rows),
    each sweep renormalized over the ranks so that strong sweeps cannot
    underflow x to 0."""
    for _ in range(int(sweeps)):
        x = x - omega * dinv * A_op.matvec(x)
        x = x / torch.clamp(vector_norm(x, rows), min=1e-30)
    return x


def adaptive_sa_setup_sharded(A, mesh=None, n_devices=None,
                              axis_name: str = "rows",
                              num_candidates=1, candidate_iters=8,
                              omega=2.0 / 3.0, max_levels=10,
                              max_coarse=100, dtype=None, seed=0,
                              device="cuda", **kw):
    """Adaptive SA setup with the numeric phase on the device,
    row-sharded over a mesh of ranks.

    The initial stage of adaptive SA: ``candidate_iters`` weighted-Jacobi
    sweeps on A x = 0 from ``np.random.default_rng(seed)``'s uniform start
    in [-0.5, 0.5) (the JAX package's numbers; every rank draws the whole
    start and keeps its rows), renormalized every sweep, with rho(D^-1 A)
    from 20 power steps started at the first candidate; the candidates are
    gathered onto every rank's host, then :func:`general_sa_setup_sharded`
    runs on them over the same mesh, with the remaining keywords.
    Arguments as in the JAX package, the mesh as there."""
    mesh = _setup_mesh(mesh, n_devices, axis_name, device)
    dt = np.dtype(dtype or np.float32)

    A_host = sp.csr_matrix(A).astype(dt)
    A_host.sort_indices()
    n = A_host.shape[0]
    n_pad = pad_to(n, mesh.size)
    rows = Layout(mesh, n_pad, True)
    lo, hi = rows.start, rows.start + rows.nl
    A_s = upload_rows(A_host, rows, n_pad, dt)
    A_op = operator(A_s, rows)
    dinv = _dinv(A_s.diagonal())

    rng = np.random.default_rng(seed)
    cands = []
    rho = None
    for _ in range(max(1, int(num_candidates))):
        x0 = np.zeros(n_pad, dtype=dt)
        x0[:n] = rng.random(n).astype(dt) - 0.5
        x = torch.as_tensor(x0[lo:hi], device=mesh.device)
        if rho is None:
            rho = float(_ell_power_rho(A_op, dinv, x, rows, n_iter=20))
        x = _mesh_candidate_relax(
            A_op, dinv, x,
            torch.tensor(omega / max(rho, 1e-30), dtype=A_s.data.dtype,
                         device=mesh.device),
            rows, sweeps=int(candidate_iters))
        cands.append(rows.full(x).cpu().numpy()[:n])
    Bcur = np.column_stack(cands).astype(dt)

    return general_sa_setup_sharded(A_host, B=Bcur, mesh=mesh,
                                    max_levels=max_levels,
                                    max_coarse=max_coarse, dtype=dt, **kw)
