"""The rank side of ``test_torch_sharded.py``,
``test_torch_sharded_setup.py`` and ``test_torch_sharded_ell_setup.py``.

Each test file starts one group of gloo CPU ranks with
``pyamg_tpu_torch.parallel.launch`` and runs every case of its slice in it;
the functions here are what each rank runs.  This module imports torch,
numpy, scipy and the port only, so that no rank pays JAX's import.  Each
case returns numpy data (x, residual histories, operator values, layouts),
which the tests hold against the JAX package and the unsharded port.
"""

import numpy as np
import scipy.sparse as sp
import torch

from pyamg_tpu_torch import (ruge_stuben_solver, smoothed_aggregation_solver)
from pyamg_tpu_torch.aggregation import device_setup
from pyamg_tpu_torch.gallery import (diffusion_stencil_2d, linear_elasticity,
                                     poisson, stencil_grid)
from pyamg_tpu_torch.parallel import (Layout, ShardedSolver,
                                      StructuredShardedSolver, make_mesh,
                                      shard_solver, shard_structured_solver,
                                      structured_sa_setup_sharded)
from pyamg_tpu_torch.parallel import mesh as mesh_mod
from pyamg_tpu_torch.parallel.halo import build_halo_ell, gather_ell
from pyamg_tpu_torch.parallel.sharding import _pad_ell, pad_to
from pyamg_tpu_torch.relaxation.smoothing import change_smoothers
from pyamg_tpu_torch.sparse import SparseDIA, SparseELL
from pyamg_tpu_torch.sparse.dia import ShardedDIA
from pyamg_tpu_torch.sparse.linop import (GridPoolOp, GridRepeatOp,
                                          ShardedGridPoolOp,
                                          ShardedGridRepeatOp)

CPU = "cpu"


def recirc_flow(n, eps=1e-2):
    """The JAX package's ``recirc_flow`` example at n x n: -eps Laplacian
    plus the rotating wind b = (y - 1/2, 1/2 - x), first-order upwinding,
    on the unit square with h = 1/(n + 1)."""
    h = 1.0 / (n + 1)
    xs = (np.arange(n) + 1) * h
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    b1, b2 = (Y - 0.5).reshape(-1), (0.5 - X).reshape(-1)
    N = n * n
    idx = np.arange(N)
    ix, iy = idx // n, idx % n
    rows, cols = [idx, idx], [idx, idx]
    vals = [np.full(N, 4.0 * eps / h**2), (np.abs(b1) + np.abs(b2)) / h]
    for mask, shift, v in (
            (ix + 1 < n, n, -eps / h**2 + np.minimum(b1, 0) / h),
            (ix >= 1, -n, -eps / h**2 - np.maximum(b1, 0) / h),
            (iy + 1 < n, 1, -eps / h**2 + np.minimum(b2, 0) / h),
            (iy >= 1, -1, -eps / h**2 - np.maximum(b2, 0) / h)):
        rows.append(idx[mask])
        cols.append(idx[mask] + shift)
        vals.append(v[mask])
    return sp.coo_matrix((np.concatenate(vals), (np.concatenate(rows),
                                                 np.concatenate(cols))),
                         shape=(N, N)).tocsr()


def _solved(sol, b, **kw):
    """``(x, residual history)`` of one solve, as numpy."""
    res = []
    x = sol.solve(b, residuals=res, **kw)
    return np.asarray(x), np.asarray(res)


def _rhs(n, seed):
    return np.random.default_rng(seed).standard_normal(n)


def _zebra(shape, axis, max_coarse):
    A = poisson(shape, format="csr")
    ml = smoothed_aggregation_solver(A, max_coarse=max_coarse, max_levels=2,
                                     improve_candidates=None, device=CPU)
    change_smoothers(ml, ("zebra", {"axis": axis}), ("zebra", {"axis": axis}))
    return ml


# -- slice (a): the solve ---------------------------------------------------

def solve_cases(mesh, inputs):
    """Every case of ``test_torch_sharded.py`` on this rank."""
    out = {}
    kw10 = dict(tol=1e-10, maxiter=40)

    A = poisson((31, 33), format="csr")
    ml = smoothed_aggregation_solver(A, max_coarse=20, device=CPU)
    sol = shard_solver(ml, n_devices=8)
    out["sa_31x33"] = _solved(sol, _rhs(A.shape[0], 0), **kw10)
    out["sa_31x33_sizes"] = sol.sizes
    seen = []
    x = sol.solve(_rhs(A.shape[0], 0), accel="cg", callback=seen.append,
                  **kw10)
    out["sa_31x33_callback"] = (np.asarray(x),
                                [np.asarray(v) for v in seen])

    A = poisson((24, 24), format="csr")
    ml = ruge_stuben_solver(A, max_coarse=20, device=CPU)
    sol = shard_solver(ml, n_devices=8)
    out["rs_24_cg"] = _solved(sol, _rhs(A.shape[0], 1), accel="cg", **kw10)
    out["rs_24_types"] = [type(lvl.A).__name__ for lvl in sol.levels]

    A = poisson((48, 48), format="csr")
    ml = smoothed_aggregation_solver(A, max_coarse=50,
                                     improve_candidates=None, device=CPU)
    sol = shard_structured_solver(ml, n_devices=8, axis_name="rows",
                                  min_shard_rows=256)
    out["struct_placement"] = sol.placement()
    out["struct_levels_untouched"] = all(
        getattr(lvl, "layout", None) is None for lvl in ml.levels)
    for accel, kw in (("cg", dict(tol=1e-10, maxiter=50)),
                      ("gmres", dict(tol=1e-10, maxiter=50)),
                      ("fgmres", dict(tol=1e-10, maxiter=50)),
                      (None, dict(tol=1e-8, maxiter=60))):
        out[f"struct_{accel}"] = _solved(sol, _rhs(A.shape[0], 3),
                                         accel=accel, **kw)
        out[f"struct_{accel}_one"] = _solved(ml, _rhs(A.shape[0], 3),
                                             accel=accel, **kw)
    try:
        sol.solve(_rhs(A.shape[0], 3), accel="cr")
    except ValueError as e:
        out["struct_cr"] = str(e)

    m4 = make_mesh(4)
    out["mesh4"] = (m4.size, m4.rank)
    try:
        make_mesh(10**6)
    except ValueError as e:
        out["mesh_too_many"] = str(e)
    mx = make_mesh(8, axis_name="x")
    ssx = StructuredShardedSolver(ml, mesh=mx, min_shard_rows=256)
    psx = ShardedSolver(ml, mx)
    out["axis_x"] = (ssx.axis, psx.axis,
                     _solved(ssx, _rhs(A.shape[0], 0), tol=1e-10,
                             maxiter=50)[0],
                     _solved(psx, _rhs(A.shape[0], 0), tol=1e-10,
                             maxiter=50, accel="cg")[0])

    for name, shape, axis, mc, seed in (("zebra_32x8", (32, 8), 0, 400, 0),
                                        ("zebra_31x7", (31, 7), 0, 100, 4),
                                        ("zebra_17x5", (17, 5), 1, 30, 5)):
        sol = shard_solver(_zebra(shape, axis, mc), n_devices=8)
        out[name] = _solved(sol, _rhs(shape[0] * shape[1], seed), **kw10)
        out[name + "_sizes"] = sol.sizes

    for name, shape, smoother, seed in (("jacobi_ne_24", (24, 24),
                                         "jacobi_ne", 1),
                                        ("schwarz_16", (16, 16), "schwarz",
                                         2)):
        A = poisson(shape, format="csr")
        ml = smoothed_aggregation_solver(A, max_coarse=30,
                                         improve_candidates=None, device=CPU)
        change_smoothers(ml, smoother, smoother)
        sol = shard_solver(ml, n_devices=8)
        out[name] = _solved(sol, _rhs(A.shape[0], seed), tol=1e-8,
                            maxiter=60)
        out[name + "_one"] = _solved(ml, _rhs(A.shape[0], seed), tol=1e-8,
                                     maxiter=60)
        out[name + "_kinds"] = (type(sol.levels[0].presmoother).__name__,
                                type(sol.levels[0].A).__name__)

    E, B = linear_elasticity((16, 16))
    ml = smoothed_aggregation_solver(E, B=B, max_coarse=40, device=CPU)
    out["elasticity_16"] = _solved(shard_solver(ml, n_devices=8),
                                   _rhs(E.shape[0], 0), tol=1e-8, maxiter=40)
    out["elasticity_16_one"] = _solved(ml, _rhs(E.shape[0], 0), tol=1e-8,
                                       maxiter=40)

    sten = diffusion_stencil_2d(epsilon=0.01, theta=0.0, type="FD")
    A = stencil_grid(sten, (24, 24), format="csr")
    ml = smoothed_aggregation_solver(A, B=inputs["multicand_B"],
                                     max_coarse=30, improve_candidates=None,
                                     device=CPU)
    out["multicand_24"] = _solved(shard_solver(ml, n_devices=8),
                                  inputs["multicand_b"], tol=1e-8,
                                  maxiter=40)
    out["multicand_24_one"] = _solved(ml, inputs["multicand_b"], tol=1e-8,
                                      maxiter=40)

    out["halo"] = _halo_matvecs(mesh, inputs["halo_mats"],
                                inputs["halo_x"])

    A = poisson((96, 96), format="csr")
    b = _rhs(A.shape[0], 5)
    for name, build in (("sa", smoothed_aggregation_solver),
                        ("rs", ruge_stuben_solver)):
        ml = build(A, max_coarse=30, device=CPU)
        runs = {}
        for halo in ("pack", "gather"):
            sol = shard_solver(ml, n_devices=8, halo=halo)
            mesh_mod.reset_counters()
            runs[halo] = _solved(sol, b, tol=1e-10, maxiter=40, accel="cg")
            runs[halo + "_exchange"] = dict(mesh_mod.counters)
            runs[halo + "_types"] = [type(lvl.A).__name__
                                     for lvl in sol.levels]
        out[f"pack_vs_gather_{name}"] = runs
    ml = smoothed_aggregation_solver(A, max_coarse=20, device=CPU)
    sol = shard_solver(ml, n_devices=8)
    lvl = sol.levels[0]
    out["fine_halo"] = (type(lvl.A).__name__, type(lvl.P).__name__,
                        lvl.A.halo_width)

    Ar = recirc_flow(24)
    ml = smoothed_aggregation_solver(
        Ar, symmetry="nonsymmetric",
        smooth=("energy", {"krylov": "gmres", "maxiter": 2}),
        presmoother=("gauss_seidel_nr", {"sweep": "symmetric"}),
        postsmoother=("gauss_seidel_nr", {"sweep": "symmetric"}),
        max_coarse=20, device=CPU)
    b = _rhs(Ar.shape[0], 0)
    sol = shard_solver(ml, n_devices=8)
    out["cgnr_recirc"] = {
        "one": _solved(ml, b, tol=1e-8, maxiter=40, accel="cgnr"),
        "sharded": _solved(sol, b, tol=1e-8, maxiter=40, accel="cgnr"),
        "kind": sol.levels[0].presmoother.kind,
        "AT": type(sol.levels[0].presmoother.AT).__name__}
    return out


def _halo_matvecs(mesh, mats, xs):
    """Per matrix: the whole y of the HaloELL and of the full-gather form
    (forced), the whole matrix back from ``to_scipy``, the halo widths of
    every rank, and A^T y by ``rmatvec``."""
    nd = mesh.size
    out = []
    for M, x in zip(mats, xs):
        n_pad, m_pad = pad_to(M.shape[0], nd), pad_to(M.shape[1], nd)
        rows, cols = Layout(mesh, n_pad, True), Layout(mesh, m_pad, True)
        E = _pad_ell(SparseELL.from_scipy(M, device=CPU), n_pad, m_pad)
        H = build_halo_ell(E, mesh, "rows", force=True)
        G = gather_ell(E, mesh)
        xl = cols.local(torch.as_tensor(x))
        X = torch.stack([xl, 2 * xl], dim=1)
        y = torch.as_tensor(np.random.default_rng(7).standard_normal(n_pad))
        out.append(dict(
            pack=rows.full(H.matvec(xl)).numpy(),
            gather=rows.full(G.matvec(xl)).numpy(),
            scipy=H.to_scipy(),
            widths=mesh.all_gather_object(H.halo_width),
            rmatvec=cols.full(H.rmatvec(rows.local(y))).numpy(),
            rmatvec_gather=cols.full(G.rmatvec(rows.local(y))).numpy(),
            matmat=rows.full(H.matmat(X)).numpy(),
            y=y.numpy()))
    return out


# -- slice (b): the structured setup over ranks -------------------------------

def _diag_report(ml):
    """Per level: the whole diagonals, the offsets and whether the level
    is row-sharded."""
    out = []
    for lvl in ml.levels:
        A = lvl.A
        diags = A.full_diags() if isinstance(A, ShardedDIA) else A.diags
        out.append((diags.numpy(), A.offsets,
                    bool(lvl.layout is not None and lvl.layout.sharded)))
    return out


def setup_cases(mesh, inputs):
    """Every case of ``test_torch_sharded_setup.py`` on this rank."""
    out = {}
    starts = inputs["jax_starts"]
    real_start = device_setup._power_start
    device_setup._power_start = lambda n, dtype, seed, device: starts[n]
    try:
        A = poisson((48, 48), format="csr")
        ml = structured_sa_setup_sharded(A, (48, 48), n_devices=8,
                                         dtype=np.float64)
        out["setup_48"] = _diag_report(ml)
    finally:
        device_setup._power_start = real_start

    A = poisson((48, 24), format="csr")
    ml = structured_sa_setup_sharded(A, (48, 24), n_devices=8,
                                     max_coarse=20)
    out["solve_48x24"] = _solved(ml, _rhs(A.shape[0], 0), tol=1e-6,
                                 maxiter=40, accel="cg")

    A = poisson((48, 48), format="csr")
    ml = structured_sa_setup_sharded(A, (48, 48), dtype=np.float64)
    b = A @ np.random.default_rng(0).random(A.shape[0])
    out["f64_48"] = _diag_report(ml)
    for accel in ("cg", "bicgstab", "gmres", None):
        out[f"f64_48_{accel}"] = _solved(ml, b, tol=1e-8, maxiter=60,
                                         accel=accel)
    x, info = ml.solve_mp(b, tol=1e-10, return_info=True)
    out["f64_48_mp"] = (np.asarray(x), info)
    mesh_mod.reset_counters()
    out["f64_48_cg_again"] = _solved(ml, b, tol=1e-8, maxiter=60,
                                     accel="cg")
    out["f64_48_exchange"] = dict(mesh_mod.counters)
    sol = shard_structured_solver(ml, min_shard_rows=256)
    out["f64_48_resharded"] = (sol.placement(), _solved(
        sol, b, tol=1e-8, maxiter=60, accel="cg"))

    A3 = poisson((12, 12, 12), format="csr")
    ml = structured_sa_setup_sharded(A3, (12, 12, 12), dtype=np.float64,
                                     max_coarse=50)
    out["grid_12c"] = _diag_report(ml)

    m4 = make_mesh(4)
    if m4.rank is not None:
        ml = structured_sa_setup_sharded(poisson((48, 48), format="csr"),
                                         (48, 48), mesh=m4, dtype=np.float64)
        out["setup_48_on_4"] = _diag_report(ml)

    out["ops"] = _sharded_ops(mesh, inputs["ops"])
    return out


def _sharded_ops(mesh, case):
    """The sharded DIA matvec and transpose and the sharded grid transfers
    on whole random operands: every rank's whole results."""
    diags = torch.as_tensor(case["diags"])
    offsets = tuple(case["offsets"])
    n = diags.shape[1]
    lay = Layout(mesh, n, True)
    S = ShardedDIA(lay.local(diags.T).T.contiguous(), offsets, lay)
    x = torch.as_tensor(case["x"])
    whole = SparseDIA(diags, offsets, (n, n))
    grid, block = tuple(case["grid"]), (3, 3)
    nc = int(np.prod([-(-g // 3) for g in grid]))
    wmap = torch.as_tensor(case["wmap"])
    xc = torch.as_tensor(case["xc"])
    out = {}
    for c_sharded in (True, False):
        clay = Layout(mesh, nc, c_sharded and nc % mesh.size == 0)
        rep = ShardedGridRepeatOp(lay.local(wmap), grid, block, lay, clay)
        pool = ShardedGridPoolOp(lay.local(wmap), grid, block, lay, clay)
        out[c_sharded] = dict(
            repeat=lay.full(rep.matvec(clay.local(xc))).numpy(),
            pool=clay.full(pool.matvec(lay.local(x))).numpy(),
            coarse_sharded=clay.sharded)
    out["matvec"] = lay.full(S.matvec(lay.local(x))).numpy()
    out["matvec_whole"] = whole.matvec(x).numpy()
    out["transpose"] = S.transpose().full_diags().numpy()
    out["transpose_whole"] = device_setup.dia_transpose(whole).diags.numpy()
    out["repeat_whole"] = GridRepeatOp(wmap, grid, block,
                                       (n, nc)).matvec(xc).numpy()
    out["pool_whole"] = GridPoolOp(wmap, grid, block,
                                   (nc, n)).matvec(x).numpy()
    out["nnz"] = (S.nnz, int(torch.count_nonzero(diags)))
    return out


# -- slices (c) and (d): the ELL-product setups over ranks --------------------

def pattern_hashes(sol):
    """sha256 of each level's host matrix (structure and values) and C/F
    splitting: equal on every rank when every rank's host stages agree."""
    import hashlib

    out = []
    for lvl in sol.levels:
        M = lvl.A_csr
        h = hashlib.sha256()
        for a in (M.indptr, M.indices, M.data,
                  getattr(lvl, "splitting", np.zeros(0)),
                  getattr(lvl, "Cpts", np.zeros(0))):
            h.update(np.ascontiguousarray(a).tobytes())
        out.append(h.hexdigest())
    return out


def _slab_rows(sol):
    """Per level: the layout's rows of this rank and the rows of A, P and
    R on this rank's device, with their types."""
    out = []
    for lvl in sol.levels:
        row = dict(nl=lvl.layout.nl, n=lvl.layout.n,
                   A=(type(lvl.A).__name__, lvl.A.data.shape[0]))
        for name in ("P", "R"):
            op = getattr(lvl, name, None)
            if op is not None:
                row[name] = (type(op).__name__, op.data.shape[0],
                             op.layout.nl)
        out.append(row)
    return out


def _ell_record(mesh, sol, b=None, solve=None):
    """What a case returns: the levels' host matrices and the whole P of
    each level (collectives, so every rank calls), the slab rows, the
    pattern hashes of every rank, and a solve's x and residuals."""
    from pyamg_tpu_torch.parallel import products

    out = dict(A=[lvl.A_csr for lvl in sol.levels],
               P=[lvl.P.to_scipy() for lvl in sol.levels[:-1]],
               slabs=_slab_rows(sol), sizes=list(sol.sizes),
               hashes=mesh.all_gather_object(pattern_hashes(sol)),
               types=[type(lvl.A).__name__ for lvl in sol.levels],
               routes=list(products.routes))
    if solve is not None:
        out["solve"] = _solved(sol, b, **solve)
    return out


def ell_setup_cases(mesh, inputs):
    """Every case of ``test_torch_sharded_ell_setup.py`` on this rank: the
    general, classical, energy, root-node and adaptive setups built over
    the ranks (``mesh``, or its first 4), each returned with its levels,
    its slab rows, the pattern hashes of every rank and a solve."""
    from pyamg_tpu_torch import parallel as par
    from pyamg_tpu_torch.parallel import products
    from pyamg_tpu_torch.parallel.energy import energy_smooth_sharded
    from pyamg_tpu_torch.sparse import SparseELL

    out = {}
    f64 = np.float64
    cg8 = dict(tol=1e-8, accel="cg", maxiter=100)

    def case(name, build, b=None, solve=None, on=mesh):
        products.routes.clear()
        out[name] = _ell_record(on, build(on), b, solve)

    A = sp.csr_matrix(poisson((48, 48), format="csr"))
    b48 = A @ np.random.default_rng(0).random(A.shape[0])
    case("general_48", lambda m: par.general_sa_setup_sharded(
        A, mesh=m, dtype=f64), b48, cg8)

    An = inputs["nodiag_32"]
    case("nodiag_32", lambda m: par.general_sa_setup_sharded(
        An, mesh=m, dtype=f64))

    E, B = linear_elasticity((16, 16))
    E = E.tocsr()
    case("elasticity_16", lambda m: par.general_sa_setup_sharded(
        E, B=B, mesh=m, dtype=f64, max_coarse=40), _rhs(E.shape[0], 0),
        dict(tol=1e-8, accel="cg", maxiter=200))

    B2 = np.ones((A.shape[0], 2))
    B2[:, 1] = np.linspace(-1, 1, A.shape[0])
    case("multicand_48", lambda m: par.general_sa_setup_sharded(
        A, B=B2, mesh=m, dtype=f64,
        smoother=("jacobi", {"omega": 0.8, "iterations": 2})),
        A @ np.random.default_rng(1).random(A.shape[0]),
        dict(tol=1e-8, accel="cg", maxiter=150))

    P48 = poisson((48, 48), format="csr")
    case("rs_direct_48", lambda m: par.classical_setup_sharded(
        P48, mesh=m, dtype=f64, max_coarse=50), b48,
        dict(tol=1e-8, accel="cg", maxiter=60))
    S48 = stencil_grid(diffusion_stencil_2d(epsilon=0.01, theta=np.pi / 4,
                                            type="FD"), (48, 48),
                       format="csr")
    case("rs_standard_48", lambda m: par.classical_setup_sharded(
        S48, mesh=m, dtype=f64, interpolation="standard", max_coarse=50))
    case("rs_evolution_48", lambda m: par.classical_setup_sharded(
        S48, mesh=m, dtype=f64, interpolation="standard", max_coarse=50,
        strength=("evolution", {"k": 2, "epsilon": 4.0})),
        S48 @ np.random.default_rng(0).random(S48.shape[0]), cg8)
    P32 = poisson((32, 32), format="csr")
    case("rs_32", lambda m: par.classical_setup_sharded(
        P32, mesh=m, dtype=f64, max_coarse=50))

    m4 = make_mesh(4)
    if m4.rank is None:
        try:
            par.general_sa_setup_sharded(P32, n_devices=4, dtype=f64)
        except ValueError as e:
            out["outside_mesh"] = str(e)
    else:
        ones = np.ones(P32.shape[0])
        cg10 = dict(tol=1e-10, accel="cg", maxiter=100)
        case("energy_32", lambda m: par.general_sa_setup_sharded(
            P32, mesh=m, max_coarse=20, smooth=("energy", {"maxiter": 4}),
            dtype=f64), ones, cg10, on=m4)
        case("rootnode_32", lambda m: par.rootnode_setup_sharded(
            P32, mesh=m, max_coarse=20, dtype=f64), ones, cg10, on=m4)
        P24 = poisson((24, 24), format="csr")
        case("rootnode_24", lambda m: par.rootnode_setup_sharded(
            P24, mesh=m, max_coarse=20, dtype=f64), on=m4)
        case("adaptive_32", lambda m: par.adaptive_sa_setup_sharded(
            P32, mesh=m, max_coarse=20, num_candidates=1,
            candidate_iters=10, dtype=f64), ones,
            dict(tol=1e-10, accel="cg", maxiter=200), on=m4)

        e = inputs["energy_24"]
        n_pad = pad_to(e["A"].shape[0], 4)
        A_ell = _pad_ell(SparseELL.from_scipy(e["A"], dtype=f64,
                                              device=CPU), n_pad, n_pad)
        P_ell, pattern = energy_smooth_sharded(
            A_ell, e["T"], e["C"], e["Bc"], m4, degree=1, maxiter=4,
            tol=1e-8, weighting="local", dt=f64)
        rows = Layout(m4, n_pad, True)
        P_s = products.RowSlab(P_ell, products.upload_rows(
            pattern, rows, P_ell.shape[1], values=False).pattern, rows)
        out["energy_P_24"] = dict(P=products.host_values(P_s),
                                  rows=P_ell.data.shape[0],
                                  pattern=pattern)
    return out


# -- the JAX package's mesh builds of the same cases --------------------------

def _jax_record(sol, b=None, solve=None):
    levels = getattr(sol, "inner", sol).levels
    out = dict(A=[lvl.A_csr for lvl in levels],
               P=[lvl.P.to_scipy() for lvl in levels[:-1]])
    if solve is not None:
        res = []
        x = sol.solve(b, residuals=res, **solve)
        out["solve"] = (np.asarray(x, dtype=float), np.asarray(res))
    return out


def _jax_energy_p(e, mesh):
    """The JAX package's energy P of ``e`` on ``mesh``, and the host flat
    path's."""
    from pyamg_tpu.aggregation.smooth import energy_prolongation_smoother
    from pyamg_tpu.parallel.energy import energy_smooth_sharded
    from pyamg_tpu.parallel.sharding import _pad_ell, _place_ell, pad_to
    from pyamg_tpu.sparse import SparseELL as JaxELL

    A = e["A"]
    n_pad = pad_to(A.shape[0], 4)
    A_ell = _place_ell(_pad_ell(JaxELL.from_scipy(A, dtype=np.float64),
                                n_pad, n_pad), mesh, "rows")
    P_ell, pattern = energy_smooth_sharded(
        A_ell, e["T"], e["C"], e["Bc"], mesh, "rows", degree=1, maxiter=4,
        tol=1e-8, weighting="local", dt=np.float64)
    host = energy_prolongation_smoother(
        A, e["T"], e["C"], e["Bc"], None, (False, {}), krylov="cg",
        maxiter=4, tol=1e-8, degree=1, weighting="local")
    return dict(P=P_ell.to_scipy(), pattern=pattern,
                host=sp.csr_matrix(host))


def jax_mesh_references(names, inputs):
    """The JAX package's mesh builds (and solves) of the cases ``names`` of
    :func:`ell_setup_cases`, in a process of their own: JAX on the CPU
    with 8 virtual devices and float64 (the process inherits the pytest
    process's ``XLA_FLAGS``), first-fit colors (the JAX package's native
    library patched in, as the port's tests build every reference)."""
    import os

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    if "device_count" not in os.environ.get("XLA_FLAGS", ""):
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   " --xla_force_host_platform_device_count=8")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import pyamg_tpu
    import pyamg_tpu.amg_core as jax_core
    from pyamg_tpu import parallel as jpar
    from pyamg_tpu.gallery import (diffusion_stencil_2d as jstencil,
                                   linear_elasticity as jelasticity,
                                   poisson as jpoisson,
                                   stencil_grid as jgrid)

    f64 = np.float64
    cg8 = dict(tol=1e-8, accel="cg", maxiter=100)
    m8, m4 = jpar.make_mesh(8), jpar.make_mesh(4)
    A = sp.csr_matrix(jpoisson((48, 48), format="csr"))
    b48 = A @ np.random.default_rng(0).random(A.shape[0])
    P48 = jpoisson((48, 48), format="csr")
    S48 = jgrid(jstencil(epsilon=0.01, theta=np.pi / 4, type="FD"),
                (48, 48), format="csr")
    P32 = jpoisson((32, 32), format="csr")
    ones = np.ones(P32.shape[0])
    cg10 = dict(tol=1e-10, accel="cg", maxiter=100)

    def elasticity():
        E, B = jelasticity((16, 16))
        return _jax_record(jpar.general_sa_setup_sharded(
            E.tocsr(), B=B, mesh=m8, dtype=f64, max_coarse=40),
            _rhs(E.shape[0], 0), dict(tol=1e-8, accel="cg", maxiter=200))

    def multicand():
        B2 = np.ones((A.shape[0], 2))
        B2[:, 1] = np.linspace(-1, 1, A.shape[0])
        return _jax_record(jpar.general_sa_setup_sharded(
            A, B=B2, mesh=m8, dtype=f64,
            smoother=("jacobi", {"omega": 0.8, "iterations": 2})),
            A @ np.random.default_rng(1).random(A.shape[0]),
            dict(tol=1e-8, accel="cg", maxiter=150))

    cases = {
        "general_48": lambda: _jax_record(jpar.general_sa_setup_sharded(
            A, mesh=m8, dtype=f64), b48, cg8),
        "nodiag_32": lambda: _jax_record(jpar.general_sa_setup_sharded(
            inputs["nodiag_32"], mesh=m8, dtype=f64)),
        "elasticity_16": elasticity,
        "multicand_48": multicand,
        "rs_direct_48": lambda: _jax_record(jpar.classical_setup_sharded(
            P48, mesh=m8, dtype=f64, max_coarse=50), b48,
            dict(tol=1e-8, accel="cg", maxiter=60)),
        "rs_standard_48": lambda: _jax_record(jpar.classical_setup_sharded(
            S48, mesh=m8, dtype=f64, interpolation="standard",
            max_coarse=50)),
        "rs_evolution_48": lambda: _jax_record(jpar.classical_setup_sharded(
            S48, mesh=m8, dtype=f64, interpolation="standard",
            max_coarse=50, strength=("evolution", {"k": 2, "epsilon": 4.0})),
            S48 @ np.random.default_rng(0).random(S48.shape[0]), cg8),
        "rs_32": lambda: _jax_record(jpar.classical_setup_sharded(
            P32, mesh=m8, dtype=f64, max_coarse=50)),
        "energy_32": lambda: _jax_record(jpar.general_sa_setup_sharded(
            P32, mesh=m4, max_coarse=20, smooth=("energy", {"maxiter": 4}),
            dtype=f64), ones, cg10),
        "rootnode_32": lambda: _jax_record(jpar.rootnode_setup_sharded(
            P32, mesh=m4, max_coarse=20, dtype=f64), ones, cg10),
        "rootnode_24": lambda: _jax_record(jpar.rootnode_setup_sharded(
            jpoisson((24, 24), format="csr"), mesh=m4, max_coarse=20,
            dtype=f64)),
        "adaptive_32": lambda: _jax_record(jpar.adaptive_sa_setup_sharded(
            P32, mesh=m4, max_coarse=20, num_candidates=1,
            candidate_iters=10, dtype=f64), ones,
            dict(tol=1e-10, accel="cg", maxiter=200)),
        "energy_P_24": lambda: _jax_energy_p(inputs["energy_24"], m4),
        "rs_evolution_host": lambda: dict(A=[
            lvl.A_csr for lvl in pyamg_tpu.ruge_stuben_solver(
                S48, strength=("evolution", {"k": 2, "epsilon": 4.0}),
                interpolation="standard", max_coarse=50).levels]),
    }
    jax_core.have_native = lambda: True
    return {name: cases[name]() for name in names}
