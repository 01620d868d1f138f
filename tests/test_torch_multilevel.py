"""The port's cycle and solves against the JAX package's.

A 128^2 Poisson hierarchy built by ``pyamg_tpu`` is exported with
``np.asarray`` and loaded into the port with
``util.convert.hierarchy_from_numpy``, so that the V-cycle and the solves
are compared with the setup factored out; the port's own setup is compared
too.  One V-cycle agrees to 1e-12 relative in float64; iteration counts are
pinned exactly and residuals loosely.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pyamg_tpu
from pyamg_tpu.gallery import poisson as jax_poisson
from pyamg_tpu.sparse import ComposedOp as JComposed
import pyamg_tpu_torch
from pyamg_tpu_torch.gallery import poisson
from pyamg_tpu_torch.util.convert import hierarchy_from_numpy

torch.set_num_threads(1)

N = 128
KW = dict(max_coarse=50, presmoother="chebyshev", postsmoother="chebyshev",
          improve_candidates=None)


def _dia(op):
    return {"diags": np.asarray(op.diags), "offsets": tuple(op.offsets),
            "shape": tuple(op.shape)}


def _smoother(sm):
    return {"kind": sm.kind, "iterations": sm.iterations, "omega": sm.omega,
            "dinv": None if sm.dinv is None else np.asarray(sm.dinv),
            "coefficients": tuple(sm.coefficients)}


def export_jax(ml):
    """The arrays of a JAX structured SA hierarchy, as
    ``hierarchy_from_numpy`` takes them."""
    coarse = np.asarray(ml._dev()["coarse"][0])
    levels = []
    for lvl in ml.levels:
        spec = {"A": _dia(lvl.A)}
        if getattr(lvl, "P", None) is not None:
            meta = lvl.struct_meta
            P, R = lvl.P, lvl.R
            assert isinstance(P, JComposed) and len(P.ops) == 2
            spec["transfer"] = {
                "wmap": np.asarray(P.ops[1].wmap),
                "fine_grid": tuple(meta["grid"]),
                "block": tuple(meta["block"]),
                "S": _dia(P.ops[0]), "SH": _dia(R.ops[1]),
                "degree": meta["degree"]}
            spec["presmoother"] = _smoother(lvl.presmoother)
            spec["postsmoother"] = _smoother(lvl.postsmoother)
        levels.append(spec)
    return levels, coarse


@pytest.fixture(scope="module")
def problem():
    A = poisson((N, N), format="csr")
    b = A @ np.random.default_rng(0).random(A.shape[0])
    return A, b


@pytest.fixture(scope="module")
def jax_ml():
    return pyamg_tpu.smoothed_aggregation_solver(
        jax_poisson((N, N), format="csr"), **KW)


@pytest.fixture(scope="module")
def ports(jax_ml):
    """The port's hierarchy both ways: loaded from the JAX arrays, and
    built by its own setup."""
    levels, coarse = export_jax(jax_ml)
    loaded = hierarchy_from_numpy(levels, coarse, "cpu", torch.float64)
    own = pyamg_tpu_torch.smoothed_aggregation_solver(
        poisson((N, N), format="csr"), device="cpu", **KW)
    return {"loaded": loaded, "own": own}


def _relres(A, b, x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.linalg.norm(b - A @ x) / np.linalg.norm(b)


@pytest.mark.parametrize("how", ["loaded", "own"])
def test_one_vcycle_matches_jax(jax_ml, ports, problem, how):
    _, b = problem
    rng = np.random.default_rng(1)
    x0 = rng.standard_normal(b.shape[0])
    ref = np.asarray(jax_ml.cycle_fn("V")(jnp.asarray(x0), jnp.asarray(b)))
    ml = ports[how]
    assert len(ml.levels) == len(jax_ml.levels) == 4
    y = ml.cycle_fn("V")(torch.from_numpy(x0), torch.from_numpy(b)).numpy()
    assert np.abs(y - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("how", ["loaded", "own"])
def test_pcg_iteration_count_matches_jax(jax_ml, ports, problem, how):
    A, b = problem
    ref_res = []
    jax_ml.solve(b, tol=1e-8, accel="cg", residuals=ref_res)
    res = []
    x, info = ports[how].solve(b, tol=1e-8, accel="cg", residuals=res,
                               return_info=True)
    assert info == 0
    assert len(res) == len(ref_res)
    np.testing.assert_allclose(res, ref_res, rtol=1e-6)
    assert _relres(A, b, x) <= 1e-8


def test_standalone_cycling_matches_jax(jax_ml, ports, problem):
    A, b = problem
    ref_res = []
    jax_ml.solve(b, tol=1e-8, residuals=ref_res)
    res = []
    x = ports["own"].solve(b, tol=1e-8, residuals=res)
    assert len(res) == len(ref_res)
    assert _relres(A, b, x) <= 1e-8


@pytest.fixture(scope="module")
def f32_pair():
    ref = pyamg_tpu.smoothed_aggregation_solver(
        jax_poisson((N, N), format="csr"), op_dtype=jnp.float32, **KW)
    ours = pyamg_tpu_torch.smoothed_aggregation_solver(
        poisson((N, N), format="csr"), device="cpu", op_dtype=torch.float32,
        **KW)
    return ours, ref


@pytest.mark.parametrize("method", ["defect", "pcg"])
def test_solve_mp_matches_jax(f32_pair, problem, method):
    A, b = problem
    ours, ref = f32_pair
    kw = dict(tol=1e-10, method=method, inner_maxiter=40, max_rounds=4,
              inner_tol_factor=1e-6, return_info=True)
    x_ref, info_ref = ref.solve_mp(b, **kw)
    x, info = ours.solve_mp(b, **kw)
    assert x.dtype == torch.float64
    assert _relres(A, b, x) <= 5e-10
    assert abs(info["inner_iterations"] - info_ref["inner_iterations"]) <= 1
    if method == "defect":
        assert info["rounds"] == info_ref["rounds"]


# ---------------------------------------------------------------------------
# every accelerator, the mixed-precision solve, the solver set, astype
# ---------------------------------------------------------------------------

ACCELS = ["cg", "bicgstab", "gmres", "fgmres", "cr", "steepest_descent",
          "minimal_residual", "cgnr", "cgne", "gmres_mgs",
          "gmres_householder"]


@pytest.mark.parametrize("accel", ACCELS)
def test_every_accel_through_solve_matches_jax(jax_ml, ports, problem, accel):
    """The names whose core runs on the hierarchy directly and the names
    routed through the public Krylov function: equal counts, ``info``,
    histories to 1e-6 and x to 1e-8."""
    A, b = problem
    kw = dict(tol=1e-8, accel=accel, maxiter=25, return_info=True)
    res, res_ref = [], []
    x_ref, info_ref = jax_ml.solve(b, residuals=res_ref, **kw)
    x, info = ports["own"].solve(b, residuals=res, **kw)
    assert isinstance(x, torch.Tensor) and x.dtype == torch.float64
    assert info == info_ref and len(res) == len(res_ref) > 3
    np.testing.assert_allclose(res, res_ref, rtol=1e-6)
    x_ref = np.asarray(x_ref)
    assert np.abs(x.numpy() - x_ref).max() <= 1e-8 * np.abs(x_ref).max()
    if info == 0:
        assert _relres(A, b, x) <= 1e-7


@pytest.mark.parametrize("accel", ["cg", "gmres", "bicgstab", "cgnr",
                                   "gmres_householder", None])
def test_callback_counts_equal_the_jax_packages_per_route(jax_ml, ports,
                                                          problem, accel):
    """A callback sends every name through the public Krylov function,
    which calls it once with the result; stand-alone cycling calls it after
    every cycle."""
    _, b = problem
    seen, seen_ref, res = [], [], []
    kw = dict(tol=1e-6, accel=accel, maxiter=20)
    x = ports["own"].solve(b, callback=seen.append, residuals=res, **kw)
    jax_ml.solve(b, callback=seen_ref.append, **kw)
    assert len(seen) == len(seen_ref) == (1 if accel else len(res) - 1)
    assert torch.equal(seen[-1], x)
    np.testing.assert_allclose(seen[-1].numpy(), seen_ref[-1], rtol=1e-6,
                               atol=1e-10)


def test_accel_takes_a_callable_and_return_residuals(ports, problem):
    from pyamg_tpu_torch import krylov

    A, b = problem
    calls = []

    def my_cg(A, b, **kw):
        calls.append(sorted(kw))
        return krylov.cg(A, b, **kw)

    ml = ports["own"]
    x, res = ml.solve(b, tol=1e-8, accel=my_cg, return_residuals=True)
    x2, res2 = ml.solve(b, tol=1e-8, accel="cg", return_residuals=True)
    assert calls == [["M", "callback", "maxiter", "residuals", "tol", "x0"]]
    assert torch.equal(x, x2)
    np.testing.assert_array_equal(res, res2)
    with pytest.raises(AttributeError):
        ml.solve(b, accel="no_such_method")


def test_normal_equation_accels_build_the_adjoint_when_not_symmetric(
        ports, problem, monkeypatch):
    _, b = problem
    ml = ports["own"]
    x_sym = ml.solve(b, tol=1e-8, accel="cgnr", maxiter=10)
    monkeypatch.setattr(ml, "symmetry", "nonsymmetric")
    op = ml._with_rmatvec(ml.levels[0].A)
    v = torch.from_numpy(b)
    assert op.rmatvec.__self__ is not ml.levels[0].A
    np.testing.assert_allclose(op.rmatvec(v).numpy(),
                               ml.levels[0].A_csr.T @ b, rtol=1e-12)
    x = ml.solve(b, tol=1e-8, accel="cgnr", maxiter=10)
    np.testing.assert_allclose(x.numpy(), x_sym.numpy(), rtol=1e-9,
                               atol=1e-12)


@pytest.mark.parametrize("method", ["pcg", "defect"])
@pytest.mark.parametrize("accel", ["bicgstab", "gmres", "fgmres"])
def test_solve_mp_accels_match_jax(f32_pair, problem, accel, method):
    A, b = problem
    ours, ref = f32_pair
    kw = dict(tol=1e-10, accel=accel, method=method, inner_maxiter=40,
              max_rounds=4, inner_tol_factor=1e-6, return_info=True)
    x_ref, info_ref = ref.solve_mp(b, **kw)
    x, info = ours.solve_mp(b, **kw)
    assert x.dtype == torch.float64
    assert _relres(A, b, x) <= 5e-10
    assert _relres(A, b, np.asarray(x_ref)) <= 5e-10
    assert abs(info["inner_iterations"] - info_ref["inner_iterations"]) <= 1
    if method == "defect":
        assert info["rounds"] == info_ref["rounds"]


def test_solve_mp_forwards_a_float64_hierarchy_to_solve(jax_ml, ports,
                                                        problem):
    A, b = problem
    for accel in ("cg", "gmres"):
        x, info = ports["own"].solve_mp(b, tol=1e-10, accel=accel,
                                        return_info=True)
        _, info_ref = jax_ml.solve_mp(b, tol=1e-10, accel=accel,
                                      return_info=True)
        # the port's info counts its device reads besides
        assert info.pop("host_syncs") > info["inner_iterations"]
        assert info == info_ref and info["rounds"] == 1
        assert _relres(A, b, x) <= 1e-9


def test_solve_mp_refuses_what_the_jax_package_refuses(f32_pair, problem):
    A, b = problem
    ours, ref = f32_pair
    kw = dict(tol=1e-10, accel="cr", method="defect", return_info=True)
    x, info = ours.solve_mp(b, **kw)      # defect rounds take any core
    _, info_ref = ref.solve_mp(b, **kw)
    assert _relres(A, b, x) <= 5e-10 and info["rounds"] == info_ref["rounds"]
    with pytest.raises(ValueError, match="accel"):
        ours.solve_mp(b, accel="cr")
    with pytest.raises(ValueError, match="accel"):
        ours.solve_mp(b, accel="cgnr", method="defect")
    with pytest.raises(ValueError, match="method"):
        ours.solve_mp(b, method="other")


@pytest.fixture(scope="module")
def solver_sets(jax_ml, ports):
    """Two hierarchies of one operator in each package: Chebyshev and
    Jacobi smoothing."""
    kw = dict(KW, presmoother=("jacobi", {"omega": 0.7}),
              postsmoother=("jacobi", {"omega": 0.7}))
    ref2 = pyamg_tpu.smoothed_aggregation_solver(
        jax_poisson((N, N), format="csr"), **kw)
    ours2 = pyamg_tpu_torch.smoothed_aggregation_solver(
        poisson((N, N), format="csr"), device="cpu", **kw)
    return [ports["own"], ours2], [jax_ml, ref2]


@pytest.mark.parametrize("accel", ["cg", "gmres"])
@pytest.mark.parametrize("mode", ["additive", "multiplicative"])
def test_solver_set_matches_jax(solver_sets, problem, mode, accel):
    A, b = problem
    ours, ref = solver_sets
    S = pyamg_tpu_torch.MultilevelSolverSet(ours, mode=mode)
    Sref = pyamg_tpu.MultilevelSolverSet(ref, mode=mode)
    res, res_ref = [], []
    x = S.solve(b, tol=1e-8, accel=accel, residuals=res)
    x_ref = Sref.solve(b, tol=1e-8, accel=accel, residuals=res_ref)
    assert len(res) == len(res_ref) > 3
    np.testing.assert_allclose(res, res_ref, rtol=1e-6)
    assert np.abs(x.numpy() - x_ref).max() <= 1e-8 * np.abs(x_ref).max()
    assert _relres(A, b, x) <= 1e-7
    v = np.random.default_rng(4).standard_normal(b.shape[0])
    y, y_ref = (s.aspreconditioner().matvec(v) for s in (S, Sref))
    assert isinstance(y, np.ndarray)
    assert np.abs(y - y_ref).max() <= 1e-12 * np.abs(y_ref).max()


def test_solver_set_hierarchies_can_be_added_removed_and_replaced(
        solver_sets, problem):
    _, b = problem
    (a, c), _ = solver_sets
    S = pyamg_tpu_torch.multilevel_solver_set([a])
    assert S.mode == "multiplicative" and \
        pyamg_tpu_torch.multilevel_solver is pyamg_tpu_torch.MultilevelSolver
    one = S.aspreconditioner().matvec(b)
    np.testing.assert_allclose(one, a.aspreconditioner().matvec(b),
                               rtol=1e-12)
    S.add_hierarchy(c)
    two = S.aspreconditioner().matvec(b)
    assert len(S.solvers) == 2 and np.abs(two - one).max() > 1e-6
    S.replace_hierarchy(a, 1)
    assert S.solvers == [a, a]
    S.remove_hierarchy(0)
    np.testing.assert_allclose(S.aspreconditioner().matvec(b), one,
                               rtol=1e-12)
    with pytest.raises(ValueError, match="at least one"):
        pyamg_tpu_torch.MultilevelSolverSet([])


def test_astype_round_trip_matches_jax(problem):
    """float64 -> float32 -> float64 in place: dtypes follow, the host
    matrices stay, and each stage cycles like the JAX package's."""
    A, b = problem
    kw = dict(max_coarse=50)              # Gauss-Seidel: masks and dinv
    ours = pyamg_tpu_torch.smoothed_aggregation_solver(
        poisson((N, N), format="csr"), device="cpu", **kw)
    ref = pyamg_tpu.smoothed_aggregation_solver(
        jax_poisson((N, N), format="csr"), **kw)
    for dtype, jdtype, tol in ((torch.float32, jnp.float32, 2e-5),
                               (torch.float64, jnp.float64, 2e-6)):
        assert ours.astype(dtype) is ours
        ref.astype(jdtype)
        for lvl in ours.levels[:-1]:
            assert lvl.A.dtype == lvl.P.dtype == lvl.R.dtype == dtype
            assert lvl.presmoother.dinv.dtype == dtype
            assert lvl.presmoother.color_masks.dtype == dtype
            assert lvl.A_csr.dtype == np.float64
        y = ours.cycle_fn("V")(torch.zeros(b.shape[0], dtype=dtype),
                               torch.as_tensor(b, dtype=dtype))
        y_ref = np.asarray(ref.cycle_fn("V")(
            jnp.zeros(b.shape[0], jdtype), jnp.asarray(b, jdtype)))
        assert y.dtype == dtype
        assert np.abs(y.numpy() - y_ref).max() <= tol * np.abs(y_ref).max()
    x = ours.solve(b, tol=1e-6, accel="cg")
    assert x.dtype == torch.float64 and _relres(A, b, x) <= 1e-5
