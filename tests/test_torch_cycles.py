"""The port's cycles, coarse solvers and solve options against the JAX
package's.

On default-argument hierarchies of four levels (a 64^2 gallery Poisson
matrix with ``A.grid``, and a 40x40 one as plain CSR), in float64: one V,
W, F and AMLI cycle to 1e-10; every coarse solver (pinv, pinv2, lu,
cholesky, splu, jacobi, gauss_seidel, block_jacobi, cg, gmres, bicgstab, a
callable) alone and inside a cycle to 1e-10; ``cycle_complexity``;
``psolve``, ``return_residuals`` and ``callback`` of ``solve``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pyamg_tpu
import pyamg_tpu.amg_core as jax_core
from pyamg_tpu.gallery import poisson as jax_poisson
from pyamg_tpu.multilevel import coarse_grid_solver as jax_coarse_grid_solver
import pyamg_tpu_torch
from pyamg_tpu_torch.gallery import poisson
from pyamg_tpu_torch.multilevel import coarse_grid_solver

torch.set_num_threads(1)

CYCLES = ["V", "W", "F", "AMLI"]


def _pair(case, **kw):
    A = poisson((64, 64) if case == "grid" else (40, 40), format="csr")
    J = jax_poisson(A.grid, format="csr")
    if case == "plain":
        A, J = sp.csr_matrix(A.tocoo()), sp.csr_matrix(J.tocoo())
    kw = dict(max_coarse=10, **kw)
    ours = pyamg_tpu_torch.smoothed_aggregation_solver(A, device="cpu", **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_core, "have_native", lambda: True)
        ref = pyamg_tpu.smoothed_aggregation_solver(J, **kw)
    return A, ours, ref


@pytest.fixture(scope="module", params=["grid", "plain"])
def pair(request):
    A, ours, ref = _pair(request.param)
    assert len(ours.levels) == len(ref.levels) == 4
    return A, ours, ref


def _vectors(n):
    rng = np.random.default_rng(0)
    return rng.standard_normal(n), rng.standard_normal(n)


@pytest.mark.parametrize("cycle", CYCLES)
def test_one_cycle_matches_jax(pair, cycle):
    A, ours, ref = pair
    x0, b = _vectors(A.shape[0])
    y = ours.cycle_fn(cycle)(torch.from_numpy(x0), torch.from_numpy(b))
    y_ref = np.asarray(ref.cycle_fn(cycle)(jnp.asarray(x0), jnp.asarray(b)))
    assert np.abs(y.numpy() - y_ref).max() <= 1e-10 * np.abs(y_ref).max()
    # a cycle reduces the error in the A-norm
    x_true = np.linalg.solve(A.toarray(), b)
    e0, e1 = x0 - x_true, y.numpy() - x_true
    assert e1 @ (A @ e1) < 0.5 * (e0 @ (A @ e0))


def test_cycles_differ_from_the_v_cycle(pair):
    A, ours, _ = pair
    x0, b = (torch.from_numpy(v) for v in _vectors(A.shape[0]))
    ys = {c: ours.cycle_fn(c)(x0, b) for c in CYCLES}
    for c in ("W", "F", "AMLI"):
        assert (ys[c] - ys["V"]).abs().max() > 1e-8
    assert (ours.cycle_fn("w")(x0, b) - ys["W"]).abs().max() == 0
    with pytest.raises(TypeError, match="cycle"):
        ours.cycle_fn("Z")


@pytest.mark.parametrize("cycle", CYCLES)
def test_cycle_solve_counts_match_jax(pair, cycle):
    A, ours, ref = pair
    b = A @ np.random.default_rng(1).random(A.shape[0])
    for accel in ("cg", None):
        res, res_ref = [], []
        ours.solve(b, tol=1e-8, cycle=cycle, accel=accel, residuals=res)
        ref.solve(b, tol=1e-8, cycle=cycle, accel=accel, residuals=res_ref)
        assert len(res) == len(res_ref) > 3
        np.testing.assert_allclose(res, res_ref, rtol=1e-6)


@pytest.mark.parametrize("cycle", CYCLES + ["amli"])
def test_cycle_complexity_matches_jax(pair, cycle):
    _, ours, ref = pair
    assert ours.cycle_complexity(cycle) == ref.cycle_complexity(cycle)
    with pytest.raises(TypeError, match="cycle"):
        ours.cycle_complexity("Z")


def test_amli_guards_a_zero_direction(pair):
    """A zero right-hand side makes every AMLI denominator zero; the guards
    keep the cycle at the zero vector, free of NaN."""
    A, ours, _ = pair
    z = torch.zeros(A.shape[0], dtype=torch.float64)
    y = ours.cycle_fn("AMLI")(z, z)
    assert bool(torch.isfinite(y).all()) and float(y.abs().max()) == 0.0


# ---------------------------------------------------------------------------
# coarse solvers
# ---------------------------------------------------------------------------

def _host_solver(A, b, shift=0.0):
    return np.linalg.solve(A.toarray() + shift * np.eye(A.shape[0]), b)


SOLVERS = {
    "pinv": "pinv", "pinv2": "pinv2", "lu": "lu", "cholesky": "cholesky",
    "splu": "splu", "jacobi": ("jacobi", {"iterations": 4}),
    "gauss_seidel": "gauss_seidel",
    "block_jacobi": ("block_jacobi", {"iterations": 3}),
    "cg": "cg", "gmres": ("gmres", {"tol": 1e-13}), "bicgstab": "bicgstab",
    "callable": _host_solver,
}


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_coarse_solver_matches_jax(name):
    A = poisson((7, 6), format="csr")
    b = np.random.default_rng(2).standard_normal(A.shape[0])
    x = coarse_grid_solver(SOLVERS[name])(A, torch.from_numpy(b))
    x_ref = jax_coarse_grid_solver(SOLVERS[name])(A.copy(), b)
    assert x.dtype == torch.float64
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=1e-10, atol=1e-10)
    if name not in ("jacobi", "gauss_seidel", "block_jacobi"):
        np.testing.assert_allclose(A @ x.numpy(), b, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_cycle_with_coarse_solver_matches_jax(name):
    A, ours, ref = _pair("plain", coarse_solver=SOLVERS[name], max_levels=3)
    x0, b = _vectors(A.shape[0])
    y = ours.cycle_fn("W")(torch.from_numpy(x0), torch.from_numpy(b))
    y_ref = np.asarray(ref.cycle_fn("W")(jnp.asarray(x0), jnp.asarray(b)))
    assert np.abs(y.numpy() - y_ref).max() <= 1e-10 * np.abs(y_ref).max()


@pytest.mark.parametrize("name", ["pinv", "lu", "cholesky", "splu"])
def test_dense_coarse_solvers_in_float32(name):
    A = poisson((9, 8), format="csr")
    b = np.random.default_rng(3).standard_normal(A.shape[0])
    fn = coarse_grid_solver(name).prepare(A, torch.float32, device="cpu")
    x = fn(torch.from_numpy(b).float())
    assert x.dtype == torch.float32
    x_true = np.linalg.solve(A.toarray(), b)
    assert np.abs(x.numpy() - x_true).max() <= 1e-4 * np.abs(x_true).max()
    # a float64 right-hand side comes back in float64
    assert fn(torch.from_numpy(b)).dtype == torch.float64


def test_lu_pivots_are_those_lapack_counts_from_one():
    rng = np.random.default_rng(4)
    M = rng.standard_normal((12, 12))
    M[0, 0] = 1e-9                          # forces a row interchange
    b = rng.standard_normal(12)
    x = coarse_grid_solver("lu")(sp.csr_matrix(M), torch.from_numpy(b))
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(M, b), rtol=1e-9)


def test_splu_drops_zero_rows_and_columns_like_jax():
    A = sp.lil_matrix(poisson((6, 5), format="csr"))
    for k in (4, 17):
        A[k, :] = 0.0
        A[:, k] = 0.0
    A = A.tocsr()
    b = np.random.default_rng(5).standard_normal(30)
    x = coarse_grid_solver("splu")(A, torch.from_numpy(b))
    x_ref = jax_coarse_grid_solver("splu")(A.copy(), b)
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=1e-10, atol=1e-12)
    assert x[4] == 0 and x[17] == 0
    keep = np.setdiff1d(np.arange(30), (4, 17))
    np.testing.assert_allclose((A @ x.numpy())[keep], b[keep], rtol=1e-10,
                               atol=1e-12)


def test_cholesky_refuses_an_indefinite_coarse_operator():
    A = sp.csr_matrix(np.diag([1.0, -1.0, 2.0]))
    with pytest.raises(np.linalg.LinAlgError):
        coarse_grid_solver("cholesky")(A, torch.ones(3, dtype=torch.float64))
    with pytest.raises(ValueError, match="coarse solver"):
        coarse_grid_solver("no_such")


def test_callable_coarse_solver_takes_keyword_arguments():
    A = poisson((5, 4), format="csr")
    b = torch.from_numpy(np.ones(20))
    x = coarse_grid_solver((_host_solver, {"shift": 1.0}))(A, b)
    np.testing.assert_allclose(
        x.numpy(), np.linalg.solve(A.toarray() + np.eye(20), np.ones(20)))


# ---------------------------------------------------------------------------
# solve options and the preconditioner interface
# ---------------------------------------------------------------------------

def test_psolve_and_aspreconditioner_take_arrays_and_tensors(pair):
    A, ours, ref = pair
    _, b = _vectors(A.shape[0])
    y_np = ours.psolve(b)
    y_t = ours.psolve(torch.from_numpy(b))
    assert isinstance(y_np, np.ndarray) and isinstance(y_t, torch.Tensor)
    np.testing.assert_array_equal(y_np, y_t.numpy())
    np.testing.assert_allclose(y_np, ref.psolve(b), rtol=1e-10, atol=1e-12)
    M = ours.aspreconditioner(cycle="W")
    assert M.shape == A.shape and M.dtype == np.float64
    y_w = M @ b
    assert y_w.shape == b.shape
    np.testing.assert_allclose(
        y_w, ref.aspreconditioner(cycle="W").matvec(b), rtol=1e-10,
        atol=1e-12)


@pytest.mark.parametrize("accel", ["cg", None])
def test_return_residuals_and_callback(pair, accel):
    A, ours, ref = pair
    b = A @ np.random.default_rng(1).random(A.shape[0])
    seen = []
    earlier = [123.0]
    x, res = ours.solve(b, tol=1e-8, accel=accel, return_residuals=True,
                        residuals=earlier,
                        callback=lambda xk: seen.append(xk.clone()))
    seen_ref = []
    _, res_ref = ref.solve(b, tol=1e-8, accel=accel, return_residuals=True)
    ref.solve(b, tol=1e-8, accel=accel,
              callback=lambda xk: seen_ref.append(xk.copy()))
    assert isinstance(res, np.ndarray) and len(res) == len(res_ref)
    np.testing.assert_allclose(res, res_ref, rtol=1e-6)
    assert earlier[0] == 123.0 and earlier[1:] == list(res)
    # as many calls as the JAX package makes: one per cycle of a stand-alone
    # solve, one in all with CG (its Krylov routines hand over the result)
    assert len(seen) == len(seen_ref) == (1 if accel else len(res) - 1)
    np.testing.assert_allclose(seen[-1].numpy(), seen_ref[-1], rtol=1e-8,
                               atol=1e-12)
    assert (seen[-1] - x).abs().max() == 0
    x2, info = ours.solve(b, tol=1e-8, accel=accel, return_info=True)
    assert info == 0 and (x2 - x).abs().max() == 0
    _, info = ours.solve(b, tol=1e-12, accel=accel, maxiter=2,
                         return_info=True)
    assert info == 2


def test_other_krylov_methods_raise(pair):
    """Every Krylov method of the JAX package is an ``accel`` now (GMRES
    matches it here; ``test_torch_multilevel.py`` holds the rest); what
    still raises is a name neither package has, and it raises as there."""
    A, ours, ref = pair
    b = np.ones(A.shape[0])
    res, res_ref = [], []
    ours.solve(b, tol=1e-8, accel="gmres", residuals=res)
    ref.solve(b, tol=1e-8, accel="gmres", residuals=res_ref)
    assert len(res) == len(res_ref) > 3
    np.testing.assert_allclose(res, res_ref, rtol=1e-6)
    for ml in (ours, ref):
        with pytest.raises(AttributeError):
            ml.solve(b, accel="no_such_method")
