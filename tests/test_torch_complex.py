"""Complex Hermitian operators through the port: the default call on a gauge
Laplacian against the JAX package's, level by level in complex128, the
solves, complex64 operators, and the DIA matvec of every level.

On the CPU the DIA wrapper runs its plain version; the card's tests
(``test_torch_kernel.py``) hold the complex kernel entries against it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pyamg_tpu
import pyamg_tpu.amg_core as jax_core
import pyamg_tpu_torch
from pyamg_tpu_torch.gallery import gauge_laplacian
from pyamg_tpu_torch.sparse import SparseDIA, SparseELL, dia_kernel

from sa_cases import assert_same_smoother

torch.set_num_threads(1)


def _rhs(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


def _pair(n):
    A = gauge_laplacian(n, beta=0.1, seed=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_core, "have_native", lambda: True)
        ref = pyamg_tpu.smoothed_aggregation_solver(A.copy(), max_coarse=20)
    ours = pyamg_tpu_torch.smoothed_aggregation_solver(A.copy(),
                                                       max_coarse=20,
                                                       device="cpu")
    return A, ours, ref


@pytest.fixture(scope="module")
def pair():
    return _pair(96)


def _close(X, Y, tol=1e-12):
    assert X.shape == Y.shape
    d = abs(sp.csr_matrix(X) - sp.csr_matrix(Y))
    assert (d.max() if d.nnz else 0.0) <= tol * abs(Y).max()


@pytest.mark.parametrize("n", [24, 96])
def test_complex_default_hierarchy_matches_jax_level_by_level(n, pair):
    A, ours, ref = pair if n == 96 else _pair(n)
    assert len(ours.levels) == len(ref.levels) >= 3
    for lo, lr in zip(ours.levels, ref.levels):
        assert lo.A.dtype == torch.complex128
        assert np.iscomplexobj(lo.A_csr.data)
        _close(lo.A_csr, lr.A_csr)
        assert abs(lo.A_csr - lo.A_csr.conj().T).max() \
            <= 1e-12 * abs(lo.A_csr).max()
        np.testing.assert_allclose(lo.B, lr.B, rtol=1e-12, atol=1e-14)
        assert type(lo.A).__name__ == type(lr.A).__name__
        _close(lo.A.to_scipy(), lo.A_csr, 1e-15)
        if not hasattr(lr, "P_csr"):
            continue
        _close(lo.P_csr, lr.P_csr)
        _close(lo.R_csr, lr.R_csr)
        _close(lo.R_csr, lo.P_csr.conj().T, 1e-15)
        assert type(lo.P).__name__ == type(lr.P).__name__
        _close(lo.P.to_scipy(), lo.P_csr, 1e-14)
        _close(lo.R.to_scipy(), lo.R_csr, 1e-14)
        assert_same_smoother(lo.presmoother, lr.presmoother)
    assert ours.operator_complexity() == ref.operator_complexity()
    # the relaxed candidate left the reals
    assert np.abs(ours.levels[0].B.imag).max() > 1e-3


@pytest.mark.parametrize("accel", [None, "cg", "gmres", "bicgstab", "cr",
                                   "cgnr"])
def test_complex_solve_matches_jax(pair, accel):
    A, ours, ref = pair
    b = _rhs(A.shape[0])
    res, res_ref = [], []
    x = ours.solve(b, tol=1e-10, accel=accel, residuals=res, maxiter=40)
    x_ref = np.asarray(ref.solve(b, tol=1e-10, accel=accel,
                                 residuals=res_ref, maxiter=40))
    assert x.dtype == torch.complex128
    assert len(res) == len(res_ref) > 3
    np.testing.assert_allclose(res, res_ref, rtol=1e-6)
    assert np.abs(x.numpy() - x_ref).max() <= 1e-8 * np.abs(x_ref).max()
    if accel != "cgnr":
        assert np.linalg.norm(b - A @ x.numpy()) \
            <= 1e-9 * np.linalg.norm(b)


@pytest.mark.parametrize("cycle", ["V", "W", "AMLI"])
def test_complex_cycle_matches_jax(pair, cycle):
    A, ours, ref = pair
    b, x0 = _rhs(A.shape[0], 1), _rhs(A.shape[0], 2)
    y = ours.cycle_fn(cycle)(torch.from_numpy(x0), torch.from_numpy(b))
    y_ref = np.asarray(ref.cycle_fn(cycle)(jnp.asarray(x0), jnp.asarray(b)))
    assert np.abs(y.numpy() - y_ref).max() <= 1e-12 * np.abs(y_ref).max()


@pytest.mark.parametrize("coarse,smoother", [
    ("lu", "jacobi"), ("cholesky", ("chebyshev", {})),
    ("splu", ("sor", {"omega": 1.2})), ("gauss_seidel", "gauss_seidel")],
    ids=["lu-jacobi", "cholesky-chebyshev", "splu-sor", "gs-gs"])
def test_complex_coarse_solvers_and_smoothers_match_jax(coarse, smoother):
    """No coarse solver or smoother drops an imaginary part: same CG counts
    and the same x as the JAX package, in complex128."""
    A = gauge_laplacian(32, beta=0.1, seed=0)
    b = _rhs(A.shape[0])
    kw = dict(max_coarse=20, coarse_solver=coarse, presmoother=smoother,
              postsmoother=smoother)
    ref = pyamg_tpu.smoothed_aggregation_solver(A.copy(), **kw)
    ours = pyamg_tpu_torch.smoothed_aggregation_solver(A.copy(), device="cpu",
                                                       **kw)
    res, res_ref = [], []
    x = ours.solve(b, tol=1e-10, accel="cg", residuals=res)
    x_ref = np.asarray(ref.solve(b, tol=1e-10, accel="cg",
                                 residuals=res_ref))
    assert len(res) == len(res_ref) > 3
    assert np.abs(x.numpy() - x_ref).max() <= 1e-10 * np.abs(x_ref).max()
    assert np.linalg.norm(b - A @ x.numpy()) <= 1e-9 * np.linalg.norm(b)


def test_complex64_operators_and_the_mixed_precision_solve():
    A = gauge_laplacian(48, beta=0.1, seed=0)
    b = _rhs(A.shape[0])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_core, "have_native", lambda: True)
        ref = pyamg_tpu.smoothed_aggregation_solver(
            A.copy(), max_coarse=20, op_dtype=jnp.complex64)
    ours = pyamg_tpu_torch.smoothed_aggregation_solver(
        A.copy(), max_coarse=20, op_dtype=torch.complex64, device="cpu")
    assert all(lvl.A.dtype == torch.complex64 for lvl in ours.levels)
    res, res_ref = [], []
    x = ours.solve(b, tol=1e-5, accel="cg", residuals=res)
    ref.solve(b, tol=1e-5, accel="cg", residuals=res_ref)
    assert x.dtype == torch.complex64 and len(res) == len(res_ref) > 3
    np.testing.assert_allclose(res, res_ref, rtol=1e-3)
    assert np.linalg.norm(b - A @ x.numpy().astype(np.complex128)) \
        <= 5e-5 * np.linalg.norm(b)
    for accel in ("cg", "bicgstab"):
        x64, info = ours.solve_mp(b, tol=1e-10, accel=accel,
                                  return_info=True)
        assert x64.dtype == torch.complex128 and info["rounds"] == 1
        assert np.linalg.norm(b - A @ x64.numpy()) \
            <= 5e-10 * np.linalg.norm(b)
    ours.astype(torch.complex128)
    assert all(lvl.A.dtype == torch.complex128 for lvl in ours.levels)


def _dia_operators(ml):
    for lvl in ml.levels:
        for op in (lvl.A, getattr(lvl, "P", None), getattr(lvl, "R", None)):
            dia = op if isinstance(op, SparseDIA) else getattr(op, "dia",
                                                               None)
            if isinstance(dia, SparseDIA):
                yield dia


@pytest.mark.parametrize("dtype,tol", [(torch.complex64, 1e-5),
                                       (torch.complex128, 1e-12)])
def test_complex_dia_matvec_on_every_dia_operator(pair, dtype, tol):
    _, ours, _ = pair
    seen = 0
    for D in _dia_operators(ours):
        D = D.astype(dtype)
        x = torch.as_tensor(_rhs(D.shape[1], 3), dtype=dtype)
        before = dia_kernel.launches
        y = D.matvec(x)
        assert dia_kernel.launches == before and y.dtype == dtype
        ref = D.to_scipy() @ x.numpy()
        assert np.abs(y.numpy() - ref).max() <= tol * np.abs(ref).max()
        seen += 1
    assert seen >= 3


def test_a_complex_padded_ell_level_multiplies_like_scipy():
    A = gauge_laplacian(16, beta=0.3, seed=4)
    E = SparseELL.from_scipy(A, device="cpu")
    x = _rhs(A.shape[0], 5)
    y = E.matvec(torch.from_numpy(x)).numpy()
    assert E.dtype == torch.complex128
    assert np.abs(y - A @ x).max() <= 1e-13 * np.abs(y).max()
