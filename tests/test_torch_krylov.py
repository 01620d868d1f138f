"""The port's Krylov functions against the JAX package's, in float64.

The same numpy inputs (a 32^2 Poisson matrix, a nonsymmetric 32^2
convection-diffusion stencil, a complex Hermitian 24^2 gauge Laplacian; a
seeded right-hand side; with and without a preconditioner M) go through
``pyamg_tpu.krylov.<fn>`` and ``pyamg_tpu_torch.krylov.<fn>``: iteration
counts and ``info`` are equal, residual histories agree to 1e-6 relative and
``x`` to 1e-8 of its largest entry where the solve converged (to 1e-5 where
it ran out of iterations: an unconverged iterate of the normal equations
moves with round-off).  The port's GMRES orthogonalizes by modified
Gram-Schmidt where the JAX package runs classical Gram-Schmidt twice; both
are compared at the same restart length.  BiCGStab amplifies round-off along
its irregular convergence: its history is held to 1e-6 over the first 16
iterations, its count to one iteration and, where it converged, its ``x`` to
1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.linalg import LinearOperator

import pyamg_tpu.krylov as jax_krylov
from pyamg_tpu.gallery import gauge_laplacian as jax_gauge
from pyamg_tpu_torch import krylov
from pyamg_tpu_torch.gallery import gauge_laplacian, poisson, stencil_grid
from pyamg_tpu_torch.krylov._common import (identity_M, make_matvec,
                                            make_rmatvec, prepare)
from pyamg_tpu_torch.sparse import SparseDIA, device_operator

torch.set_num_threads(1)

NAMES = ["cg", "cr", "cgne", "cgnr", "bicgstab", "steepest_descent",
         "minimal_residual", "gmres", "gmres_mgs", "gmres_householder",
         "fgmres"]
CONVECTION = np.array([[0.0, -1.2, 0.0], [-1.5, 4.0, -0.5], [0.0, -0.8, 0.0]])


def _problem(kind):
    """``(A, b, M)``: M a seeded positive diagonal (not a multiple of
    diag(A)^-1, so that it changes every method's iterates)."""
    rng = np.random.default_rng(11)
    if kind == "symmetric":
        A = sp.csr_matrix(poisson((32, 32), format="csr"))
    elif kind == "nonsymmetric":
        A = sp.csr_matrix(stencil_grid(CONVECTION, (32, 32), format="csr"))
    else:
        A = gauge_laplacian(24, beta=0.1, seed=2)
        assert abs(A - jax_gauge(24, beta=0.1, seed=2)).max() == 0
    n = A.shape[0]
    b = rng.standard_normal(n)
    if kind == "hermitian":
        b = b + 1j * rng.standard_normal(n)
    M = sp.diags(1.0 / (np.abs(A.diagonal()) * (0.6 + rng.random(n)))).tocsr()
    return A, b, M.astype(A.dtype)


def test_exports_are_the_jax_packages():
    assert sorted(krylov.__all__) == sorted(jax_krylov.__all__) \
        == sorted(NAMES)


@pytest.mark.parametrize("with_M", [False, True], ids=["noM", "M"])
@pytest.mark.parametrize("kind", ["symmetric", "nonsymmetric", "hermitian"])
@pytest.mark.parametrize("name", NAMES)
def test_krylov_function_matches_jax(name, kind, with_M):
    A, b, M = _problem(kind)
    kw = dict(tol=1e-8, maxiter=60, M=M if with_M else None)
    if "gmres" in name:
        kw["restrt"] = 20
    res, res_ref, seen = [], [], []
    x_ref, info_ref = getattr(jax_krylov, name)(A, b, residuals=res_ref, **kw)
    x, info = getattr(krylov, name)(A, b, residuals=res, device="cpu",
                                    callback=seen.append, **kw)
    assert isinstance(x, torch.Tensor) and x.dtype == \
        (torch.complex128 if kind == "hermitian" else torch.float64)
    assert len(seen) == 1 and seen[0] is x
    assert len(res_ref) > 5
    if name == "bicgstab":
        assert abs(len(res) - len(res_ref)) <= 1
        assert (info == 0) == (info_ref == 0)
        np.testing.assert_allclose(res[:17], res_ref[:17], rtol=1e-6)
        tol_x = 1e-4 if info == 0 else np.inf
    else:
        assert info == info_ref and len(res) == len(res_ref)
        np.testing.assert_allclose(res, res_ref, rtol=1e-6)
        tol_x = 1e-8 if info == 0 else 1e-5
    x_ref = np.asarray(x_ref)
    assert np.abs(x.numpy() - x_ref).max() <= tol_x * np.abs(x_ref).max()
    if info == 0:
        # CR, minimal residual and left-preconditioned GMRES track ||M r||
        tracked = with_M and (name in ("cr", "minimal_residual")
                              or name.startswith("gmres"))
        assert np.linalg.norm(b - A @ x.numpy()) \
            <= (1e3 if tracked else 1.5) * 1e-8 * np.linalg.norm(b)


@pytest.mark.parametrize("name", ["gmres", "fgmres"])
def test_gmres_without_restart_and_default_maxiter(name):
    """``restrt=None`` spans the whole budget, ``maxiter=None`` is
    ``min(n, 300)``."""
    A, b, _ = _problem("nonsymmetric")
    res, res_ref = [], []
    x_ref, info_ref = getattr(jax_krylov, name)(A, b, tol=1e-10,
                                                residuals=res_ref)
    x, info = getattr(krylov, name)(A, b, tol=1e-10, residuals=res,
                                    device="cpu")
    assert info == info_ref == 0
    assert len(res) == len(res_ref) > 30
    np.testing.assert_allclose(res, res_ref, rtol=1e-6)
    assert np.abs(x.numpy() - np.asarray(x_ref)).max() <= 1e-8


def test_gmres_dispatcher():
    A, b, _ = _problem("symmetric")
    kw = dict(tol=1e-6, restrt=10, maxiter=30, device="cpu")
    for orthog, fn in (("mgs", krylov.gmres_mgs),
                       ("householder", krylov.gmres_householder)):
        x, info = krylov.gmres(A, b, orthog=orthog, **kw)
        x2, info2 = fn(A, b, **kw)
        assert info == info2 and torch.equal(x, x2)
    with pytest.raises(ValueError, match="orthogonalization"):
        krylov.gmres(A, b, orthog="cgs", **kw)


@pytest.mark.parametrize("name", ["cg", "bicgstab", "gmres", "cgnr"])
def test_zero_right_hand_side_and_exact_start(name):
    A, b, _ = _problem("symmetric")
    x, info = getattr(krylov, name)(A, np.zeros_like(b), tol=1e-8,
                                    maxiter=5, device="cpu")
    assert info == 0 and not x.any()
    xs = np.linalg.solve(A.toarray(), b)
    res = []
    x, info = getattr(krylov, name)(A, b, x0=xs, tol=1e-8, maxiter=5,
                                    residuals=res, device="cpu")
    assert info == 0 and res[0] <= 1e-8 * np.linalg.norm(b)
    assert np.abs(x.numpy() - xs).max() <= 1e-10


def test_operand_forms_give_the_same_iterates():
    """A port operator, an object with ``matvec``, a callable, a scipy
    matrix, a dense array and a scipy ``LinearOperator``; M likewise."""
    A, b, M = _problem("symmetric")
    D = SparseDIA.from_scipy(A, device="cpu")
    Md = M.diagonal()

    class WithMatvec:
        shape, dtype = A.shape, A.dtype

        def matvec(self, v):
            return D.matvec(v)

    forms = {"dia": (D, device_operator(M, device="cpu")),
             "object": (WithMatvec(), lambda r: torch.as_tensor(Md) * r),
             "callable": (D.matvec, M),
             "scipy": (A, M),
             "dense": (A.toarray(), M.toarray()),
             "linop": (LinearOperator(A.shape, matvec=lambda v: A @ v,
                                      dtype=A.dtype),
                       LinearOperator(A.shape, matvec=lambda v: Md * v,
                                      dtype=A.dtype))}
    ref = None
    for form, (op, pre) in forms.items():
        res = []
        x, info = krylov.cg(op, b, tol=1e-10, maxiter=200, M=pre,
                            residuals=res, device="cpu")
        assert info == 0, form
        if ref is None:
            ref = res
        # another summation order in the matvec moves the late iterations
        assert abs(len(res) - len(ref)) <= 2, form
        np.testing.assert_allclose(res[:40], ref[:40], rtol=1e-8,
                                   err_msg=form)


def test_common_helpers():
    A, b, _ = _problem("hermitian")
    v = torch.as_tensor(b)
    Av = torch.as_tensor(A @ b)
    AHv = torch.as_tensor(A.conj().T @ b)
    for op in (A, A.toarray()):
        assert torch.allclose(make_matvec(op, "cpu")(v), Av, atol=1e-12)
        assert torch.allclose(make_rmatvec(op, "cpu")(v), AHv, atol=1e-12)
    with pytest.raises(ValueError, match="rmatvec"):
        make_rmatvec(lambda x: x, "cpu")
    assert identity_M(None)(v) is v
    _, _, mv, pre, bt, x, maxiter = prepare(A, b, None, None, None, "cpu")
    assert maxiter == b.shape[0] and not x.any() and x.dtype == bt.dtype
    assert pre(bt) is bt and torch.allclose(mv(bt), Av, atol=1e-12)
    _, _, _, _, bt, x, _ = prepare(A, list(b), np.ones(b.shape[0]), 7, None,
                                   "cpu")
    assert x.dtype == torch.complex128 and bool((x == 1).all())


def test_float32_runs_in_float32():
    A, b, M = _problem("symmetric")
    b32 = b.astype(np.float32)
    for name in ("cg", "bicgstab", "gmres"):
        res = []
        x, info = getattr(krylov, name)(
            SparseDIA.from_scipy(A, dtype=np.float32, device="cpu"), b32,
            tol=1e-4, maxiter=200, residuals=res, device="cpu")
        assert x.dtype == torch.float32 and info == 0
        assert np.linalg.norm(b - A @ x.double().numpy()) \
            <= 2e-4 * np.linalg.norm(b)


def test_jax_reference_gets_the_same_inputs():
    """Guard of this file's comparisons: the JAX CG on the symmetric
    problem converges, so equal histories are not equal failures."""
    A, b, M = _problem("symmetric")
    x, info = jax_krylov.cg(A, jnp.asarray(b), tol=1e-8, maxiter=300, M=M)
    assert info == 0
