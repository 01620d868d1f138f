"""Adaptive smoothed aggregation: the port against the JAX package.

* ``adaptive_sa_solver`` on a 48^2 grid-aligned anisotropic problem with
  zebra smoothers and 15 candidate iterations (``benchmarks/suite.py``'s
  ``adaptive_sa_anisotropy_1024`` at a small size: the structured descent,
  semicoarsening and ``jacobi_weak``), and on the 32^2 Poisson problem as
  plain CSR with two candidates (the generic descent, its frozen
  aggregates and the general stage): the candidates after inf-norm scaling
  to 1e-10, ``work`` to 1e-12 relative, the hierarchies level by level,
  CG iteration counts exactly.
* The pieces: ``initial_setup_stage``'s frozen aggregates and strength,
  ``eliminate_local_candidates``, ``_bridge_rows``, the host relaxation's
  fallback for a device-only smoother name, improvement iterations; and
  that no intermediate hierarchy reaches the device.

Every reference is built with the JAX package's ``have_native`` patched to
True.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pyamg_tpu
import pyamg_tpu.amg_core as jax_core
from pyamg_tpu.aggregation import adaptive as jax_adaptive
import pyamg_tpu_torch
from pyamg_tpu_torch.aggregation import adaptive, aggregation
from pyamg_tpu_torch.gallery import poisson, stencil_grid

torch.set_num_threads(1)

ANISO_STENCIL = np.array([[0.0, -1.0, 0.0], [-1e-3, 2.002, -1e-3],
                          [0.0, -1.0, 0.0]])
ANISO_KW = dict(num_candidates=1, candidate_iters=15, max_coarse=20,
                prepostsmoother="zebra")


def _jax(fn, *args, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_core, "have_native", lambda: True)
        return fn(*args, **kw)


def _close(A, B, tol=1e-10):
    A, B = sp.csr_matrix(A), sp.csr_matrix(B)
    assert A.shape == B.shape
    d = abs(A - B)
    assert (d.max() if d.nnz else 0.0) <= tol * max(abs(B).max(), 1e-300)


def _problem(name):
    if name == "aniso-zebra-48":
        A = stencil_grid(ANISO_STENCIL, (48, 48), format="csr")
        J = A.copy()
        J.grid = A.grid
        return A, J, ANISO_KW
    A = sp.csr_matrix(poisson((32, 32), format="csr").tocoo())
    return A, A.copy(), dict(num_candidates=2, max_coarse=20)


@pytest.fixture(scope="module", params=["aniso-zebra-48", "poisson-csr-2"])
def built(request):
    A, J, kw = _problem(request.param)
    ours, work = pyamg_tpu_torch.adaptive_sa_solver(A, device="cpu", **kw)
    ref, jwork = _jax(pyamg_tpu.adaptive_sa_solver, J, **kw)
    return request.param, ours, work, ref, jwork, A


def test_adaptive_candidates_work_and_hierarchy_match_jax(built):
    name, ours, work, ref, jwork, _ = built
    assert work > 0 and abs(work - jwork) <= 1e-12 * jwork
    assert len(ours.levels) == len(ref.levels) >= 3
    B, JB = ours.levels[0].B, np.asarray(ref.levels[0].B)
    assert B.shape == JB.shape == (ours.levels[0].A_csr.shape[0],
                                   1 if name.startswith("aniso") else 2)
    np.testing.assert_allclose(np.abs(B).max(axis=0), 1.0, rtol=1e-14)
    np.testing.assert_allclose(B, JB, rtol=0, atol=1e-10)
    for lo, lr in zip(ours.levels, ref.levels):
        _close(lo.A_csr, lr.A_csr)
        assert lo.A_csr.nnz == lr.A_csr.nnz
        assert type(lo.A).__name__ == type(lr.A).__name__
        if hasattr(lr, "P_csr"):
            _close(lo.P_csr, lr.P_csr)
    if name.startswith("aniso"):
        # the structured path, semicoarsened along the weak axis
        blocks = [lvl.struct_meta["block"] for lvl in ours.levels[:-1]]
        assert blocks == [tuple(lvl.struct_meta["block"])
                          for lvl in ref.levels[:-1]]
        assert blocks[0] == (1, 3)
        assert ours.levels[0].struct_meta["sfn"] == "jacobi_weak"
        assert ours.levels[0].presmoother.kind == "zebra"


def test_adaptive_solves_take_the_jax_iteration_counts(built):
    _, ours, _, ref, _, A = built
    b = np.random.default_rng(0).random(A.shape[0])
    r1, r2 = [], []
    ours.solve(b, tol=1e-8, accel="cg", residuals=r1)
    ref.solve(b, tol=1e-8, accel="cg", residuals=r2)
    assert len(r1) == len(r2) <= 30
    x, info = ours.solve_mp(b, tol=1e-10, return_info=True)
    assert np.linalg.norm(b - A @ x.numpy()) <= 1e-9 * np.linalg.norm(b)


def test_initial_stage_freezes_the_jax_aggregates():
    A = sp.csr_matrix(poisson((24, 24), format="csr").tocoo())
    args = (A, "hermitian", True, 5, 0.1, 10, 20, "standard",
            ("gauss_seidel", {"sweep": "symmetric"}), ("jacobi", {}),
            "symmetric")
    x, agg, strg, work = adaptive.initial_setup_stage(*args, seed=3)
    jx, jagg, jstrg, jwork = _jax(jax_adaptive.initial_setup_stage,
                                  A.copy(), *args[1:], seed=3)
    np.testing.assert_allclose(x, jx, rtol=1e-10, atol=1e-12)
    assert work == jwork and len(agg) == len(jagg) >= 2
    for (fn, kw), (jfn, jkw) in zip(agg, jagg):
        assert fn == jfn == "predefined"
        assert abs(kw["AggOp"] - jkw["AggOp"]).nnz == 0
    for (fn, kw), (jfn, jkw) in zip(strg, jstrg):
        assert fn == jfn == "predefined"
        _close(kw["C"], jkw["C"], 1e-14)


@pytest.mark.parametrize("Ca", [0.01, 1.0])
def test_eliminate_local_candidates_matches_jax(Ca):
    A = poisson((20, 20), format="csr")
    ml = pyamg_tpu_torch.smoothed_aggregation_solver(
        A, keep=True, max_coarse=20, finalize_device=False, device="cpu")
    lvl = ml.levels[0]
    # a smooth candidate, small on the first three grid lines
    g = np.sin(np.pi * np.linspace(0.0, 1.0, 20))
    x = np.outer(g, g).ravel() + 0.05 * np.random.default_rng(4).random(400)
    x[:60] = 1e-6
    ours = adaptive.eliminate_local_candidates(x.copy(), lvl.AggOp, A,
                                               lvl.T, Ca=Ca)
    ref = jax_adaptive.eliminate_local_candidates(x.copy(), lvl.AggOp,
                                                  A.copy(), lvl.T, Ca=Ca)
    np.testing.assert_array_equal(ours, ref)
    assert (ours == 0).any() and (ours != 0).any()
    # a 2-D candidate is changed in place too
    x2 = x.copy()[:, None]
    adaptive.eliminate_local_candidates(x2, lvl.AggOp, A, lvl.T, Ca=Ca)
    np.testing.assert_array_equal(x2.ravel(), ours)


def test_bridge_rows_and_host_relaxation_match_jax():
    T = sp.random(12, 5, density=0.4, random_state=0, format="csr")
    _close(adaptive._bridge_rows(T, 3), jax_adaptive._bridge_rows(T, 3),
           0.0)
    A = stencil_grid(ANISO_STENCIL, (12, 12), format="csr")
    x0 = np.random.default_rng(5).random(A.shape[0])
    # zebra has a host form in both packages; chebyshev is device-only and
    # relaxes as symmetric Gauss-Seidel on the host, in both
    for method in ("zebra", "chebyshev", ("jacobi", {"omega": 0.5})):
        ours = adaptive._relax_zero(A, x0.copy(), method, 3)
        J = A.copy()
        J.grid = A.grid
        ref = _jax(jax_adaptive._relax_zero, J, x0.copy(), method, 3)
        np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=1e-14)
        assert abs(np.abs(ours).max() - 1.0) < 1e-14
    # gauss_seidel_nr raised here until the nonsymmetric slice ported it:
    # it now relaxes as the JAX package's host method
    ours = adaptive._relax_zero(A, x0.copy(), "gauss_seidel_nr", 1)
    J = A.copy()
    J.grid = A.grid
    ref = _jax(jax_adaptive._relax_zero, J, x0.copy(), "gauss_seidel_nr", 1)
    np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=1e-14)
    # schwarz raised here until the smoother-menu slice ported the host
    # multiplicative Schwarz: it now relaxes as the JAX package's
    ours = adaptive._relax_zero(A, x0.copy(), "schwarz", 1)
    ref = _jax(jax_adaptive._relax_zero, J, x0.copy(), "schwarz", 1)
    np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=1e-14)


def test_intermediate_hierarchies_stay_on_the_host(monkeypatch):
    calls = []
    real = aggregation._finalize_device_operators

    def counted(levels, **kw):
        calls.append(len(levels))
        return real(levels, **kw)

    monkeypatch.setattr(aggregation, "_finalize_device_operators", counted)
    A = sp.csr_matrix(poisson((16, 16), format="csr").tocoo())
    ml, _ = pyamg_tpu_torch.adaptive_sa_solver(
        A, num_candidates=3, max_coarse=10, candidate_iters=2, device="cpu")
    assert calls == [len(ml.levels)]
    assert ml.levels[0].B.shape[1] == 3


@pytest.mark.parametrize("case", ["one-candidate", "two-candidates",
                                  "given-candidate"])
def test_improvement_iterations_and_given_candidates_match_jax(case):
    A = sp.csr_matrix(poisson((16, 16), format="csr").tocoo())
    kw = dict(max_coarse=10, candidate_iters=2, seed=1)
    if case == "one-candidate":
        kw.update(improvement_iters=1)
    elif case == "two-candidates":
        kw.update(num_candidates=2, improvement_iters=1,
                  eliminate_local=(True, {"Ca": 1.0}))
    else:
        kw.update(initial_candidates=np.ones(A.shape[0]), num_candidates=2)
    ours, work = pyamg_tpu_torch.adaptive_sa_solver(A, device="cpu", **kw)
    ref, jwork = _jax(pyamg_tpu.adaptive_sa_solver, A.copy(), **kw)
    assert abs(work - jwork) <= 1e-12 * max(jwork, 1.0)
    np.testing.assert_allclose(ours.levels[0].B, np.asarray(ref.levels[0].B),
                               rtol=0, atol=1e-10)
    for lo, lr in zip(ours.levels, ref.levels):
        _close(lo.A_csr, lr.A_csr)
