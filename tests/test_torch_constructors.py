"""The other constructors: the port against the JAX package.

* ``ben_ideal_interpolation`` (batched local least squares) on 1-D, 32^2
  and 64^2 Poisson and a 32^2 rotated anisotropic stencil, with the strength
  matrix and without, with ``max_nbr`` cutting the local F sets, and on a
  splitting with rows whose local C set is empty: P's pattern exactly, its
  values to 1e-10.
* ``newideal_solver`` at 48^2: rows, nnz, every level's A, P and R to
  1e-10, the device formats, and one V-cycle against the JAX cycle.
* ``global_ritz_process`` and ``local_ritz_process`` on the same inputs.
* ``asa_solver``/``tl_sa_solver`` at 32^2 (``conv_tol=0.35,
  max_targets=3``, and the legacy keywords): the targets kept on each
  level, every level's P and A to 1e-8, ``_asa_work``, the warning for an
  unknown keyword, CG iteration counts.

Every reference is built with the JAX package's ``have_native`` patched to
True.
"""

import functools
import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pyamg_tpu.amg_core as jax_core
from pyamg_tpu.aggregation import new_adaptive as jax_asa
from pyamg_tpu.aggregation import rootnode_nii as jax_nii
from pyamg_tpu.aggregation.aggregation import _aggregate as jax_aggregate
from pyamg_tpu.aggregation.aggregation import _strength as jax_strength
from pyamg_tpu_torch.aggregation import (asa_solver, ben_ideal_interpolation,
                                         new_adaptive, newideal_solver,
                                         tentative, tl_sa_solver)
from pyamg_tpu_torch.aggregation.aggregation import _aggregate, _strength
from pyamg_tpu_torch.gallery import diffusion_stencil_2d, poisson, stencil_grid

torch.set_num_threads(1)


def _jax(fn, *args, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_core, "have_native", lambda: True)
        return fn(*args, **kw)


def _plain(A):
    return sp.csr_matrix(sp.csr_matrix(A).tocoo())


def _close(A, B, tol):
    A, B = sp.csr_matrix(A), sp.csr_matrix(B)
    assert A.shape == B.shape
    d = abs(A - B)
    assert (d.max() if d.nnz else 0.0) <= tol * max(abs(B).max(), 1e-300)


def _same_pattern(P, Q):
    P, Q = sp.csr_matrix(P).copy(), sp.csr_matrix(Q).copy()
    P.sort_indices()
    Q.sort_indices()
    assert np.array_equal(P.indptr, Q.indptr)
    assert np.array_equal(P.indices, Q.indices)


def _matrix(name):
    if name == "1d":
        return _plain(poisson((50,), format="csr"))
    if name == "rotated32":
        return _plain(stencil_grid(diffusion_stencil_2d(
            epsilon=0.01, theta=np.pi / 8, type="FE"), (32, 32),
            format="csr"))
    g = int(name[len("poisson"):])
    return _plain(poisson((g, g), format="csr"))


NII_CASES = [("1d", True, 12), ("poisson32", True, 12),
             ("poisson64", True, 12), ("rotated32", True, 12),
             ("poisson32", False, 12), ("poisson64", True, 2),
             ("rotated32", True, 3)]


@pytest.mark.parametrize("name,with_C,max_nbr", NII_CASES,
                         ids=[f"{n}-{'C' if c else 'A'}-nbr{m}"
                              for n, c, m in NII_CASES])
def test_ben_ideal_interpolation_matches_jax(name, with_C, max_nbr):
    A = _matrix(name)
    B = np.ones((A.shape[0], 1))
    C = _strength(A, B, "symmetric")
    _, Cnodes = _aggregate(C, A, B, "standard")
    C_ref = _jax(jax_strength, A, B, "symmetric")
    _, Cnodes_ref = _jax(jax_aggregate, C_ref, A, B, "standard")
    assert np.array_equal(Cnodes, Cnodes_ref)
    _close(C, C_ref, 0.0)
    kw = dict(C=C if with_C else None, max_nbr=max_nbr)
    P = ben_ideal_interpolation(A, Cnodes, **kw)
    P_ref = jax_nii.ben_ideal_interpolation(A, Cnodes_ref, **kw)
    _same_pattern(P, P_ref)
    _close(P, P_ref, 1e-10)
    if max_nbr < 12:
        # the cut took effect: some F point has more F neighbours than kept
        isC = np.zeros(A.shape[0], bool)
        isC[Cnodes] = True
        rows = np.repeat(np.arange(A.shape[0]), np.diff(C.indptr))
        f_nbr = ~isC[C.indices] & (C.indices != rows)
        Fdeg = np.bincount(rows[f_nbr], minlength=A.shape[0])
        assert (Fdeg[~isC] > max_nbr - 1).any()


def test_ben_ideal_interpolation_leaves_a_row_without_c_points_empty():
    A = _plain(poisson((40,), format="csr"))
    Cnodes = np.array([0, 39])
    P = ben_ideal_interpolation(A, Cnodes, max_nbr=3)
    P_ref = jax_nii.ben_ideal_interpolation(A, Cnodes, max_nbr=3)
    _same_pattern(P, P_ref)
    _close(P, P_ref, 1e-10)
    row_nnz = np.diff(P.indptr)
    assert (row_nnz == 0).sum() > 10 and row_nnz[[0, 39]].tolist() == [1, 1]
    alias = tentative.ben_ideal_interpolation(A, Cnodes, max_nbr=3)
    _close(alias, P, 0.0)


@pytest.fixture(scope="module")
def newideal():
    A = _plain(poisson((48, 48), format="csr"))
    return A, newideal_solver(A, device="cpu"), \
        _jax(jax_nii.newideal_solver, A)


def test_newideal_solver_levels_match_jax(newideal):
    _, ours, ref = newideal
    assert len(ours.levels) == len(ref.levels) >= 3
    for lo, lr in zip(ours.levels, ref.levels):
        assert lo.A_csr.shape == lr.A_csr.shape
        assert lo.A_csr.nnz == lr.A_csr.nnz
        _close(lo.A_csr, lr.A_csr, 1e-10)
        assert type(lo.A).__name__ == type(lr.A).__name__
        assert hasattr(lo, "P") == hasattr(lr, "P")
        if hasattr(lr, "P"):
            _same_pattern(lo.P_csr, lr.P_csr)
            _close(lo.P_csr, lr.P_csr, 1e-10)
            _close(lo.R_csr, lr.R_csr, 1e-10)
            assert type(lo.P).__name__ == type(lr.P).__name__
            assert type(lo.R).__name__ == type(lr.R).__name__
    assert ours.operator_complexity() == pytest.approx(
        ref.operator_complexity(), rel=1e-14)


def test_newideal_solver_v_cycle_matches_jax(newideal):
    A, ours, ref = newideal
    b = np.random.default_rng(3).standard_normal(A.shape[0])
    x = ours.psolve(b)
    x_ref = _jax(ref.psolve, b)
    assert np.linalg.norm(b - A @ x) < np.linalg.norm(b)
    np.testing.assert_allclose(x, x_ref, rtol=0,
                               atol=1e-10 * np.abs(x_ref).max())


@pytest.mark.parametrize("with_B2", [False, True])
@pytest.mark.parametrize("weak_tol", [15.0, 1e-3])
def test_ritz_processes_match_jax(with_B2, weak_tol):
    A = _plain(poisson((24, 24), format="csr"))
    rng = np.random.default_rng(5)
    B1 = rng.random((A.shape[0], 2)) - 0.5
    B2 = rng.random(A.shape[0]) - 0.5 if with_B2 else None
    V = new_adaptive.global_ritz_process(A, B1, B2, weak_tol)
    V_ref = jax_asa.global_ritz_process(A.copy(), B1, B2, weak_tol)
    assert V.shape == V_ref.shape
    np.testing.assert_allclose(V, V_ref, rtol=0,
                               atol=1e-10 * np.abs(V_ref).max())
    C = _strength(A, V, "symmetric")
    AggOp, _ = _aggregate(C, A, V, "standard")
    T, counts = new_adaptive.local_ritz_process(A, AggOp, V, weak_tol)
    T_ref, counts_ref = jax_asa.local_ritz_process(A.copy(), AggOp, V,
                                                   weak_tol)
    assert np.array_equal(counts, counts_ref)
    _same_pattern(T, T_ref)
    _close(T, T_ref, 1e-10)
    if weak_tol < 1:
        assert V.shape[1] > 1 and counts.max() > 1


ASA_CASES = {"conv035-max3": dict(conv_tol=0.35, max_targets=3),
             "legacy": dict(max_candidates=2, improvement_iters=4,
                            target_convergence=0.3)}


@functools.lru_cache(maxsize=None)
def _asa_pair(name):
    A = _plain(poisson((32, 32), format="csr"))
    kw = ASA_CASES[name]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ours = asa_solver(A, device="cpu", **kw)
    return A, ours, _jax(jax_asa.asa_solver, A.copy(), **kw)


@pytest.mark.parametrize("name", list(ASA_CASES))
def test_asa_solver_hierarchy_matches_jax(name):
    _, ours, ref = _asa_pair(name)
    assert len(ours.levels) == len(ref.levels) >= 3
    targets = [lvl.B.shape[1] for lvl in ours.levels[:-1]]
    assert targets == [np.asarray(lvl.B).shape[1] for lvl in ref.levels[:-1]]
    assert max(targets) > 1
    for lo, lr in zip(ours.levels, ref.levels):
        _close(lo.A_csr, lr.A_csr, 1e-8)
        if hasattr(lr, "P_csr"):
            _close(lo.P_csr, lr.P_csr, 1e-8)
            _close(lo.T, lr.T, 1e-8)
            np.testing.assert_allclose(lo.B, lr.B, rtol=0, atol=1e-8)
            assert type(lo.P).__name__ == type(lr.P).__name__
    assert ours._asa_work == pytest.approx(ref._asa_work, rel=1e-14)


def test_asa_solver_cg_count_matches_jax():
    A, ours, ref = _asa_pair("conv035-max3")
    b = A @ np.random.default_rng(0).random(A.shape[0])
    res, res_ref = [], []
    x = ours.solve(b, tol=1e-8, accel="cg", residuals=res)
    _jax(ref.solve, b, tol=1e-8, accel="cg", residuals=res_ref)
    assert len(res) == len(res_ref) <= 20
    assert np.linalg.norm(b - A @ x.numpy()) <= 1e-7 * np.linalg.norm(b)


def test_tl_sa_solver_warns_on_an_unknown_keyword_only():
    A = _plain(poisson((16, 16), format="csr"))
    with pytest.warns(UserWarning, match="no_such_option"):
        tl_sa_solver(A, max_targets=1, no_such_option=3, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ml = tl_sa_solver(A, max_targets=1, device="cpu")
    assert ml._asa_work > 0


def test_a_norm_and_my_rand():
    A = _plain(poisson((10,), format="csr"))
    x = np.arange(10.0)
    assert new_adaptive.A_norm(x, A) == pytest.approx(
        float(jax_asa.A_norm(x, A)), rel=1e-15)
    r = new_adaptive.my_rand(5, 3)
    assert r.shape == (5, 3) and r.min() >= -1 and r.max() < 1
    r = new_adaptive.my_rand(4, 2, zero_crossings=False)
    assert r.min() >= 0 and r.max() < 1
