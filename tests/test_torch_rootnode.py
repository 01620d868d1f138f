"""Root-node smoothed aggregation: the port against the JAX package.

* ``rootnode_solver`` with every argument at its default on the 32^2
  Poisson problem with its grid metadata and as plain CSR, and on a 16^2
  ``linear_elasticity`` BSR operator with its rigid-body modes: the roots
  (``Cpts``), P and A per level to 1e-10 in float64, the device forms of
  the transfers (root-embedded DIA where banded), CG iteration counts
  exactly.
* The root-node bookkeeping ``get_Cpt_params`` and ``scale_T`` on their
  own, and the root-node branch of energy smoothing with the pre- and
  post-filters.
* ``symmetry="nonsymmetric"`` builds the JAX package's hierarchy
  (``test_torch_nonsymmetric.py`` holds it level by level).

Every reference is built with the JAX package's ``have_native`` patched to
True.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pyamg_tpu
import pyamg_tpu.amg_core as jax_core
from pyamg_tpu.aggregation import smooth as jax_smooth
from pyamg_tpu.util import utils as jax_utils
import pyamg_tpu_torch
from pyamg_tpu_torch.aggregation import smooth
from pyamg_tpu_torch.aggregation.aggregate import standard_aggregation
from pyamg_tpu_torch.aggregation.tentative import fit_candidates
from pyamg_tpu_torch.gallery import linear_elasticity, poisson
from pyamg_tpu_torch.sparse import CptProlongOp, SparseDIA
from pyamg_tpu_torch.strength import symmetric_strength_of_connection
from pyamg_tpu_torch.util import utils

torch.set_num_threads(1)


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
    """(A for the port, A for the JAX package, B or None)."""
    if name == "poisson-grid":
        A = poisson((32, 32), format="csr")
        return A, A.copy(), None
    if name == "poisson-csr":
        A = sp.csr_matrix(poisson((32, 32), format="csr").tocoo())
        return A, A.copy(), None
    A, B = linear_elasticity((16, 16))
    return A, A.copy(), B


@pytest.fixture(scope="module",
                params=["poisson-grid", "poisson-csr", "elasticity"])
def built(request):
    A, J, B = _problem(request.param)
    kw = {} if B is None else dict(B=B, max_coarse=40)
    ours = pyamg_tpu_torch.rootnode_solver(A, device="cpu", **kw)
    ref = _jax(pyamg_tpu.rootnode_solver, J, **kw)
    return request.param, ours, ref, A


def test_rootnode_hierarchy_matches_jax_level_by_level(built):
    name, ours, ref, _ = built
    assert len(ours.levels) == len(ref.levels) >= 2
    for lo, lr in zip(ours.levels, ref.levels):
        _close(lo.A_csr, lr.A_csr)
        assert lo.A_csr.nnz == lr.A_csr.nnz
        np.testing.assert_allclose(lo.B, np.asarray(lr.B), rtol=1e-10,
                                   atol=1e-12)
        assert lo.blocksize == lr.blocksize
        assert type(lo.A).__name__ == type(lr.A).__name__
        if not hasattr(lr, "P_csr"):
            continue
        np.testing.assert_array_equal(lo.Cpts, lr.Cpts)
        np.testing.assert_array_equal(lo.root_dofs, lr.root_dofs)
        _close(lo.P_csr, lr.P_csr)
        _close(lo.R_csr, lr.R_csr)
        assert type(lo.P).__name__ == type(lr.P).__name__
        # root rows of P are rows of the identity
        Pr = lo.P_csr[lo.root_dofs].toarray()
        np.testing.assert_allclose(Pr, np.eye(lo.P_csr.shape[1]), atol=1e-14)
    # the blocked hierarchy keeps its dofs per node on every level
    if name == "elasticity":
        assert {lvl.blocksize for lvl in ours.levels} == {2}
        assert ours.levels[1].B.shape[1] == 3


def test_rootnode_solves_take_the_jax_iteration_counts(built):
    _, ours, ref, A = built
    b = np.random.default_rng(0).random(A.shape[0])
    r1, r2 = [], []
    ours.solve(b, tol=1e-8, accel="cg", residuals=r1)
    ref.solve(b, tol=1e-8, accel="cg", residuals=r2)
    assert len(r1) == len(r2) and len(r1) <= 40
    np.testing.assert_allclose(r1[:4], r2[:4], rtol=1e-8)
    x, info = ours.solve_mp(b, tol=1e-10, return_info=True)
    assert np.linalg.norm(b - A @ x.numpy()) <= 1e-9 * np.linalg.norm(b)


def test_rootnode_transfers_take_the_root_embedded_dia_form():
    """Above the dense limit the level-0 transfers are a DIA operator on
    the fine grid plus the root scatter (the form the DIA kernel serves on
    the card)."""
    A = poisson((72, 72), format="csr")
    ml = pyamg_tpu_torch.rootnode_solver(A, max_coarse=300, device="cpu")
    lvl = ml.levels[0]
    assert isinstance(lvl.P, CptProlongOp) and isinstance(lvl.P.dia,
                                                          SparseDIA)
    rng = np.random.default_rng(1)
    xc, xf = rng.standard_normal(lvl.P.shape[1]), \
        rng.standard_normal(lvl.P.shape[0])
    np.testing.assert_allclose(lvl.P.matvec(torch.from_numpy(xc)).numpy(),
                               lvl.P_csr @ xc, rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(lvl.R.matvec(torch.from_numpy(xf)).numpy(),
                               lvl.R_csr @ xf, rtol=1e-12, atol=1e-13)


def _root_pieces(name):
    """A, its strength graph, the aggregation and its roots, and B."""
    if name == "poisson":
        A = poisson((20, 20), format="csr")
        B = np.ones((A.shape[0], 1))
    else:
        A, B = linear_elasticity((10, 10))
    C = symmetric_strength_of_connection(A)
    AggOp, roots = standard_aggregation(C)
    return A, C, AggOp, roots, B


@pytest.mark.parametrize("name", ["poisson", "elasticity"])
def test_get_Cpt_params_and_scale_T_match_jax(name):
    A, _, AggOp, roots, B = _root_pieces(name)
    bs = 1 if name == "poisson" else 2
    T, _ = fit_candidates(AggOp, B[:, :bs])
    T = sp.csr_matrix(T)
    ours = utils.get_Cpt_params(A, roots, AggOp, T)
    ref = jax_utils.get_Cpt_params(A, roots, AggOp, T)
    for key in ("Cpts", "Fpts"):
        np.testing.assert_array_equal(ours[key], ref[key])
    for key in ("P_I", "I_F", "I_C"):
        _close(ours[key], ref[key], 0.0)
    Ts = utils.scale_T(T, ours["P_I"], ours["I_F"], blocksize=bs)
    Tj = jax_utils.scale_T(T, ref["P_I"], ref["I_F"], blocksize=bs)
    _close(Ts, Tj, 1e-14)
    # the root rows are rows of the identity, and the candidates still fit
    np.testing.assert_allclose(Ts[ours["Cpts"]].toarray(),
                               np.eye(Ts.shape[1]), atol=1e-13)
    # an aggregation with fewer coarse dofs than roots: the first stored
    # column of each root's row
    Tt = T[:, :-bs]
    ours2 = utils.get_Cpt_params(A, roots, AggOp, Tt)
    ref2 = jax_utils.get_Cpt_params(A, roots, AggOp, Tt)
    _close(ours2["P_I"], ref2["P_I"], 0.0)


@pytest.mark.parametrize("filters", [
    dict(), dict(prefilter={"theta": 0.2}), dict(postfilter={"k": 3}),
    dict(prefilter={"k": 2}, postfilter={"theta": 0.1})],
    ids=["none", "prefilter-theta", "postfilter-k", "both"])
@pytest.mark.parametrize("library", ["compiled", "python"])
def test_rootnode_energy_branch_with_filters_matches_jax(filters, library,
                                                          monkeypatch):
    A, C, AggOp, roots, B = _root_pieces("poisson")
    T, _ = fit_candidates(AggOp, B)
    params = utils.get_Cpt_params(A, roots, AggOp, T)
    T = utils.scale_T(T, params["P_I"], params["I_F"])
    Bc = np.asarray(params["P_I"].T @ B)
    P = J = None
    if library == "python":
        # both packages' generic scipy route
        from pyamg_tpu_torch import amg_core

        monkeypatch.setattr(amg_core, "_lib", False)
        monkeypatch.setattr(jax_core, "_lib", False)
        monkeypatch.setattr(jax_core, "have_native", lambda: False)
        J = jax_smooth.energy_prolongation_smoother(
            A, T, C, Bc, B, (True, params), degree=2, **filters)
    P = smooth.energy_prolongation_smoother(A, T, C, Bc, B, (True, params),
                                            degree=2, **filters)
    if J is None:
        J = _jax(jax_smooth.energy_prolongation_smoother, A, T, C, Bc, B,
                 (True, params), degree=2, **filters)
    _close(P, J, 1e-12)
    assert P.nnz == J.nnz
    # the root rows stay the identity
    np.testing.assert_allclose(P[params["Cpts"]].toarray(),
                               np.eye(P.shape[1]), atol=1e-13)
    if library == "compiled" and not filters.get("postfilter"):
        # and P B_c = B (the generic route projects each update over its
        # stored entries only, which does not keep it with degree 2, in
        # both packages: ROADMAP.md, Queue 3)
        np.testing.assert_allclose(P @ Bc, B, atol=1e-10)


def test_rootnode_options():
    A = poisson((12, 12), format="csr")
    # (the nonsymmetric form raised until the nonsymmetric slice:
    # test_torch_nonsymmetric.py compares it level by level)
    ml = pyamg_tpu_torch.rootnode_solver(A, symmetry="nonsymmetric",
                                         max_coarse=20, device="cpu")
    ref = _jax(pyamg_tpu.rootnode_solver, A.copy(), symmetry="nonsymmetric",
               max_coarse=20)
    assert len(ml.levels) == len(ref.levels) > 1
    for lo, lr in zip(ml.levels[:-1], ref.levels[:-1]):
        _close(lo.R_csr, lr.R_csr)
        np.testing.assert_allclose(lo.BH, np.asarray(lr.BH), rtol=1e-10)
    with pytest.raises(ValueError, match="symmetry"):
        pyamg_tpu_torch.rootnode_solver(A, symmetry="skew", device="cpu")
    with pytest.raises(ValueError, match="energy"):
        pyamg_tpu_torch.rootnode_solver(A, smooth="jacobi", max_coarse=10,
                                        device="cpu")
    # no smoothing: the scaled tentative prolongator; symmetric R = P^T
    ml = pyamg_tpu_torch.rootnode_solver(A, smooth=None, max_coarse=10,
                                         symmetry="symmetric", keep=True,
                                         device="cpu")
    ref = _jax(pyamg_tpu.rootnode_solver, A.copy(), smooth=None,
               max_coarse=10, symmetry="symmetric", keep=True)
    for lo, lr in zip(ml.levels[:-1], ref.levels[:-1]):
        _close(lo.P_csr, lr.P_csr, 1e-12)
        np.testing.assert_array_equal(lo.Fpts, lr.Fpts)
        assert lo.AggOp.shape == lr.AggOp.shape
    ml32 = pyamg_tpu_torch.rootnode_solver(A, op_dtype=torch.float32,
                                           max_coarse=10, device="cpu")
    assert ml32.levels[0].A.dtype == torch.float32
