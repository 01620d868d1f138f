"""Energy-minimizing prolongation smoothing and the compiled host bodies it
runs on: the port against the JAX package.

* Each new binding of ``pyamg_tpu_torch.amg_core`` -- the row-scatter
  masked product, the constraint projection and the pattern Grams, in
  scalar (CSR) and block (BSR) form, and the block Gauss-Seidel sweep --
  against its Python form and against ``pyamg_tpu.amg_core``'s, with int32
  and int64 indices; each declines without the library.
* Each energy CG route (``_cg_prolongation_bsr``, ``_cg_prolongation_flat``,
  ``_cg_prolongation``) against the JAX package's same route, and the
  block route against the scalar ones within 1e-12.  The public smoother
  takes the same route as the JAX package's (a float32 or complex operator
  leaves the compiled routes) and gives the same P.
* The hierarchy of ``smooth=("energy", {"maxiter": 2})`` with the
  rigid-body modes on ``linear_elasticity((24, 24))`` (the configuration of
  ``benchmarks/suite.py``'s elasticity cells at a small size) level by
  level, with its CG iteration count to 1e-8, and once with both host
  libraries forced off.

Every reference is built with the JAX package's ``have_native`` patched to
True, but in the cases that force both host libraries off.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pyamg_tpu
import pyamg_tpu.amg_core as jax_core
from pyamg_tpu.aggregation import smooth as jax_smooth
from pyamg_tpu.gallery import linear_elasticity as jax_elasticity
from pyamg_tpu.util import utils as jax_utils
import pyamg_tpu_torch
from pyamg_tpu_torch import amg_core
from pyamg_tpu_torch.aggregation import smooth
from pyamg_tpu_torch.aggregation.aggregate import standard_aggregation
from pyamg_tpu_torch.aggregation.tentative import fit_candidates
from pyamg_tpu_torch.gallery import linear_elasticity, poisson
from pyamg_tpu_torch.strength import symmetric_strength_of_connection
from pyamg_tpu_torch.util import utils

from test_torch_blocked import _blocked, _rel, assert_blocked_hierarchies_match

torch.set_num_threads(1)


def _idx(M, index_dtype):
    M = sp.csr_matrix(M).copy()
    M.indptr = M.indptr.astype(index_dtype)
    M.indices = M.indices.astype(index_dtype)
    return M


def _pieces(grid=(16, 14), blocked=True):
    """The elasticity operator (BSR), its node strength graph, the
    tentative prolongator of the rigid-body modes and its coarse B."""
    A, B = linear_elasticity(grid)
    C = symmetric_strength_of_connection(A, theta=0.0)
    AggOp, _ = standard_aggregation(C)
    T, Bc = fit_candidates(AggOp, B)
    return (A if blocked else A.tocsr()), C, sp.csr_matrix(T), Bc


# ---------------------------------------------------------------------------
# the compiled bodies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
def test_masked_spgemm_matches_python_and_jax(index_dtype):
    A, C, T, _ = _pieces(blocked=False)
    pattern = _idx(smooth._grow_pattern(utils.unamal(C, 2, 2), T, 1),
                   index_dtype)
    A, T = _idx(A, index_dtype), _idx(T, index_dtype)
    ours = amg_core.masked_spgemm_native(A, T, pattern)
    plain = (A @ T).tocsr().multiply(pattern).tocsr()
    ref = jax_core.masked_spgemm_native(A, T, pattern)
    assert ours.nnz == pattern.nnz
    assert _rel(ours, plain) <= 1e-14 and _rel(ours, ref) == 0
    # an unsorted A is copied before sorting: the caller's stays as it was
    U = A.copy()
    U.indices[:2] = U.indices[1::-1].copy()
    U.data[:2] = U.data[1::-1].copy()
    U.has_sorted_indices = False
    before = U.indices.copy()
    assert _rel(amg_core.masked_spgemm_native(U, T, pattern), ours) <= 1e-15
    np.testing.assert_array_equal(U.indices, before)
    assert amg_core.masked_spgemm_native(A.astype(np.float32), T,
                                         pattern) is None


@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "fmask"])
def test_constraint_project_and_gram_match_python_and_jax(index_dtype,
                                                          masked):
    A, C, T, Bc = _pieces(blocked=False)
    P = _idx((A @ T).tocsr(), index_dtype)
    P.sort_indices()
    gram = amg_core.pattern_gram_native(P.indptr, P.indices, Bc)
    np.testing.assert_allclose(
        gram, jax_core.pattern_gram_native(P.indptr, P.indices, Bc),
        rtol=0, atol=0)
    rows = np.repeat(np.arange(P.shape[0]), np.diff(P.indptr))
    Bp = np.zeros((P.shape[0], int(np.diff(P.indptr).max()), Bc.shape[1]))
    Bp[rows, np.arange(P.nnz) - P.indptr[rows]] = Bc[P.indices]
    np.testing.assert_allclose(gram, np.einsum("nlj,nlk->njk", Bp, Bp),
                               rtol=1e-12, atol=1e-12 * abs(gram).max())
    G = utils.compute_BtBinv(Bc, P)
    fmask = (np.arange(P.shape[0]) % 3 != 0) if masked else None
    vals, jvals = P.data.copy(), P.data.copy()
    assert amg_core.constraint_project_native(vals, P.indptr, P.indices, Bc,
                                              G, fmask)
    assert jax_core.constraint_project_native(jvals, P.indptr, P.indices,
                                              Bc, G, fmask)
    np.testing.assert_array_equal(vals, jvals)
    U = P.copy()
    if masked:
        U = sp.diags(fmask.astype(float)) @ U
    plain = smooth.satisfy_constraints(U, Bc, G)
    got = sp.csr_matrix((vals, P.indices, P.indptr), shape=P.shape)
    assert _rel(got, plain) <= 1e-12
    assert abs(got @ Bc).max() <= 1e-9 * abs(P @ Bc).max()
    # more than 16 candidates, or float32 values: the bindings decline
    B17 = np.ones((Bc.shape[0], 17))
    assert amg_core.pattern_gram_native(P.indptr, P.indices, B17) is None
    assert not amg_core.constraint_project_native(
        vals.astype(np.float32), P.indptr, P.indices, Bc, G)


@pytest.mark.parametrize("R,Cb", [(2, 3), (2, 2), (3, 6), (3, 3), (1, 4)])
@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
def test_block_bodies_match_python_and_jax(R, Cb, index_dtype):
    rng = np.random.default_rng(R * 7 + Cb)
    A = _blocked(R, nb=40, seed=R, bandwidth=2)
    nbc = 9
    Tpat = sp.random(40, nbc, density=0.2, random_state=R + Cb,
                     format="csr")
    Tpat = (Tpat + sp.coo_matrix((np.ones(40), (np.arange(40),
                                                np.arange(40) % nbc)),
                                 shape=(40, nbc))).tocsr()
    Tpat.sort_indices()
    Tb = sp.bsr_matrix((rng.standard_normal((Tpat.nnz, R, Cb)),
                        Tpat.indices, Tpat.indptr),
                       shape=(40 * R, nbc * Cb))
    pat = (abs(sp.csr_matrix((np.ones(A.indices.size), A.indices,
                              A.indptr), shape=(40, 40))) @ Tpat).tocsr()
    pat.sort_indices()
    ix = [a.astype(index_dtype) for a in (A.indptr, A.indices, Tb.indptr,
                                          Tb.indices, pat.indptr,
                                          pat.indices)]
    args = (nbc, R, Cb, ix[0], ix[1], A.data, ix[2], ix[3], Tb.data, ix[4],
            ix[5])
    ours = amg_core.masked_spgemm_bsr_native(*args)
    np.testing.assert_array_equal(ours, jax_core.masked_spgemm_bsr_native(
        *args))
    full = (A.tocsr() @ Tb.tocsr()).toarray()
    got = sp.bsr_matrix((ours, pat.indices, pat.indptr),
                        shape=full.shape).toarray()
    mask = sp.bsr_matrix((np.ones_like(ours), pat.indices, pat.indptr),
                         shape=full.shape).toarray() != 0
    np.testing.assert_allclose(got, np.where(mask, full, 0), rtol=1e-12,
                               atol=1e-12 * abs(full).max())
    # the block projection and Grams against their scalar forms
    K = min(Cb, 3)
    Bc = rng.standard_normal((nbc * Cb, K))
    gram = amg_core.pattern_gram_bsr_native(ix[4], ix[5], Cb, Bc)
    np.testing.assert_array_equal(gram, jax_core.pattern_gram_bsr_native(
        ix[4], ix[5], Cb, Bc))
    G = np.ascontiguousarray(np.linalg.pinv(gram))
    vals, jvals = ours.copy(), ours.copy()
    assert amg_core.constraint_project_bsr_native(vals, ix[4], ix[5], R, Cb,
                                                  Bc, G)
    assert jax_core.constraint_project_bsr_native(jvals, ix[4], ix[5], R,
                                                  Cb, Bc, G)
    np.testing.assert_array_equal(vals, jvals)
    U = sp.bsr_matrix((ours, pat.indices, pat.indptr),
                      shape=full.shape).tocsr()
    G_rows = np.repeat(G, R, axis=0)             # every scalar row's Gram
    plain = smooth.satisfy_constraints(U, Bc, G_rows)
    got = sp.bsr_matrix((vals, pat.indices, pat.indptr),
                        shape=full.shape).tocsr()
    assert _rel(got, plain) <= 1e-11
    assert amg_core.masked_spgemm_bsr_native(
        nbc, R, Cb, ix[0], ix[1], A.data.astype(np.float32), ix[2], ix[3],
        Tb.data, ix[4], ix[5]) is None


def test_bindings_decline_without_the_library(monkeypatch):
    A, C, T, Bc = _pieces(grid=(6, 6), blocked=False)
    monkeypatch.setattr(amg_core, "_lib", False)
    P = (A @ T).tocsr()
    assert amg_core.masked_spgemm_native(A, T, P) is None
    assert amg_core.pattern_gram_native(P.indptr, P.indices, Bc) is None
    assert not amg_core.constraint_project_native(P.data.copy(), P.indptr,
                                                  P.indices, Bc,
                                                  np.zeros((P.shape[0], 3,
                                                            3)))
    Ab = A.tobsr(blocksize=(2, 2))
    z = np.zeros(A.shape[0])
    assert not amg_core.bsr_gauss_seidel_native(
        Ab.indptr, Ab.indices, Ab.data, np.zeros((A.shape[0] // 2, 2, 2)),
        z, z, 2, 0, 1, 1)
    assert amg_core.masked_spgemm_bsr_native(
        3, 2, 3, Ab.indptr, Ab.indices, Ab.data, Ab.indptr, Ab.indices,
        Ab.data, Ab.indptr, Ab.indices) is None
    assert amg_core.pattern_gram_bsr_native(Ab.indptr, Ab.indices, 3,
                                            Bc) is None
    assert not amg_core.constraint_project_bsr_native(
        np.zeros((Ab.nnz, 2, 3)), Ab.indptr, Ab.indices, 2, 3, Bc,
        np.zeros((Ab.shape[0] // 2, 3, 3)))
    # the compiled Gram's Python form serves compute_BtBinv
    G = utils.compute_BtBinv(Bc, P)
    np.testing.assert_allclose(G, jax_utils.compute_BtBinv(Bc, P),
                               rtol=1e-10, atol=1e-10 * abs(G).max())


# ---------------------------------------------------------------------------
# the energy CG routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighting", ["local", "diagonal"])
@pytest.mark.parametrize("maxiter", [1, 3])
def test_energy_routes_match_jax_and_each_other(weighting, maxiter):
    A, C, T, Bc = _pieces()
    P_bsr = smooth._cg_prolongation_bsr(A, T, C, Bc, maxiter, 1e-8, 1,
                                        weighting)
    J_bsr = jax_smooth._cg_prolongation_bsr(A, T, C, Bc, maxiter, 1e-8, 1,
                                            weighting)
    assert P_bsr is not None and _rel(P_bsr, J_bsr) == 0

    pattern = smooth._grow_pattern(utils.unamal(C, 2, 2), T, 1)
    G = utils.compute_BtBinv(Bc, pattern)
    Acsr = A.tocsr()
    if weighting == "local":
        Dv = np.asarray(abs(Acsr).sum(axis=1)).ravel()
        Dinv = np.where(Dv != 0, 1.0 / np.where(Dv != 0, Dv, 1), 0.0)
    else:
        Dinv = utils.get_diagonal(Acsr, inv=True)
    P_flat = smooth._cg_prolongation_flat(Acsr, T, pattern, Bc, G, Dinv,
                                          maxiter, 1e-8)
    J_flat = jax_smooth._cg_prolongation_flat(Acsr, T, pattern, Bc, G, Dinv,
                                              None, maxiter, 1e-8)
    assert _rel(P_flat, J_flat) == 0

    def project(U):
        return smooth.satisfy_constraints(U, Bc, G)

    def apply_Dinv(R):
        return utils.scale_rows(R, Dinv, copy=True)

    P_gen = smooth._cg_prolongation(Acsr, T, pattern, project, apply_Dinv,
                                    maxiter, 1e-8)
    J_gen = jax_smooth._cg_prolongation(
        Acsr, T, pattern, lambda U: jax_smooth.satisfy_constraints(U, Bc, G),
        apply_Dinv, maxiter, 1e-8)
    assert _rel(P_gen, J_gen) <= 1e-13
    # the block route is the scalar one: same closure, same values
    assert P_bsr.nnz == P_flat.nnz
    assert _rel(P_bsr, P_flat) <= 1e-12 and _rel(P_gen, P_flat) <= 1e-12
    np.testing.assert_allclose(P_bsr @ Bc, T @ Bc, atol=1e-10)


ROUTES = ("_cg_prolongation_bsr", "_cg_prolongation_flat", "_cg_prolongation")


def _spy(monkeypatch, module, log):
    for name in ROUTES:
        real = getattr(module, name)

        def wrapped(*a, _real=real, _name=name, **k):
            out = _real(*a, **k)
            log.append((_name, out is not None))
            return out
        monkeypatch.setattr(module, name, wrapped)


SMOOTHER_CASES = {
    "bsr-f64": lambda: _pieces(),
    "csr-f64": lambda: _pieces(blocked=False),
    "bsr-f32": lambda: (lambda A, C, T, Bc: (A.astype(np.float32), C, T,
                                             Bc))(*_pieces()),
    "bsr-complex": lambda: (lambda A, C, T, Bc: (A.astype(np.complex128),
                                                 C, T, Bc))(*_pieces()),
    "poisson-K1": lambda: (lambda A: (A, A) + fit_candidates(
        standard_aggregation(A)[0], np.ones((A.shape[0], 1))))(
            poisson((20, 20), format="csr")),
}


@pytest.mark.parametrize("weighting", ["local", "diagonal", "block"])
@pytest.mark.parametrize("case", sorted(SMOOTHER_CASES))
def test_energy_smoother_takes_the_jax_route(case, weighting, monkeypatch):
    A, C, T, Bc = SMOOTHER_CASES[case]()
    kw = dict(maxiter=2, degree=1, weighting=weighting)
    ours_log, jax_log = [], []
    _spy(monkeypatch, smooth, ours_log)
    _spy(monkeypatch, jax_smooth, jax_log)
    monkeypatch.setattr(jax_core, "have_native", lambda: True)
    P = smooth.energy_prolongation_smoother(A.copy(), T, C, Bc, **kw)
    J = jax_smooth.energy_prolongation_smoother(A.copy(), T, C, Bc, None,
                                                (False, {}), **kw)
    assert ours_log == jax_log and ours_log
    assert P.nnz == J.nnz and _rel(P, J) <= 1e-12
    if case != "bsr-complex":
        # (a complex operator's generic route leaves P B_c off T B_c in a
        # few entries in both packages; the real cases keep it)
        tol = 1e-4 if case == "bsr-f32" else 1e-9
        np.testing.assert_allclose(P @ Bc, T @ Bc,
                                   atol=tol * abs(T @ Bc).max())


def test_energy_smoother_without_host_libraries(monkeypatch):
    A, C, T, Bc = _pieces()
    monkeypatch.setattr(amg_core, "_lib", False)
    monkeypatch.setattr(jax_core, "_lib", False)
    P = smooth.energy_prolongation_smoother(A.copy(), T, C, Bc, maxiter=3)
    J = jax_smooth.energy_prolongation_smoother(A.copy(), T, C, Bc,
                                                maxiter=3)
    assert _rel(P, J) <= 1e-12
    monkeypatch.setattr(amg_core, "_lib", None)
    Q = smooth.energy_prolongation_smoother(A.copy(), T, C, Bc, maxiter=3)
    assert _rel(Q, P) <= 1e-12


@pytest.mark.parametrize("kw,err", [
    (dict(krylov="cgnr"), NotImplementedError),
    (dict(krylov="gmres"), NotImplementedError),
    (dict(Cpt_params=(True, {})), NotImplementedError),
    (dict(prefilter={"theta": 0.1}), NotImplementedError),
    (dict(postfilter={"k": 3}), NotImplementedError),
    (dict(krylov="bicg"), ValueError),
    (dict(weighting="other"), ValueError),
], ids=["cgnr", "gmres", "Cpt_params", "prefilter", "postfilter", "krylov",
        "weighting"])
def test_energy_options_outside_the_port_raise(kw, err, request):
    """(The root-node form and the filters raised until the root-node slice
    ported them, CGNR and GMRES until the nonsymmetric slice: they now give
    the JAX package's P; test_torch_rootnode.py holds the root-node
    hierarchies level by level, test_torch_nonsymmetric.py the CGNR and
    GMRES forms.)"""
    A, C, T, Bc = _pieces(grid=(6, 6))
    if request.node.callspec.id in ("cgnr", "gmres", "Cpt_params",
                                    "prefilter", "postfilter"):
        if "Cpt_params" in kw:
            # the root-node pieces of rootnode_solver's first level
            _, B = linear_elasticity((6, 6))
            AggOp, roots = standard_aggregation(C)
            T, _ = fit_candidates(AggOp, B[:, :2])
            params = utils.get_Cpt_params(A, roots, AggOp, T)
            T = utils.scale_T(T, params["P_I"], params["I_F"], blocksize=2)
            Bc = np.asarray(params["P_I"].T @ B)
            kw = dict(Bf=B, Cpt_params=(True, params))
        P = smooth.energy_prolongation_smoother(A, T, C, Bc, **kw)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_core, "have_native", lambda: True)
            J = jax_smooth.energy_prolongation_smoother(A, T, C, Bc, **kw)
        assert P.nnz == J.nnz and _rel(P, J) <= 1e-12
        return
    with pytest.raises(err, match="ROADMAP" if err is NotImplementedError
                       else "krylov|weighting"):
        smooth.energy_prolongation_smoother(A, T, C, Bc, **kw)


# ---------------------------------------------------------------------------
# the energy hierarchy
# ---------------------------------------------------------------------------

ENERGY = dict(max_coarse=20, smooth=("energy", {"maxiter": 2}))


def _energy_pair(grid, native=True):
    """Both packages' energy hierarchies of the same matrix; ``native``
    patches the JAX package's ``have_native`` to True (else its library
    state decides, as the port's does)."""
    A, B = linear_elasticity(grid)
    J, JB = jax_elasticity(grid)
    ours = pyamg_tpu_torch.smoothed_aggregation_solver(A, B=B, device="cpu",
                                                       **ENERGY)
    with pytest.MonkeyPatch.context() as mp:
        if native:
            mp.setattr(jax_core, "have_native", lambda: True)
        ref = pyamg_tpu.smoothed_aggregation_solver(J, B=JB, **ENERGY)
    return A, ours, ref


@pytest.fixture(scope="module")
def energy_pair():
    return _energy_pair((24, 24))


def test_energy_hierarchy_matches_jax_level_by_level(energy_pair):
    A, ours, ref = energy_pair
    assert_blocked_hierarchies_match(ours, ref)
    assert len(ours.levels) >= 3
    assert [lvl.blocksize for lvl in ours.levels] == \
        [2] + [3] * (len(ours.levels) - 1)
    lvl0 = ours.levels[0]
    # level 0 (K = 3 on q = 2 dofs per node): A flattened to scalar DIA,
    # P and R without an aggregate-root embedding
    assert type(lvl0.A).__name__ == "SparseDIA"
    assert getattr(lvl0, "root_dofs", None) is None
    assert ours.levels[1].A_bsr.blocksize == (3, 3)
    assert ours.operator_complexity() < 1.4


def test_energy_cg_iterations_match_jax(energy_pair):
    A, ours, ref = energy_pair
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    counts = []
    for ml in (ours, ref):
        res = []
        ml.solve(b, tol=1e-8, accel="cg", maxiter=100, residuals=res)
        counts.append(len(res) - 1)
    assert counts[0] == counts[1] and counts[0] <= 20


def test_energy_hierarchy_without_host_libraries(monkeypatch):
    monkeypatch.setattr(amg_core, "_lib", False)
    monkeypatch.setattr(jax_core, "_lib", False)
    A, ours, ref = _energy_pair((14, 14), native=False)
    assert not amg_core.have_native() and not jax_core.have_native()
    assert_blocked_hierarchies_match(ours, ref)


def test_energy_float32_solve_mp():
    """The elasticity cell's call at a small size: float32 operators,
    ``solve_mp`` to 1e-10 with the cell's round limits."""
    A, B = linear_elasticity((20, 20))
    ml = pyamg_tpu_torch.smoothed_aggregation_solver(
        A, B=B, max_coarse=20, smooth=("energy", {"maxiter": 2}),
        op_dtype=torch.float32, device="cpu")
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    x, info = ml.solve_mp(b, tol=1e-10, inner_maxiter=80, max_rounds=8,
                          return_info=True)
    assert np.linalg.norm(b - A @ x.numpy()) <= 5e-10 * np.linalg.norm(b)
    assert info["inner_iterations"] <= 25
