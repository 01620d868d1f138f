"""The port's ELL-product setups over several ranks against the JAX
package.

One group of 8 gloo CPU ranks (``pyamg_tpu_torch.parallel.launch``) runs
every case of ``sharded_workers.ell_setup_cases``: the general (Jacobi and
energy P), classical (direct, standard, evolution strength), root-node and
adaptive setups built slab by slab over the ranks (the energy, root-node
and adaptive cases over the first 4), each held to the JAX package's mesh
build of the same problem in float64 (``tests/test_parallel.py``'s
``TestDistributedGeneralSetup``, ``TestDistributedClassicalSetup``,
``TestDistributedEnergySetup`` and ``TestDistributedRootnodeAdaptive``,
case for case): every level's host matrix and P to 1e-12 relative, the
same CG count with x to 1e-8; and to the port's own one-device build.
Every rank holds only its rows of each level's A, P and R, and every
rank's host stages give the same patterns (sha256 per level).  The JAX
package's mesh builds run in four processes of their own while the
ranks run.
"""

import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sharded_workers
from pyamg_tpu.gallery import (diffusion_stencil_2d as jax_stencil,
                               poisson as jax_poisson,
                               stencil_grid as jax_grid)
from pyamg_tpu_torch import parallel as par
from pyamg_tpu_torch.gallery import poisson

ND = 8
torch.set_num_threads(1)


def _rel(a, b):
    """Largest entrywise difference of two sparse or dense arrays over
    b's largest entry."""
    d = abs(a - b)
    d = d.max() if sp.issparse(d) else np.max(d)
    scale = abs(b).max()
    return float(d / max(scale, 1e-300))


def _nodiag(n):
    """n x n Poisson with row 0's diagonal entry removed."""
    A = sp.lil_matrix(jax_poisson((n, n), format="csr"))
    A[0, 0] = 0.0
    A = A.tocsr()
    A.eliminate_zeros()
    return A


def _energy_inputs(n):
    """Level 0 of n x n Poisson for energy smoothing: A, C, T, Bc."""
    from pyamg_tpu.aggregation.aggregate import standard_aggregation
    from pyamg_tpu.aggregation.tentative import fit_candidates
    from pyamg_tpu.strength import symmetric_strength_of_connection

    A = sp.csr_matrix(jax_poisson((n, n), format="csr")).astype(np.float64)
    C = sp.csr_matrix(symmetric_strength_of_connection(A, theta=0.0))
    AggOp, _ = standard_aggregation(C)
    T, Bc = fit_candidates(AggOp, np.ones((A.shape[0], 1)))
    return dict(A=A, C=C, T=sp.csr_matrix(T), Bc=Bc)


# the JAX package's cases, split into groups of about equal build time,
# one process each (its mesh builds compile XLA programs for every level
# and product: ~165 s of one core in all)
JAX_GROUPS = (("rs_evolution_48", "adaptive_32", "rootnode_32"),
              ("rs_standard_48", "rs_direct_48"),
              ("energy_32", "rs_32", "general_48"),
              ("rootnode_24", "elasticity_16", "multicand_48", "nodiag_32",
               "energy_P_24", "rs_evolution_host"))


@pytest.fixture(scope="module")
def run():
    """The ranks' results and the JAX package's references, built at the
    same time."""
    inputs = dict(nodiag_32=_nodiag(32), energy_24=_energy_inputs(24))
    spawn = multiprocessing.get_context("spawn")
    with ThreadPoolExecutor(1) as pool, ProcessPoolExecutor(
            len(JAX_GROUPS), mp_context=spawn) as jax_pool:
        refs = [jax_pool.submit(sharded_workers.jax_mesh_references, group,
                                inputs) for group in JAX_GROUPS]
        ranks = pool.submit(par.launch, sharded_workers.ell_setup_cases, ND,
                            "gloo", "cpu", args=(inputs,), timeout=900)
        ref = {}
        for r in refs:
            ref.update(r.result(timeout=900))
        return ranks.result(), ref, inputs


@pytest.fixture(scope="module")
def ranks(run):
    return run[0]


@pytest.fixture(scope="module")
def jax_ref(run):
    return run[1]


def _one_device(name, inputs):
    """The port's one-device build of a case (the test process has no
    process group: one rank)."""
    f64 = np.float64
    kw = dict(device="cpu", dtype=f64)
    A = sp.csr_matrix(poisson((48, 48), format="csr"))
    P32 = poisson((32, 32), format="csr")
    builds = {
        "general_48": lambda: par.general_sa_setup_sharded(A, **kw),
        "rs_evolution_48": lambda: par.classical_setup_sharded(
            jax_grid(jax_stencil(epsilon=0.01, theta=np.pi / 4, type="FD"),
                     (48, 48), format="csr"), interpolation="standard",
            max_coarse=50, strength=("evolution", {"k": 2, "epsilon": 4.0}),
            **kw),
        "energy_32": lambda: par.general_sa_setup_sharded(
            P32, max_coarse=20, smooth=("energy", {"maxiter": 4}), **kw),
        "rootnode_32": lambda: par.rootnode_setup_sharded(
            P32, max_coarse=20, **kw),
        "adaptive_32": lambda: par.adaptive_sa_setup_sharded(
            P32, max_coarse=20, num_candidates=1, candidate_iters=10, **kw),
    }
    return builds[name]()


def _hold_levels(got, want, tol=1e-12):
    """Every level's host matrix and P (cut to the unpadded sizes) of
    ``got`` within ``tol`` relative of ``want``'s."""
    assert len(got["A"]) == len(want["A"])
    for i, (a, b) in enumerate(zip(got["A"], want["A"])):
        assert a.shape == b.shape, f"level {i}"
        assert _rel(a, b) <= tol, f"level {i} A {_rel(a, b)}"
    for i, (p, q) in enumerate(zip(got["P"], want["P"])):
        n, nc = want["A"][i].shape[0], want["A"][i + 1].shape[0]
        p, q = p.tocsr()[:n, :nc], q.tocsr()[:n, :nc]
        assert _rel(p, q) <= tol, f"level {i} P {_rel(p, q)}"


def _hold_solve(got, want):
    (x, res), (x_ref, res_ref) = got["solve"], want["solve"]
    assert len(res) == len(res_ref)
    np.testing.assert_allclose(x, x_ref, rtol=0, atol=1e-8)


ALL = ["general_48", "nodiag_32", "elasticity_16", "multicand_48",
       "rs_direct_48", "rs_standard_48", "rs_evolution_48", "rs_32",
       "energy_32", "rootnode_32", "rootnode_24", "adaptive_32"]


@pytest.mark.parametrize("name", ALL)
def test_every_rank_holds_its_rows_and_the_same_patterns(ranks, name):
    """No rank's device holds more rows of a level's A, P or R than its
    slab, every product reads fewer rows of B than the whole, and every
    rank's host stages give the same levels (sha256 per level)."""
    members = [r[name] for r in ranks if name in r]
    assert len(members) == (4 if name in ("energy_32", "rootnode_32",
                                          "rootnode_24", "adaptive_32")
                            else ND)
    for rec in members:
        assert rec["hashes"] == [members[0]["hashes"][0]] * len(members)
        for lvl in rec["slabs"]:
            assert lvl["n"] == lvl["nl"] * len(members)
            assert lvl["A"][1] == lvl["nl"]
            for op in ("P", "R"):
                if op in lvl:
                    assert lvl[op][0] in ("HaloELL", "GatherELL")
                    assert lvl[op][1] == lvl[op][2]
        first = rec["routes"][0]          # level 0's first product
        assert first["fetch"] != "local"
        assert first["b_rows"] < first["b_total"]


def test_a_rank_outside_the_mesh_raises(ranks):
    """A setup over the first 4 ranks, called on the others, raises before
    any collective."""
    assert all("outside_mesh" not in r for r in ranks[:4])
    for r in ranks[4:]:
        assert "not a member of the mesh" in r["outside_mesh"]


# -- TestDistributedGeneralSetup ----------------------------------------------

def test_rap_matches_triple_product(ranks, jax_ref):
    got = ranks[0]["general_48"]
    n, nc = got["A"][0].shape[0], got["A"][1].shape[0]
    P = got["P"][0].tocsr()[:n, :nc]
    assert _rel(got["A"][1], (P.T @ got["A"][0] @ P).tocsr()) < 1e-12
    _hold_levels(got, jax_ref["general_48"])


def test_device_counts_agree(ranks, run):
    got = ranks[0]["general_48"]
    one = _one_device("general_48", run[2])
    _hold_levels(got, dict(A=[lvl.A_csr for lvl in one.levels],
                           P=[lvl.P.to_scipy() for lvl in one.levels[:-1]]))


def test_operators_stay_sharded(ranks):
    for r in ranks:
        got = r["general_48"]
        assert got["types"][0] == "HaloELL"
        nl = [lvl["nl"] for lvl in got["slabs"]]
        assert nl[0] == 2304 // ND and nl[1] == got["sizes"][1] // ND


def test_solves(ranks, jax_ref):
    got = ranks[0]["general_48"]
    x, res = got["solve"]
    A = sp.csr_matrix(poisson((48, 48), format="csr"))
    b = A @ np.random.default_rng(0).random(A.shape[0])
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-7
    assert (res[-1] / res[0]) ** (1.0 / (len(res) - 1)) < 0.3
    _hold_solve(got, jax_ref["general_48"])
    assert all(np.array_equal(r["general_48"]["solve"][0], x) for r in ranks)


def test_row_without_stored_diagonal(ranks, jax_ref, run):
    got = ranks[0]["nodiag_32"]
    A = run[2]["nodiag_32"]
    n, nc = A.shape[0], got["A"][1].shape[0]
    P = got["P"][0].tocsr()[:n, :nc]
    assert abs(P[0]).sum() > 0          # not silently zeroed
    assert _rel(got["A"][1], (P.T @ A @ P).tocsr()) < 1e-12
    _hold_levels(got, jax_ref["nodiag_32"])


def test_elasticity_rbm_candidates(ranks, jax_ref):
    got = ranks[0]["elasticity_16"]
    _hold_levels(got, jax_ref["elasticity_16"])
    E = got["A"][0]
    x, _ = got["solve"]
    b = np.random.default_rng(0).standard_normal(E.shape[0])
    assert np.linalg.norm(b - E @ x) / np.linalg.norm(b) < 1e-7
    _hold_solve(got, jax_ref["elasticity_16"])


def test_multiple_candidates_jacobi_smoother(ranks, jax_ref):
    got = ranks[0]["multicand_48"]
    _hold_levels(got, jax_ref["multicand_48"])
    _hold_solve(got, jax_ref["multicand_48"])


# -- TestDistributedClassicalSetup --------------------------------------------

@pytest.mark.parametrize("name", ["rs_direct_48", "rs_standard_48"],
                         ids=["direct", "standard"])
def test_classical_matches_the_jax_mesh_build(ranks, jax_ref, name):
    got = ranks[0][name]
    _hold_levels(got, jax_ref[name])
    if name == "rs_direct_48":
        assert len(got["solve"][1]) - 1 <= 12     # classical AMG on Poisson
        _hold_solve(got, jax_ref[name])


def test_evolution_strength_matches_host_build(ranks, jax_ref, run):
    got = ranks[0]["rs_evolution_48"]
    _hold_levels(got, jax_ref["rs_evolution_48"])
    one = _one_device("rs_evolution_48", run[2])
    _hold_levels(got, dict(A=[lvl.A_csr for lvl in one.levels],
                           P=[lvl.P.to_scipy() for lvl in one.levels[:-1]]))
    host = jax_ref["rs_evolution_host"]["A"]       # the JAX host build
    assert len(got["A"]) == len(host)
    for i, (a, h) in enumerate(zip(got["A"], host)):
        assert _rel(a, h) < 1e-12, f"level {i} vs the host build"
    _hold_solve(got, jax_ref["rs_evolution_48"])


def test_classical_operators_stay_sharded(ranks, jax_ref):
    for r in ranks:
        got = r["rs_32"]
        assert [lvl["nl"] * ND for lvl in got["slabs"]] == got["sizes"]
    _hold_levels(ranks[0]["rs_32"], jax_ref["rs_32"])


# -- TestDistributedEnergySetup -----------------------------------------------

def test_energy_P_matches_host_flat_path(ranks, jax_ref, run):
    got, want = ranks[0]["energy_P_24"], jax_ref["energy_P_24"]
    n, nc = run[2]["energy_24"]["T"].shape
    P = got["P"].tocsr()[:n, :nc]
    assert got["rows"] == -(-n // 4)           # this rank's rows only
    assert abs(got["pattern"] - want["pattern"]).max() == 0
    assert _rel(P, want["P"].tocsr()[:n, :nc]) <= 1e-12
    assert _rel(P, want["host"]) < 1e-9


@pytest.mark.parametrize("name", ["energy_32"])
def test_mesh_count_consistency_and_solve(ranks, jax_ref, run, name):
    _hold_mesh_4(ranks, jax_ref, run, name, max_iters=14)


# -- TestDistributedRootnodeAdaptive ------------------------------------------

def _hold_mesh_4(ranks, jax_ref, run, name, max_iters=None):
    """A case over 4 ranks: the JAX package's mesh-4 build and solve, the
    port's one-device build and its CG count."""
    got = ranks[0][name]
    _hold_levels(got, jax_ref[name])
    one = _one_device(name, run[2])
    _hold_levels(got, dict(A=[lvl.A_csr for lvl in one.levels],
                           P=[lvl.P.to_scipy() for lvl in one.levels[:-1]]))
    x, res = got["solve"]
    A = poisson((32, 32), format="csr")
    b = np.ones(A.shape[0])
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-9
    if max_iters is not None:
        assert len(res) - 1 <= max_iters
    ref = []
    one.solve(b, tol=1e-10, accel="cg", maxiter=200, residuals=ref)
    assert len(res) == len(ref)
    _hold_solve(got, jax_ref[name])


def test_rootnode_mesh_consistency_and_quality(ranks, jax_ref, run):
    _hold_mesh_4(ranks, jax_ref, run, "rootnode_32", max_iters=14)


def test_rootnode_rap_is_galerkin(ranks, jax_ref):
    got = ranks[0]["rootnode_24"]
    n, nc = got["A"][0].shape[0], got["A"][1].shape[0]
    P = got["P"][0].tocsr()[:n, :nc]
    Ac = got["A"][1]
    assert _rel(Ac, (P.T @ got["A"][0] @ P).tocsr()) < 1e-11
    _hold_levels(got, jax_ref["rootnode_24"])


def test_adaptive_mesh_consistency(ranks, jax_ref, run):
    _hold_mesh_4(ranks, jax_ref, run, "adaptive_32")
