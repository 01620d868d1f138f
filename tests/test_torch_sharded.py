"""The port's solve over several ranks against the JAX package.

One group of 8 gloo CPU ranks (``pyamg_tpu_torch.parallel.launch``) runs
every case of ``sharded_workers.solve_cases``: the cases and sizes of
``tests/test_parallel.py`` (``TestSharded``,
``TestShardedSmootherFidelity``, ``TestShardedBlockHierarchies``,
``TestHaloELL``) through ``shard_solver`` and ``shard_structured_solver``,
and ``cgnr`` on a sharded nonsymmetric hierarchy.  Each test holds one
case against the JAX package's unsharded solve of the same problem (x to
1e-8, the same number of residuals; the JAX references run while the
ranks do) or against the JAX package's ``HaloELL`` on its 8-device CPU mesh
(1e-13); every solve is also held against the unsharded port's solve
of the same hierarchy.  The port's setups build the same hierarchies as
the JAX package's here (its unsharded solves agree to 1e-14), so a fault
shared by the port's setup and its sharded solve shows against JAX.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import scipy.sparse as sp

import jax

import pyamg_tpu
import sharded_workers
from pyamg_tpu.gallery import (diffusion_stencil_2d, linear_elasticity,
                               stencil_grid)
from pyamg_tpu.gallery import poisson as jax_poisson
from pyamg_tpu.relaxation.smoothing import change_smoothers
from pyamg_tpu_torch.parallel import launch

ND = 8


def _rhs(n, seed):
    return np.random.default_rng(seed).standard_normal(n)


def _conv(res):
    res = np.asarray(res)
    return (res[-1] / res[0]) ** (1.0 / max(len(res) - 1, 1))


def _halo_inputs():
    """A, P and P^T of the JAX package's SA hierarchy of 40 x 37 Poisson,
    with x vectors padded to a multiple of the ranks."""
    A = jax_poisson((40, 37), format="csr")
    P = pyamg_tpu.smoothed_aggregation_solver(A, max_coarse=20) \
        .levels[0].P_csr
    mats = [sp.csr_matrix(A), sp.csr_matrix(P), P.T.tocsr()]
    rng = np.random.default_rng(3)
    xs = []
    for M in mats:
        x = np.zeros(-(-M.shape[1] // ND) * ND)
        x[:M.shape[1]] = rng.standard_normal(M.shape[1])
        xs.append(x)
    return mats, xs


def _solved(ml, b, **kw):
    res = []
    x = ml.solve(b, residuals=res, **kw)
    return np.asarray(x), res


def _with_smoothers(ml, smoother):
    change_smoothers(ml, smoother, smoother)
    return ml


def _references():
    """The JAX package's unsharded solves, ``{case: (x, residuals)}``
    (with :func:`_block_references`, of every solve case), and its
    8-device HaloELL matvecs.  The ranks also make the unsharded port's
    solves (``<case>_one``)."""
    from jax.sharding import NamedSharding, PartitionSpec
    from pyamg_tpu.parallel import make_mesh
    from pyamg_tpu.parallel.halo import build_halo_ell
    from pyamg_tpu.parallel.sharding import _pad_ell, pad_to
    from pyamg_tpu.sparse import SparseELL

    sa = pyamg_tpu.smoothed_aggregation_solver
    kw10 = dict(tol=1e-10, maxiter=40)
    refs = {}
    A = jax_poisson((31, 33), format="csr")
    refs["sa_31x33"] = _solved(sa(A, max_coarse=20), _rhs(A.shape[0], 0),
                               **kw10)
    A = jax_poisson((24, 24), format="csr")
    refs["rs_24_cg"] = _solved(pyamg_tpu.ruge_stuben_solver(A, max_coarse=20),
                               _rhs(A.shape[0], 1), accel="cg", **kw10)
    A = jax_poisson((48, 48), format="csr")
    ml = sa(A, max_coarse=50, improve_candidates=None)
    refs["struct_rows"] = [lvl.A.shape[0] for lvl in ml.levels]
    for accel, kw in STRUCT_ACCELS:
        refs[f"struct_{accel}"] = _solved(ml, _rhs(A.shape[0], 3),
                                          accel=accel, **kw)
    refs["axis_x"] = _solved(ml, _rhs(A.shape[0], 0), tol=1e-10, maxiter=50,
                             accel="cg")
    for case, shape, axis, mc, seed in ZEBRA:
        A = jax_poisson(shape, format="csr")
        ml = _with_smoothers(
            sa(A, max_coarse=mc, max_levels=2, improve_candidates=None),
            ("zebra", {"axis": axis}))
        refs[case] = _solved(ml, _rhs(A.shape[0], seed), **kw10)
    mesh = make_mesh(ND)
    mats, xs = _halo_inputs()
    refs["halo"] = []
    for M, x in zip(mats, xs):
        n_pad, m_pad = pad_to(M.shape[0], ND), pad_to(M.shape[1], ND)
        H = build_halo_ell(_pad_ell(SparseELL.from_scipy(M), n_pad, m_pad),
                           mesh, "rows", force=True)
        xd = jax.device_put(x, NamedSharding(mesh, PartitionSpec("rows")))
        refs["halo"].append((np.asarray(H.matvec(xd)), H.to_scipy(),
                             H.halo_width))
    return refs


def _block_references():
    """The JAX package's unsharded solves of the smoother and block
    cases (a second thread of references)."""
    sa = pyamg_tpu.smoothed_aggregation_solver
    refs = {}
    for case, shape, smoother, seed, _ in SMOOTHERS:
        A = jax_poisson(shape, format="csr")
        ml = _with_smoothers(sa(A, max_coarse=30, improve_candidates=None),
                             smoother)
        refs[case] = _solved(ml, _rhs(A.shape[0], seed), tol=1e-8,
                             maxiter=60)
    E, B = linear_elasticity((16, 16))
    refs["elasticity_16"] = _solved(sa(E, B=B, max_coarse=40),
                                    _rhs(E.shape[0], 0), tol=1e-8,
                                    maxiter=40)
    sten = diffusion_stencil_2d(epsilon=0.01, theta=0.0, type="FD")
    A = stencil_grid(sten, (24, 24), format="csr")
    B, b = _multicandidate(A.shape[0])
    refs["multicand_24"] = _solved(
        sa(A, B=B, max_coarse=30, improve_candidates=None), b, tol=1e-8,
        maxiter=40)
    return refs


def _multicandidate(n):
    """B (ones and a random column) and b of the multi-candidate case."""
    rng = np.random.default_rng(1)
    B = np.stack([np.ones(n), rng.random(n)], axis=1)
    return B, rng.standard_normal(n)


ZEBRA = [("zebra_32x8", (32, 8), 0, 400, 0),
         ("zebra_31x7", (31, 7), 0, 100, 4),
         ("zebra_17x5", (17, 5), 1, 30, 5)]
STRUCT_ACCELS = [("cg", dict(tol=1e-10, maxiter=50)),
                 ("gmres", dict(tol=1e-10, maxiter=50)),
                 ("fgmres", dict(tol=1e-10, maxiter=50)),
                 (None, dict(tol=1e-8, maxiter=60))]
SMOOTHERS = [("jacobi_ne_24", (24, 24), "jacobi_ne", 1, "SmootherData"),
             ("schwarz_16", (16, 16), "schwarz", 2, "WholeVectorSmoother")]


@pytest.fixture(scope="module")
def run():
    """The ranks' results and the JAX references, computed while the
    ranks run."""
    B, b = _multicandidate(24 * 24)
    mats, xs = _halo_inputs()
    inputs = dict(multicand_B=B, multicand_b=b, halo_mats=mats, halo_x=xs)
    with ThreadPoolExecutor(2) as pool:
        ranks = pool.submit(launch, sharded_workers.solve_cases, ND, "gloo",
                            "cpu", args=(inputs,), timeout=600)
        more = pool.submit(_block_references)
        refs = _references()
        refs.update(more.result())
        return ranks.result(), refs


def _same_on_every_rank(ranks, key):
    x0 = ranks[0][key][0]
    assert all(np.array_equal(r[key][0], x0) for r in ranks)
    return ranks[0][key]


def _hold(got, ref, atol=1e-8):
    """x to ``atol`` and the same residual count as the JAX package's
    unsharded solve; returns both histories."""
    (x, res), (x_ref, res_ref) = got, ref
    assert len(res) == len(res_ref)
    np.testing.assert_allclose(x, x_ref, rtol=0, atol=atol)
    return res, res_ref


def test_sharded_solve_matches_single(run):
    ranks, refs = run
    res, res_ref = _hold(_same_on_every_rank(ranks, "sa_31x33"),
                         refs["sa_31x33"])
    assert abs(_conv(res) - _conv(res_ref)) < 1e-6
    assert all(s % ND == 0 for s in ranks[0]["sa_31x33_sizes"])


def test_sharded_cg_with_a_callback(run):
    """A callback gets the whole iterate, once, with the result: padded
    to the ranks, as the JAX package's ShardedSolver passes it."""
    ranks, refs = run
    x, seen = ranks[0]["sa_31x33_callback"]
    A = jax_poisson((31, 33), format="csr")
    ml = pyamg_tpu.smoothed_aggregation_solver(A, max_coarse=20)
    ref = []
    x_ref = ml.solve(_rhs(A.shape[0], 0), tol=1e-10, maxiter=40, accel="cg",
                     callback=ref.append)
    assert len(seen) == len(ref) == 1 and seen[0].shape == (1024,)
    np.testing.assert_array_equal(seen[0][:x.shape[0]], x)
    np.testing.assert_allclose(x, np.asarray(x_ref), atol=1e-8)


def test_sharded_accel_cg(run):
    ranks, refs = run
    _hold(ranks[0]["rs_24_cg"], refs["rs_24_cg"])
    A = jax_poisson((24, 24), format="csr")
    b = _rhs(A.shape[0], 1)
    x = ranks[0]["rs_24_cg"][0]
    assert np.linalg.norm(b - A @ x) < 1e-8 * np.linalg.norm(b)
    assert ranks[0]["rs_24_types"][0] in ("HaloELL", "GatherELL")


@pytest.mark.parametrize("accel", ["cg", "gmres", "fgmres", None])
def test_structured_sharded_matches_single(run, accel):
    """Every accel against the JAX package's unsharded solve and the
    unsharded port's."""
    ranks, refs = run
    got = _same_on_every_rank(ranks, f"struct_{accel}")
    _hold(got, refs[f"struct_{accel}"])
    _hold(got, ranks[0][f"struct_{accel}_one"])
    # the JAX package's placement: n % 8 == 0 and n >= min_shard_rows
    assert ranks[0]["struct_placement"] == [
        (n, n % ND == 0 and n >= 256) for n in refs["struct_rows"]]
    assert ranks[0]["struct_levels_untouched"]


def test_structured_sharded_refuses_other_accels(run):
    assert "supports accel" in run[0][0]["struct_cr"]


def test_mesh_sizes(run):
    ranks, _ = run
    assert [r["mesh4"] for r in ranks] == [(4, r) for r in range(4)] \
        + [(4, None)] * 4
    assert ranks[0]["mesh_too_many"] == "requested 1000000 devices, have 8"


def test_custom_mesh_axis_adopted(run):
    ranks, refs = run
    ax_s, ax_p, x2, x3 = ranks[0]["axis_x"]
    assert ax_s == ax_p == "x"
    np.testing.assert_allclose(x2, refs["axis_x"][0], atol=1e-8)
    np.testing.assert_allclose(x3, refs["axis_x"][0], atol=1e-6)


@pytest.mark.parametrize("case,size0", [
    ("zebra_32x8", 256),
    ("zebra_31x7", 224),       # lcm(8, slab 7) quantum
    ("zebra_17x5", 120),       # lcm(8, slab 5) quantum
], ids=["zebra", "padded zebra axis 0", "padded zebra axis 1"])
def test_sharded_zebra_matches_single(run, case, size0):
    ranks, refs = run
    res, res_ref = _hold(_same_on_every_rank(ranks, case), refs[case])
    assert abs(_conv(res) - _conv(res_ref)) < 1e-6
    assert ranks[0][case + "_sizes"][0] == size0


@pytest.mark.parametrize("case,form", [(c[0], c[4]) for c in SMOOTHERS],
                         ids=["jacobi_ne", "schwarz"])
def test_sharded_smoother_matches_single(run, case, form):
    """Against the JAX package's unsharded solve and the unsharded
    port's."""
    ranks, refs = run
    got = _same_on_every_rank(ranks, case)
    res, res_ref = _hold(got, refs[case])
    assert abs(_conv(res) - _conv(res_ref)) < 1e-6
    _hold(got, ranks[0][case + "_one"])
    assert ranks[0][case + "_kinds"][0] == form


def test_sharded_elasticity_matches_single(run):
    """The matrix's entries reach 2.3e5, so x is small and is held to
    1e-8 of its largest entry."""
    ranks, refs = run
    got = _same_on_every_rank(ranks, "elasticity_16")
    atol = 1e-8 * np.abs(refs["elasticity_16"][0]).max()
    res, res_ref = _hold(got, refs["elasticity_16"], atol=atol)
    assert abs(_conv(res) - _conv(res_ref)) < 1e-6
    _hold(got, ranks[0]["elasticity_16_one"], atol=atol)


def test_sharded_multicandidate_matches_single(run):
    ranks, refs = run
    got = _same_on_every_rank(ranks, "multicand_24")
    _hold(got, refs["multicand_24"])
    _hold(got, ranks[0]["multicand_24_one"])


@pytest.mark.parametrize("which", [0, 1, 2], ids=["A", "P", "P^T"])
def test_halo_ell_matches_the_jax_halo_ell(run, which):
    ranks, refs = run
    mats, xs = _halo_inputs()
    M, x = mats[which], xs[which]
    got = ranks[0]["halo"][which]
    yj, Sj, Hj = refs["halo"][which]
    n_pad, m_pad = -(-M.shape[0] // ND) * ND, -(-M.shape[1] // ND) * ND
    np.testing.assert_allclose(got["pack"], yj, rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(got["gather"], got["pack"], rtol=1e-13,
                               atol=1e-15)
    np.testing.assert_allclose(got["pack"][:M.shape[0]], M @ x[:M.shape[1]],
                               rtol=1e-12, atol=1e-14)
    # to_scipy: the whole padded matrix, exactly, on every rank
    padded = sp.csr_matrix(M.copy())
    padded.resize((n_pad, m_pad))
    assert (got["scipy"] != padded).nnz == 0
    assert (got["scipy"] != Sj).nnz == 0
    # the per-pair exchange receives no more than the JAX pack
    assert max(got["widths"]) <= (ND - 1) * Hj
    Et = padded.T.tocsr()
    np.testing.assert_allclose(got["rmatvec"], Et @ got["y"], rtol=1e-12,
                               atol=1e-13)
    np.testing.assert_allclose(got["rmatvec_gather"], got["rmatvec"],
                               rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(got["matmat"],
                               np.stack([got["pack"], 2 * got["pack"]], 1),
                               rtol=1e-13, atol=1e-15)


@pytest.mark.parametrize("name", ["sa", "rs"])
def test_solve_pack_vs_gather(run, name):
    runs = run[0][0][f"pack_vs_gather_{name}"]
    (xp, rp), (xg, rg) = runs["pack"], runs["gather"]
    assert runs["pack_types"][0] == "HaloELL"
    assert set(runs["gather_types"]) == {"GatherELL"}
    assert len(rp) == len(rg)
    np.testing.assert_allclose(xp, xg, atol=1e-8)
    A = jax_poisson((96, 96), format="csr")
    b = _rhs(A.shape[0], 5)
    assert np.linalg.norm(b - A @ xp) < 1e-8 * np.linalg.norm(b)
    assert runs["pack_exchange"]["bytes"] < runs["gather_exchange"]["bytes"]


def test_fine_level_is_halo(run):
    a_type, p_type, width = run[0][0]["fine_halo"]
    assert a_type == p_type == "HaloELL"
    assert width <= 3 * 96


def test_cgnr_on_a_sharded_nonsymmetric_hierarchy(run):
    ranks, _ = run
    got = ranks[0]["cgnr_recirc"]
    (x1, r1), (x8, r8) = got["one"], got["sharded"]
    assert got["kind"] == "jacobi_nr" and got["AT"] == "HaloELL"
    assert len(r1) == len(r8) > 3
    np.testing.assert_allclose(r8, r1, rtol=1e-8)
    np.testing.assert_allclose(x8, x1, rtol=0, atol=1e-8)
    assert all(np.array_equal(r["cgnr_recirc"]["sharded"][0], x8)
               for r in ranks)
