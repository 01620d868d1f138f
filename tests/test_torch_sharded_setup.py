"""The port's structured setup over several ranks against the JAX package.

One group of 8 gloo CPU ranks (``pyamg_tpu_torch.parallel.launch``) runs
every case of ``sharded_workers.setup_cases``:
``structured_sa_setup_sharded`` built over the ranks, held level by level
against the JAX package's 8-device build (``tests/test_parallel.py``,
``TestDistributedSetup``; both power iterations started from the JAX
package's vector) to 1e-12 relative with its per-level placement, and
against the port's one-device build; its solves (CG, BiCGStab, GMRES,
stand-alone cycles, ``solve_mp``) against the one-device port's; and the
sharded DIA matvec and transpose and grid transfers against their
one-device forms.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import sharded_workers
from pyamg_tpu.gallery import poisson as jax_poisson
from pyamg_tpu.parallel import structured_sa_setup_sharded as jax_sharded
from pyamg_tpu_torch.aggregation import device_setup
from pyamg_tpu_torch.gallery import poisson
from pyamg_tpu_torch.parallel import launch, structured_sa_setup_sharded

ND = 8


def _jax_start(n):
    """The JAX package's start vector of ``device_power_rho``."""
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (n,),
                                      dtype=jnp.float64))


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _ops_inputs():
    """A random 9-offset DIA operator on a 24 x 24 grid and random
    vectors for the sharded operators."""
    rng = np.random.default_rng(11)
    grid = (24, 24)
    n, nc = 576, 64
    offsets = (-25, -24, -23, -1, 0, 1, 23, 24, 25)
    return dict(diags=rng.standard_normal((len(offsets), n)),
                offsets=offsets, x=rng.standard_normal(n), grid=grid,
                wmap=rng.random(n) + 0.5, xc=rng.standard_normal(nc))


@pytest.fixture(scope="module")
def run():
    """The ranks' results, and the JAX package's 8-device build of 48^2
    Poisson made while the ranks run."""
    inputs = dict(jax_starts={n: _jax_start(n) for n in (2304, 256)},
                  ops=_ops_inputs())
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch, sharded_workers.setup_cases, ND, "gloo",
                            "cpu", args=(inputs,), timeout=600)
        A = jax_poisson((48, 48), format="csr")
        ref = jax_sharded(A, (48, 48), n_devices=ND, dtype=jnp.float64)
        return ranks.result(), ref


@pytest.fixture(scope="module")
def ranks(run):
    return run[0]


@pytest.fixture(scope="module")
def jax_48(run):
    return run[1]


def test_sharded_setup_matches_the_jax_8_device_build(ranks, jax_48):
    got = ranks[0]["setup_48"]
    assert len(got) == len(jax_48.levels) == 3
    for i, ((diags, offsets, sharded), lvl) in enumerate(
            zip(got, jax_48.levels)):
        assert offsets == lvl.A.offsets, f"level {i} offsets"
        assert _rel(diags, np.asarray(lvl.A.diags)) < 1e-12, f"level {i}"
        # the JAX placement: row-sharded while n % 8 == 0
        spec = tuple(lvl.A.diags.sharding.spec)
        assert sharded == (spec == (None, "rows")), f"level {i} {spec}"
    assert [s for _, _, s in got] == [True, True, False]
    assert all(np.array_equal(r["setup_48"][1][0], got[1][0])
               for r in ranks)


def test_sharded_setup_solves(ranks):
    x, res = ranks[0]["solve_48x24"]
    assert res[-1] / res[0] < 1e-6
    A = poisson((48, 24), format="csr")
    ml = structured_sa_setup_sharded(A, (48, 24), max_coarse=20,
                                     device="cpu")
    ref = []
    ml.solve(np.random.default_rng(0).standard_normal(A.shape[0]),
             tol=1e-6, maxiter=40, accel="cg", residuals=ref)
    assert len(res) == len(ref)


@pytest.fixture(scope="module")
def one_device_48():
    A = poisson((48, 48), format="csr")
    ml = structured_sa_setup_sharded(A, (48, 48), dtype=np.float64,
                                     device="cpu")
    return A, ml, A @ np.random.default_rng(0).random(A.shape[0])


def test_sharded_setup_matches_the_one_device_build(ranks, one_device_48):
    _, ml, _ = one_device_48
    got = ranks[0]["f64_48"]
    assert len(got) == len(ml.levels)
    for (diags, offsets, _), lvl in zip(got, ml.levels):
        assert offsets == lvl.A.offsets
        assert _rel(diags, lvl.A.diags.numpy()) < 1e-12


@pytest.mark.parametrize("accel", ["cg", "bicgstab", "gmres", None])
def test_sharded_setup_solves_as_the_one_device_build(ranks, one_device_48,
                                                      accel):
    A, ml, b = one_device_48
    x, res = ranks[0][f"f64_48_{accel}"]
    ref = []
    x_ref = ml.solve(b, tol=1e-8, maxiter=60, accel=accel, residuals=ref)
    assert len(res) == len(ref)
    np.testing.assert_allclose(res, ref, rtol=1e-8)
    np.testing.assert_allclose(x, x_ref.numpy(), rtol=0, atol=1e-8)
    assert all(np.array_equal(r[f"f64_48_{accel}"][0], x) for r in ranks)


def test_sharded_setup_solve_mp(ranks, one_device_48):
    A, ml, b = one_device_48
    x, info = ranks[0]["f64_48_mp"]
    x_ref, info_ref = ml.solve_mp(b, tol=1e-10, return_info=True)
    assert info == info_ref
    np.testing.assert_allclose(x, x_ref.numpy(), rtol=0, atol=1e-8)
    assert np.linalg.norm(b - A @ x) <= 1e-10 * np.linalg.norm(b)


def test_exchange_counts_of_a_cg_solve(ranks):
    x, res = ranks[0]["f64_48_cg_again"]
    count = ranks[0]["f64_48_exchange"]
    # every iteration exchanges halos and reduces, and fewer bytes move
    # than the whole fine vectors would
    assert count["collectives"] > 3 * (len(res) - 1)
    assert 0 < count["bytes"] < (len(res) - 1) * 2304 * 8 * 10


def test_shard_structured_solver_over_a_setup_built_over_ranks(
        ranks, one_device_48):
    A, ml, b = one_device_48
    placement, (x, res) = ranks[0]["f64_48_resharded"]
    assert placement == [(2304, True), (256, True), (36, False)]
    ref = []
    x_ref = ml.solve(b, tol=1e-8, maxiter=60, accel="cg", residuals=ref)
    assert len(res) == len(ref)
    np.testing.assert_allclose(x, x_ref.numpy(), rtol=0, atol=1e-8)


def test_sharded_setup_3d(ranks):
    A = poisson((12, 12, 12), format="csr")
    ml = structured_sa_setup_sharded(A, (12, 12, 12), dtype=np.float64,
                                     max_coarse=50, device="cpu")
    got = ranks[0]["grid_12c"]
    assert len(got) == len(ml.levels) >= 3
    for (diags, offsets, sharded), lvl in zip(got, ml.levels):
        assert offsets == lvl.A.offsets
        assert _rel(diags, lvl.A.diags.numpy()) < 1e-12
        assert sharded == (lvl.A.shape[0] % ND == 0)


def test_sharded_setup_over_a_mesh_of_the_first_ranks(ranks):
    got = ranks[0]["setup_48_on_4"]
    assert all("setup_48_on_4" not in r for r in ranks[4:])
    # 36 rows divide 4 ranks: every level is sharded on 4
    assert [s for _, _, s in got] == [True] * 3
    ref = ranks[0]["f64_48"]
    for (d4, _, _), (d8, _, _) in zip(got, ref):
        assert _rel(d4, d8) < 1e-12


@pytest.mark.parametrize("c_sharded", [True, False],
                         ids=["coarse sharded", "coarse whole"])
def test_sharded_grid_transfers(ranks, c_sharded):
    ops = ranks[0]["ops"]
    got = ops[c_sharded]
    assert got["coarse_sharded"] == c_sharded
    np.testing.assert_array_equal(got["repeat"], ops["repeat_whole"])
    np.testing.assert_allclose(got["pool"], ops["pool_whole"], rtol=1e-13,
                               atol=1e-14)


def test_sharded_dia_matvec_and_transpose(ranks):
    ops = ranks[0]["ops"]
    # the same products in the same order as the whole operator's
    np.testing.assert_array_equal(ops["matvec"], ops["matvec_whole"])
    np.testing.assert_array_equal(ops["transpose"], ops["transpose_whole"])
    assert ops["nnz"][0] == ops["nnz"][1]


def test_sharded_dia_on_the_one_rank_mesh():
    """A slab on the one-rank mesh of a process without a group: nothing
    to exchange, zeros past both ends, offsets shifted by lo."""
    from pyamg_tpu_torch.parallel import make_mesh, Layout
    from pyamg_tpu_torch.sparse.dia import ShardedDIA
    import torch

    mesh = make_mesh(1, device="cpu")
    lay = Layout(mesh, 8, True)
    S = ShardedDIA(torch.ones((3, 8)), (-1, 0, 1), lay)
    assert S.matvec(torch.ones(8)).tolist() == [2.0] + [3.0] * 6 + [2.0]
    assert S.offsets_dev.tolist() == [0, 1, 2]
    assert device_setup.dia_transpose(S).offsets == (-1, 0, 1)
