"""The port's structured device setup, its sharded forms and the
hierarchy checkpoints against the JAX package's.

``pyamg_tpu_torch.aggregation.device_setup`` on a CPU device (its DIA
matvecs then run the kernel's plain twin) is held against
``pyamg_tpu.aggregation.device_setup`` in float64, from the same numpy
inputs.  The power iteration's start vector is the one number stream the
two packages cannot share, so the tests patch the port's
``_power_start`` to return the JAX package's own vector; both then
compute the same rho to round-off:

* ``device_power_rho`` to 1e-12 relative; ``device_smoothing_factor``
  and ``dia_transpose`` exactly, also for an operator without offset 0;
* ``device_rap`` against the JAX function and the scipy triple product;
* ``structured_sa_setup`` level by level at 36^2 and 12^3: offsets
  exactly, diagonals, weights and D^-1 to 1e-12, the color masks exactly,
  the level count and operator complexity; both validation errors; CG's
  count exactly and its history to 1e-10; a hierarchy exported from the
  JAX package and loaded with ``hierarchy_from_numpy`` cycles like it;
* ``structured_sa_setup_sharded`` and ``shard_structured_solver`` on one
  device, and their refusal of several;
* ``save_hierarchy``/``load_hierarchy`` round trips of a host-built, a
  structured and a device-built hierarchy, and files written by either
  package loading in the other with the same CG count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pyamg_tpu
import pyamg_tpu.amg_core as jax_core
from pyamg_tpu.aggregation import device_setup as jds
from pyamg_tpu.gallery import poisson as jax_poisson
from pyamg_tpu.sparse import SparseDIA as JaxDIA
from pyamg_tpu.util import checkpoint as jax_checkpoint
import pyamg_tpu_torch
from pyamg_tpu_torch import parallel
from pyamg_tpu_torch.aggregation import device_setup as tds
from pyamg_tpu_torch.gallery import poisson
from pyamg_tpu_torch.sparse import SparseDIA
from pyamg_tpu_torch.util import load_hierarchy, save_hierarchy
from pyamg_tpu_torch.util.convert import hierarchy_from_numpy

torch.set_num_threads(1)

# (grid, max_coarse): two coarse levels in 2-D, three in 3-D
GRIDS = {"36^2": ((36, 36), 200), "12^3": ((12, 12, 12), 50)}


def _jax_start(n, dtype, seed, device):
    """The JAX package's start vector of ``device_power_rho``, as numpy."""
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), (n,),
                                      dtype=jnp.float64))


@pytest.fixture
def jax_start(monkeypatch):
    monkeypatch.setattr(tds, "_power_start", _jax_start)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _pair(grid):
    """The same DIA operator in both packages (float64)."""
    A = poisson(grid, format="csr")
    return (SparseDIA.from_scipy(A, dtype=np.float64, device="cpu"),
            JaxDIA.from_scipy(jax_poisson(grid, format="csr"),
                              dtype=np.float64))


def _dinv(d):
    return np.where(d != 0, 1.0 / np.where(d != 0, d, 1), 0.0)


def test_device_power_rho_matches_jax(jax_start):
    ours, ref = _pair((27, 27))
    dinv = _dinv(ref.diagonal())
    rho = tds.device_power_rho(ours, torch.from_numpy(np.asarray(dinv)))
    rho_ref = jds.device_power_rho(ref, jnp.asarray(dinv))
    assert rho.dim() == 0
    assert abs(float(rho) - float(rho_ref)) <= 1e-12 * float(rho_ref)


def test_power_start_is_seeded():
    a = tds._power_start(50, torch.float64, 3, "cpu")
    assert torch.equal(a, tds._power_start(50, torch.float64, 3, "cpu"))
    assert not torch.equal(a, tds._power_start(50, torch.float64, 4, "cpu"))


def _without_diagonal(M):
    M = sp.csr_matrix(M - sp.diags(M.diagonal()))
    M.eliminate_zeros()
    return M


@pytest.mark.parametrize("stored_zero", [False, True],
                         ids=["offset 0", "no offset 0"])
def test_smoothing_factor_and_transpose_equal_jax(stored_zero):
    A = poisson((20, 20), format="csr")
    J = jax_poisson((20, 20), format="csr")
    if stored_zero:
        A, J = _without_diagonal(A), _without_diagonal(J)
    ours = SparseDIA.from_scipy(A, dtype=np.float64, device="cpu")
    ref = JaxDIA.from_scipy(J, dtype=np.float64)
    assert (0 in ours.offsets) is not stored_zero
    S = tds.device_smoothing_factor(ours, 0.37)
    S_ref = jds.device_smoothing_factor(ref, 0.37)
    assert S.offsets == tuple(S_ref.offsets)
    assert np.array_equal(S.diags.numpy(), np.asarray(S_ref.diags))
    ST = tds.dia_transpose(S)
    ST_ref = jds.dia_transpose(S_ref)
    assert ST.offsets == tuple(ST_ref.offsets) and ST.shape == ST_ref.shape
    assert np.array_equal(ST.diags.numpy(), np.asarray(ST_ref.diags))
    assert abs(ST.to_scipy() - S.to_scipy().T).max() == 0


@pytest.mark.parametrize("grid", [(27, 27), (12, 12, 12)],
                         ids=["27^2", "12^3"])
def test_device_rap_matches_jax_and_the_triple_product(grid, jax_start):
    A = poisson(grid, format="csr")
    ours = tds.structured_sa_setup(A, grid, dtype=torch.float64,
                                   max_levels=2, device="cpu")
    ref = jds.structured_sa_setup(jax_poisson(grid, format="csr"), grid,
                                  dtype=jnp.float64, max_levels=2)
    lo, lr = ours.levels[0], ref.levels[0]
    cgrid = ours.levels[1].grid
    Ac = tds.device_rap(lo.P, lo.R, lo.A, cgrid)
    Ac_ref = jds.device_rap(lr.P, lr.R, lr.A, cgrid)
    assert Ac.offsets == tuple(Ac_ref.offsets)
    assert len(Ac.offsets) == 3 ** len(grid)
    assert _rel(Ac.diags.numpy(), Ac_ref.diags) <= 1e-12
    explicit = (lo.R.to_scipy() @ lo.A.to_scipy() @ lo.P.to_scipy()).toarray()
    assert _rel(Ac.to_scipy().toarray(), explicit) <= 1e-12


def _setups(name):
    grid, max_coarse = GRIDS[name]
    A = poisson(grid, format="csr")
    ours = tds.structured_sa_setup(A, grid, dtype=torch.float64,
                                   max_coarse=max_coarse, device="cpu")
    ref = jds.structured_sa_setup(jax_poisson(grid, format="csr"), grid,
                                  dtype=jnp.float64, max_coarse=max_coarse)
    return A, ours, ref


@pytest.mark.parametrize("name", list(GRIDS))
def test_structured_setup_matches_jax_level_by_level(name, jax_start):
    A, ours, ref = _setups(name)
    assert len(ours.levels) == len(ref.levels) >= 2
    assert ours.operator_complexity() == pytest.approx(
        ref.operator_complexity(), rel=1e-14)
    for lo, lr in zip(ours.levels, ref.levels):
        assert lo.grid == tuple(lr.grid)
        assert lo.A.offsets == tuple(lr.A.offsets)
        assert _rel(lo.A.diags.numpy(), lr.A.diags) <= 1e-12
        if lr is ref.levels[-1]:
            assert not hasattr(ours.levels[0], "A_csr")
            assert abs(lo.A_csr - lr.A_csr).max() <= 1e-12 * abs(
                lr.A_csr).max()
            continue
        S, T = lo.P.ops
        S_ref, T_ref = lr.P.ops
        assert S.offsets == tuple(S_ref.offsets)
        assert _rel(S.diags.numpy(), S_ref.diags) <= 1e-12
        assert _rel(T.wmap.numpy(), T_ref.wmap) <= 1e-12
        assert _rel(lo.R.ops[1].diags.numpy(), lr.R.ops[1].diags) <= 1e-12
        sm, sm_ref = lo.presmoother, lr.presmoother
        assert lo.postsmoother is sm
        assert (sm.kind, sm.sweep) == (sm_ref.kind, sm_ref.sweep) \
            == ("gauss_seidel", "symmetric")
        assert _rel(sm.dinv.numpy(), sm_ref.dinv) <= 1e-12
        assert np.array_equal(sm.color_masks.numpy(),
                              np.asarray(sm_ref.color_masks))
    assert ours._smoother_config == ref._smoother_config


def test_structured_setup_solves_like_jax(jax_start):
    A, ours, ref = _setups("36^2")
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    res, res_ref = [], []
    x = ours.solve(b, tol=1e-8, maxiter=60, accel="cg", residuals=res)
    ref.solve(b, tol=1e-8, maxiter=60, accel="cg", residuals=res_ref)
    assert len(res) == len(res_ref) > 3
    np.testing.assert_allclose(res, res_ref, rtol=1e-10)
    assert np.linalg.norm(b - A @ x.numpy()) <= 1e-8 * np.linalg.norm(b)


def _export_op(op):
    """An operator of a JAX device-built hierarchy as the numpy dict of
    ``hierarchy_from_numpy``."""
    name = type(op).__name__
    if name == "SparseDIA":
        return {"diags": np.asarray(op.diags), "offsets": tuple(op.offsets),
                "shape": tuple(op.shape)}
    if name in ("GridRepeatOp", "GridPoolOp"):
        return {"wmap": np.asarray(op.wmap), "fine_grid": op.fine_grid,
                "block": op.block, "shape": tuple(op.shape),
                "pool": name == "GridPoolOp"}
    assert name == "ComposedOp"
    return {"ops": [_export_op(o) for o in op.ops], "shape": tuple(op.shape)}


def test_jax_device_built_hierarchy_loads_from_numpy(jax_start):
    """The setup factored out: the JAX package's device-built hierarchy,
    exported array by array, cycles and solves as it does."""
    A, _, ref = _setups("12^3")
    levels = []
    for lvl in ref.levels:
        spec = {"A": _export_op(lvl.A)}
        if getattr(lvl, "P", None) is not None:
            sm = lvl.presmoother
            smoother = {"kind": sm.kind, "sweep": sm.sweep,
                        "dinv": np.asarray(sm.dinv),
                        "color_masks": np.asarray(sm.color_masks)}
            spec |= {"P": _export_op(lvl.P), "R": _export_op(lvl.R),
                     "presmoother": smoother, "postsmoother": smoother}
        levels.append(spec)
    loaded = hierarchy_from_numpy(levels, np.asarray(ref._dev()["coarse"][0]),
                                  "cpu", torch.float64)
    assert type(loaded.levels[0].P).__name__ == "ComposedOp"
    b = np.random.default_rng(2).standard_normal(A.shape[0])
    x0 = np.random.default_rng(3).standard_normal(A.shape[0])
    y = loaded.cycle_fn("V")(torch.from_numpy(x0), torch.from_numpy(b))
    y_ref = np.asarray(ref.cycle_fn("V")(jnp.asarray(x0), jnp.asarray(b)))
    assert _rel(y.numpy(), y_ref) <= 1e-12
    res, res_ref = [], []
    loaded.solve(b, tol=1e-8, maxiter=60, accel="cg", residuals=res)
    ref.solve(b, tol=1e-8, maxiter=60, accel="cg", residuals=res_ref)
    assert len(res) == len(res_ref)
    np.testing.assert_allclose(res, res_ref, rtol=1e-10)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_degree_vs_block_guard(package):
    setup, A, dt = (tds.structured_sa_setup, poisson((27, 27),
                                                     format="csr"),
                    torch.float64) if package == "port" else \
        (jds.structured_sa_setup, jax_poisson((27, 27), format="csr"),
         jnp.float64)
    kw = {"device": "cpu"} if package == "port" else {}
    with pytest.raises(ValueError, match="2\\*degree"):
        setup(A, (27, 27), block=(2, 2), degree=1, dtype=dt, **kw)
    with pytest.raises(ValueError, match="2\\*degree"):
        setup(A, (27, 27), block=(3, 3), degree=2, dtype=dt, **kw)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_wide_stencil_guard(package):
    setup, A, dt = (tds.structured_sa_setup, poisson((27, 27),
                                                     format="csr"),
                    torch.float64) if package == "port" else \
        (jds.structured_sa_setup, jax_poisson((27, 27), format="csr"),
         jnp.float64)
    kw = {"device": "cpu"} if package == "port" else {}
    n = A.shape[0]
    A2 = sp.csr_matrix(A + 0.1 * sp.diags(np.ones(n - 54), 54))
    with pytest.raises(ValueError, match="outside"):
        setup(A2, (27, 27), dtype=dt, **kw)


def test_grid_must_match_the_operator():
    with pytest.raises(ValueError, match="nodes"):
        tds.structured_sa_setup(poisson((12, 12), format="csr"), (12, 13),
                                dtype=torch.float64, device="cpu")


def test_sharded_setup_is_the_structured_setup_on_one_device():
    A = poisson((30, 30), format="csr")
    a = parallel.structured_sa_setup_sharded(A, (30, 30),
                                             dtype=torch.float64,
                                             max_coarse=50, device="cpu")
    b = tds.structured_sa_setup(A, (30, 30), dtype=torch.float64,
                                max_coarse=50, device="cpu")
    assert len(a.levels) == len(b.levels) == 3
    for la, lb in zip(a.levels, b.levels):
        assert la.A.offsets == lb.A.offsets
        assert torch.equal(la.A.diags, lb.A.diags)
    # a SparseDIA input takes the same path
    c = parallel.structured_sa_setup_sharded(
        SparseDIA.from_scipy(A, dtype=np.float64, device="cpu"), (30, 30),
        dtype=torch.float64, max_coarse=50, device="cpu")
    assert torch.equal(c.levels[1].A.diags, b.levels[1].A.diags)


@pytest.fixture(scope="module")
def structured():
    A = poisson((30, 30), format="csr")
    ml = tds.structured_sa_setup(A, (30, 30), dtype=torch.float64,
                                 max_coarse=50, device="cpu")
    b = np.random.default_rng(4).standard_normal(A.shape[0])
    return A, ml, b


@pytest.mark.parametrize("accel", ["cg", "bicgstab", "gmres", "fgmres",
                                   None])
def test_shard_structured_solver_solves_as_the_inner_solver(structured,
                                                            accel):
    A, ml, b = structured
    sol = parallel.shard_structured_solver(ml, min_shard_rows=16)
    assert isinstance(sol, parallel.StructuredShardedSolver)
    assert sol.levels is ml.levels and sol.n == A.shape[0]
    res, res_inner = [], []
    x = sol.solve(b, tol=1e-8, maxiter=80, accel=accel, residuals=res)
    x_inner = ml.solve(b, tol=1e-8, maxiter=80, accel=accel,
                       residuals=res_inner)
    assert isinstance(x, torch.Tensor) and x.device == ml.device
    assert torch.equal(x, x_inner)
    assert res == res_inner and len(res) >= 2


def test_shard_structured_solver_refuses_other_accels(structured):
    _, ml, b = structured
    with pytest.raises(ValueError, match="supports accel"):
        parallel.shard_structured_solver(ml).solve(b, accel="cr")


@pytest.mark.parametrize("call,error,match", [
    (lambda A: parallel.structured_sa_setup_sharded(A, (10, 10), n_devices=2,
                                                    device="cpu"),
     ValueError, "requested 2 devices, have 1.*launch"),
    (lambda A: parallel.structured_sa_setup_sharded(A, (10, 10),
                                                    mesh=object(),
                                                    device="cpu"),
     TypeError, "mesh must be"),
    (lambda A: tds.structured_sa_setup(A, (10, 10), mesh=object(),
                                       device="cpu"),
     TypeError, "mesh must be"),
    (lambda A: parallel.shard_structured_solver(None, n_devices=2),
     ValueError, "requested 2 devices, have 1.*launch"),
    (lambda A: parallel.StructuredShardedSolver(None, mesh=object()),
     TypeError, "mesh must be"),
], ids=["sharded n_devices", "sharded mesh", "setup mesh",
        "solver n_devices", "solver mesh"])
def test_structured_forms_over_several_devices_raise(call, error, match):
    """Several devices need a process group (``parallel.launch``); a mesh
    is a ``parallel.Mesh``."""
    with pytest.raises(error, match=match):
        call(poisson((10, 10), format="csr"))


# -- checkpoints --------------------------------------------------------------

def _cg_count(ml, b, **kw):
    res = []
    ml.solve(b, tol=1e-8, maxiter=100, accel="cg", residuals=res, **kw)
    return len(res) - 1


@pytest.mark.parametrize("kind", ["host-built", "structured", "device-built"])
def test_checkpoint_round_trip(kind, tmp_path):
    A = poisson((24, 24), format="csr")
    if kind == "host-built":
        ml = pyamg_tpu_torch.smoothed_aggregation_solver(
            sp.csr_matrix(A.tocoo()), max_coarse=20, device="cpu")
    elif kind == "structured":
        ml = pyamg_tpu_torch.smoothed_aggregation_solver(A, max_coarse=20,
                                                         device="cpu")
    else:
        ml = tds.structured_sa_setup(A, (24, 24), dtype=torch.float64,
                                     max_coarse=20, device="cpu")
        assert not hasattr(ml.levels[0], "P_csr")
    b = np.random.default_rng(5).standard_normal(A.shape[0])
    path = tmp_path / "h.npz"
    save_hierarchy(ml, path)
    loaded = load_hierarchy(path, device="cpu")
    assert len(loaded.levels) == len(ml.levels)
    for lo, lm in zip(loaded.levels, ml.levels):
        assert abs(lo.A_csr - lm.host_A()).max() == 0
        assert lo.grid == (getattr(lm, "grid", None) or None)
    assert loaded.operator_complexity() == pytest.approx(
        ml.operator_complexity(), rel=1e-14)
    assert loaded._smoother_config[0] == ml._smoother_config[0]
    x = loaded.solve(b, tol=1e-8, maxiter=100, accel="cg")
    assert np.linalg.norm(b - A @ x.numpy()) <= 1e-8 * np.linalg.norm(b)
    assert _cg_count(loaded, b) == _cg_count(ml, b)


@pytest.fixture(scope="module")
def jax_written(tmp_path_factory):
    """A device-built hierarchy saved by the JAX package, and the CG count
    of the JAX package's own load of it."""
    path = tmp_path_factory.mktemp("jax") / "dev.npz"
    A = jax_poisson((24, 24), format="csr")
    jax_checkpoint.save_hierarchy(
        jds.structured_sa_setup(A, (24, 24), dtype=jnp.float64), path)
    b = np.random.default_rng(6).standard_normal(A.shape[0])
    res = []
    jax_checkpoint.load_hierarchy(path).solve(b, tol=1e-8, maxiter=100,
                                              accel="cg", residuals=res)
    return path, b, len(res) - 1


def test_jax_written_file_loads_in_the_port(jax_written):
    path, b, count = jax_written
    ml = load_hierarchy(path, device="cpu")
    assert ml._smoother_config == (("gauss_seidel", {"sweep": "symmetric"}),
                                   ) * 2
    assert ml.levels[0].presmoother.kind in ("gauss_seidel",
                                             "multicolor_gauss_seidel")
    assert _cg_count(ml, b) == count


def test_port_written_file_loads_in_jax(jax_written, tmp_path, monkeypatch):
    _, b, _ = jax_written
    monkeypatch.setattr(jax_core, "have_native", lambda: True)
    path = tmp_path / "port.npz"
    ml = tds.structured_sa_setup(poisson((24, 24), format="csr"), (24, 24),
                                 dtype=torch.float64, device="cpu")
    save_hierarchy(ml, path)
    res = []
    jax_checkpoint.load_hierarchy(path).solve(b, tol=1e-8, maxiter=100,
                                              accel="cg", residuals=res)
    assert len(res) - 1 == _cg_count(load_hierarchy(path, device="cpu"), b)
    assert pyamg_tpu.util.load_hierarchy is jax_checkpoint.load_hierarchy
