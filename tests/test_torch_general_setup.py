"""The port's general device setup and its solve against the JAX package's.

``pyamg_tpu_torch.parallel.general_sa_setup_sharded`` on a CPU device
(its masked products then run the kernels' plain twin) is held against
``pyamg_tpu.parallel.general_sa_setup_sharded`` on a one-device mesh, both
in float64 and from the same numpy inputs:

* the host stages -- strength, standard and naive aggregation, first-fit
  and Jones-Plassmann colorings, the tentative fit -- exactly equal, on
  Poisson grids and on an unstructured graph;
* the hierarchy: the level count, every level's A, P and R to 1e-12
  relative, the color masks exactly, the operator complexity -- whether or
  not the JAX package's native library loaded in this process;
* the solve: through ``ell_hierarchy_from_numpy`` on the JAX-built
  hierarchy, the CG iteration count exactly and the residual history to
  1e-10 relative; the port's own setup and solve, the same count;
* ``profile_general.py``'s stage timer: each stage counted, every wrapped
  callable restored afterwards.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pyamg_tpu.amg_core as jax_core
from pyamg_tpu.aggregation.aggregate import naive_aggregation as jax_naive
from pyamg_tpu.aggregation.aggregate import standard_aggregation as jax_std
from pyamg_tpu.aggregation.tentative import fit_candidates as jax_fit
from pyamg_tpu.gallery import poisson as jax_poisson
from pyamg_tpu.graph import vertex_coloring as jax_coloring
from pyamg_tpu.parallel import general_sa_setup_sharded as jax_setup
from pyamg_tpu.parallel import make_mesh
from pyamg_tpu.relaxation.device import SmootherData as JaxSmoother
from pyamg_tpu.relaxation.device import apply_smoother as jax_apply
from pyamg_tpu.sparse.ell import SparseELL as JaxELL
from pyamg_tpu.strength import symmetric_strength_of_connection as jax_soc
from pyamg_tpu_torch import amg_core, parallel
from pyamg_tpu_torch.aggregation import fit_candidates
from pyamg_tpu_torch.aggregation.aggregate import (naive_aggregation,
                                                   standard_aggregation)
from pyamg_tpu_torch.gallery import poisson
from pyamg_tpu_torch.graph import vertex_coloring
from pyamg_tpu_torch.relaxation.device import SmootherData, apply_smoother
from pyamg_tpu_torch.sparse import SparseELL
from pyamg_tpu_torch.strength import symmetric_strength_of_connection
from pyamg_tpu_torch.util.convert import ell_hierarchy_from_numpy

torch.set_num_threads(1)


def _unstructured(n=800, seed=0):
    """Graph Laplacian (plus a small shift) of a random geometric graph in
    the unit square, with node 5 cut off: an unstructured mesh-like
    operator with one isolated node."""
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2))
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    W = sp.csr_matrix((d2 < 0.06 ** 2) & (d2 > 0), dtype=np.float64)
    W = W.tolil()
    W[5, :] = 0
    W[:, 5] = 0
    W = W.tocsr()
    W.eliminate_zeros()
    L = sp.diags(np.asarray(W.sum(axis=1)).ravel() + 0.01) - W
    L = sp.csr_matrix(L)
    L.sort_indices()
    return L


GRAPHS = {"poisson48": lambda: poisson((48, 48), format="csr"),
          "poisson128": lambda: poisson((128, 128), format="csr"),
          "unstructured": _unstructured}


def _equal_csr(A, B):
    A, B = sp.csr_matrix(A), sp.csr_matrix(B)
    A.sort_indices()
    B.sort_indices()
    np.testing.assert_array_equal(A.indptr, B.indptr)
    np.testing.assert_array_equal(A.indices, B.indices)
    np.testing.assert_array_equal(A.data, B.data)


def _close_csr(A, B, rtol=1e-12):
    d = abs(sp.csr_matrix(A) - sp.csr_matrix(B))
    assert A.shape == B.shape
    assert (d.max() if d.nnz else 0.0) <= rtol * abs(B).max()


# ---------------------------------------------------------------------------
# host stages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("theta", [0.0, 0.25])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_strength_matches_jax(graph, theta):
    A = GRAPHS[graph]()
    _equal_csr(symmetric_strength_of_connection(A, theta=theta),
               jax_soc(A, theta=theta))


@pytest.mark.parametrize("method", ["standard", "naive"])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_aggregation_matches_jax(graph, method):
    C = jax_soc(GRAPHS[graph]())
    ours, ref = {"standard": (standard_aggregation, jax_std),
                 "naive": (naive_aggregation, jax_naive)}[method]
    (Agg, roots), (JAgg, jroots) = ours(C), ref(C)
    _equal_csr(Agg, JAgg)
    np.testing.assert_array_equal(roots, jroots)
    if graph == "unstructured" and method == "standard":
        assert np.diff(Agg.indptr)[5] == 0      # the isolated node


@pytest.mark.parametrize("method", ["FF", "JP"])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_coloring_matches_jax(graph, method):
    G = GRAPHS[graph]()
    colors = vertex_coloring(G, method)
    np.testing.assert_array_equal(colors, jax_coloring(G, method))
    G1 = sp.csr_matrix(G)
    rows = np.repeat(np.arange(G1.shape[0]), np.diff(G1.indptr))
    off = rows != G1.indices
    assert not (colors[rows[off]] == colors[G1.indices[off]]).any()


def test_fit_candidates_matches_jax_with_unaggregated_rows():
    C = jax_soc(_unstructured())
    AggOp, _ = jax_std(C)
    assert (np.diff(AggOp.indptr) == 0).any()
    B = np.random.default_rng(1).random((C.shape[0], 1)) + 0.5
    (T, Bc), (JT, JBc) = fit_candidates(AggOp, B), jax_fit(AggOp, B)
    _equal_csr(T, JT)
    np.testing.assert_array_equal(Bc, JBc)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fit_candidates(AggOp, np.ones((C.shape[0], 2)))


@pytest.mark.parametrize("reverse", [False, True])
def test_multicolor_gs_step_matches_jax(reverse):
    A = _unstructured(300, seed=2)
    rng = np.random.default_rng(3)
    x, b = rng.standard_normal(300), rng.standard_normal(300)
    colors = jax_coloring(A, "FF")
    masks = np.zeros((colors.max() + 1, 300))
    masks[colors, np.arange(300)] = 1
    dinv = 1.0 / A.diagonal()
    sweep = "backward" if reverse else "symmetric"
    j = jnp.asarray
    ref = jax_apply(JaxSmoother(kind="multicolor_gauss_seidel", sweep=sweep,
                                dinv=j(dinv), color_masks=j(masks),
                                iterations=2),
                    JaxELL.from_scipy(A), j(x), j(b))
    t = torch.as_tensor
    ours = apply_smoother(
        SmootherData(kind="multicolor_gauss_seidel", sweep=sweep,
                     dinv=t(dinv), color_masks=t(masks), iterations=2),
        SparseELL.from_scipy(A, device="cpu"), t(x), t(b))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


# ---------------------------------------------------------------------------
# the whole setup
# ---------------------------------------------------------------------------

def _jax_matrix(N, drop_diag=False):
    A = jax_poisson((N, N), format="csr")
    if drop_diag:                # test_row_without_stored_diagonal's case
        A = sp.lil_matrix(A)
        A[0, 0] = 0.0
        A = A.tocsr()
        A.eliminate_zeros()
    return A


def _jax_reference(A):
    """The JAX package's setup of A in float64 with first-fit colors.

    The JAX package colors with first-fit when its native library loaded
    and with Jones-Plassmann when it did not
    (pyamg_tpu/relaxation/smoothing.py:153-155), and each process builds
    that library at first use, so a worker that lost the build race would
    color otherwise.  The port makes the same choice on its own library,
    which these tests leave on unless they say otherwise; the JAX package's
    Python fallback computes the first-fit colors identically."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_core, "have_native", lambda: True)
        return jax_setup(A, mesh=make_mesh(1), dtype=np.float64)


def _assert_levels_match(A, ours, ref):
    assert len(ours.levels) == len(ref.levels) >= 3
    assert ours.sizes == ref.sizes and ours.n_orig == ref.n_orig
    for lo, lr in zip(ours.levels, ref.levels):
        _close_csr(lo.A_csr, lr.A_csr)
        assert lo.A.shape == lr.A.shape and lo.A.width == lr.A.width
        assert lo.A.dtype == torch.float64
        if lr.presmoother.kind == "none":
            assert lo.presmoother.kind == "none"
            continue
        _close_csr(lo.P.to_scipy(), lr.P.to_scipy())
        _close_csr(lo.R.to_scipy(), lr.R.to_scipy())
        sm, jsm = lo.presmoother, lr.presmoother
        assert (sm.kind, sm.sweep, sm.iterations) == \
            (jsm.kind, jsm.sweep, jsm.iterations)
        np.testing.assert_array_equal(sm.color_masks.numpy(),
                                      np.asarray(jsm.color_masks))
        np.testing.assert_allclose(sm.dinv.numpy(), np.asarray(jsm.dinv),
                                   rtol=1e-12)
        assert lo.postsmoother is sm
    assert ours.inner.operator_complexity() == \
        ref.inner.operator_complexity()
    if A[0, 0] == 0:                  # P keeps the diagonal-less row
        assert abs(ours.levels[0].P.to_scipy()[0]).sum() > 0


@pytest.fixture(scope="module", params=["48", "128", "32-no-diagonal"])
def pair(request):
    N = int(request.param.split("-")[0])
    A = _jax_matrix(N, drop_diag="no-diagonal" in request.param)
    ref = _jax_reference(A)
    ours = parallel.general_sa_setup_sharded(A.copy(), dtype=np.float64,
                                             device="cpu")
    return A, ours, ref


def test_setup_matches_jax_level_by_level(pair):
    _assert_levels_match(*pair)


def test_setup_matches_jax_without_its_native_library(monkeypatch):
    monkeypatch.setattr(jax_core, "_lib", False)
    assert not jax_core.have_native()
    A = _jax_matrix(48)
    ours = parallel.general_sa_setup_sharded(A.copy(), dtype=np.float64,
                                             device="cpu")
    _assert_levels_match(A, ours, _jax_reference(A))


@pytest.mark.parametrize("theta", [0.0, 0.25])
def test_classical_strength_setup_matches_jax(theta):
    A = _jax_matrix(48)
    kw = dict(strength=("classical", {"theta": theta}), dtype=np.float64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_core, "have_native", lambda: True)
        ref = jax_setup(A, mesh=make_mesh(1), **kw)
    ours = parallel.general_sa_setup_sharded(A.copy(), device="cpu", **kw)
    _assert_levels_match(A, ours, ref)


def test_setup_matches_jax_with_both_native_libraries_off(monkeypatch):
    """Without a compiled library either package colors by Jones-Plassmann
    rounds and aggregates with its Python passes."""
    monkeypatch.setattr(jax_core, "_lib", False)
    monkeypatch.setattr(amg_core, "_lib", False)
    assert not jax_core.have_native() and not amg_core.have_native()
    A = _jax_matrix(48)
    ref = jax_setup(A, mesh=make_mesh(1), dtype=np.float64)
    ours = parallel.general_sa_setup_sharded(A.copy(), dtype=np.float64,
                                             device="cpu")
    _assert_levels_match(A, ours, ref)


def _export(sol):
    """The JAX-built hierarchy as the numpy dicts of
    ``ell_hierarchy_from_numpy``."""
    def ell(E):
        return {k: np.asarray(getattr(E, k))
                for k in ("data", "cols", "row_nnz")} | {"shape": E.shape}

    def smoother(s):
        return {"kind": s.kind, "sweep": s.sweep, "iterations": s.iterations,
                "omega": s.omega,
                "dinv": None if s.dinv is None else np.asarray(s.dinv),
                "color_masks": None if s.color_masks is None
                else np.asarray(s.color_masks)}

    levels = []
    for lvl in sol.levels:
        spec = {"A": ell(lvl.A), "presmoother": smoother(lvl.presmoother),
                "postsmoother": smoother(lvl.postsmoother)}
        if hasattr(lvl, "P"):
            spec |= {"P": ell(lvl.P), "R": ell(lvl.R)}
        levels.append(spec)
    return levels, sol.sizes, sol.n_orig, np.asarray(
        sol.inner._coarse_mat_override)


@pytest.mark.parametrize("pair", ["48", "128"], indirect=True)
def test_solve_matches_jax(pair):
    A, ours, ref = pair
    b = A @ np.random.default_rng(0).random(A.shape[0])
    res_ref, res_imp, res_own = [], [], []
    ref.solve(b, tol=1e-8, accel="cg", maxiter=200, residuals=res_ref)
    imported = ell_hierarchy_from_numpy(*_export(ref), device="cpu",
                                        dtype=np.float64)
    x = imported.solve(b, tol=1e-8, accel="cg", maxiter=200,
                       residuals=res_imp)
    assert len(res_imp) == len(res_ref) > 2
    np.testing.assert_allclose(res_imp, res_ref, rtol=1e-10)
    ours.solve(b, tol=1e-8, accel="cg", maxiter=200, residuals=res_own)
    assert len(res_own) == len(res_ref)
    assert x.shape == (A.shape[0],)
    assert np.linalg.norm(b - A @ x.numpy()) <= 1e-8 * np.linalg.norm(b)


def test_naive_jacobi_setup_matches_jax():
    A = _jax_matrix(40)
    kw = dict(aggregate="naive", smoother=("jacobi", {"omega": 0.7}),
              max_coarse=30, dtype=np.float64)
    ref = jax_setup(A, mesh=make_mesh(1), **kw)
    ours = parallel.general_sa_setup_sharded(A, device="cpu", **kw)
    assert len(ours.levels) == len(ref.levels)
    for lo, lr in zip(ours.levels[:-1], ref.levels[:-1]):
        _close_csr(lo.A_csr, lr.A_csr)
        _close_csr(lo.P.to_scipy(), lr.P.to_scipy())
        assert (lo.presmoother.kind, lo.presmoother.omega) == ("jacobi", 0.7)
    b = np.ones(A.shape[0])
    x = ours.solve(b, tol=1e-8, accel="cg", maxiter=100).numpy()
    assert np.linalg.norm(b - A @ x) <= 1e-8 * np.linalg.norm(b)


@pytest.mark.parametrize("call", [
    lambda A: parallel.general_sa_setup_sharded(A, n_devices=2, device="cpu"),
    lambda A: parallel.general_sa_setup_sharded(A, mesh=object(),
                                                device="cpu"),
    lambda A: parallel.general_sa_setup_sharded(A, smooth=("energy", {}),
                                                device="cpu"),
    lambda A: parallel.rootnode_setup_sharded(A),
    lambda A: parallel.adaptive_sa_setup_sharded(A),
    lambda A: parallel.classical_setup_sharded(A),
], ids=["n_devices", "mesh", "energy", "rootnode", "adaptive", "classical"])
def test_setups_off_the_ported_path_raise(call):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        call(poisson((10, 10), format="csr"))


def test_profile_general_times_the_stages_and_restores_them():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "profile_general.py"
    spec = importlib.util.spec_from_file_location("profile_general", path)
    pg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pg)
    originals = [(owner, attr, owner.__dict__[attr])
                 for _, owner, attr in pg.STAGES]
    A = poisson((24, 24), format="csr")
    sol, total, seconds, calls = pg.profile(A, torch.device("cpu"))
    assert all(owner.__dict__[attr] is raw for owner, attr, raw in originals)
    n_coarse = len(sol.levels) - 1
    assert calls["masked products: plans + kernels (device)"] == 3 * n_coarse
    assert calls["standard aggregation (host)"] == n_coarse
    assert 0 < sum(seconds.values()) <= total
    ref = parallel.general_sa_setup_sharded(A, device="cpu")
    assert [lvl.A_csr.nnz for lvl in sol.levels] == \
        [lvl.A_csr.nnz for lvl in ref.levels]
