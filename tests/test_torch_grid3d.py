"""Smoothed aggregation on 3-D grid matrices and the semicoarsening branch
(``jacobi_weak``): the port against the JAX package.

* The default call on ``poisson((12, 12, 12))``, whose grid metadata sends
  it down the unstructured chain in both packages, and the ``(2, 2, 2)``
  grid-block path with Chebyshev smoothers on 16^3 (the configuration of
  ``benchmarks/suite.py``'s ``poisson3d_64_sa_chebyshev`` at a small size):
  rows, nnz, A and P per level to 1e-10 in float64, the device forms, CG
  iteration counts exactly.
* The structured helpers in 3-D: ``grid_aggregation``, the grid transfers
  ``GridRepeatOp`` / ``GridPoolOp`` on a grid the blocks do not divide,
  the 2^3 geometric coloring of a 27-point stencil, the DIA form of 3-D
  stencils.
* ``jacobi_weak`` on two small anisotropic grids (2-D and 3-D, one and two
  dofs per node): the weak-axis filter's compiled pass, its numpy form and
  the JAX package's agree entry for entry, S equals the JAX package's
  (also with the port's library off), and a zebra-smoothed semicoarsened
  hierarchy equals the JAX package's level by level.

Every reference is built with the JAX package's ``have_native`` patched to
True.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pyamg_tpu
import pyamg_tpu.amg_core as jax_core
from pyamg_tpu.aggregation import aggregation as jax_aggregation
from pyamg_tpu.aggregation.aggregate import grid_aggregation as jax_grid_agg
from pyamg_tpu.gallery import poisson as jax_poisson
from pyamg_tpu.gallery import stencil_grid as jax_stencil_grid
from pyamg_tpu.relaxation import smoothing as jax_smoothing
import pyamg_tpu_torch
from pyamg_tpu_torch import amg_core
from pyamg_tpu_torch.aggregation import aggregation
from pyamg_tpu_torch.aggregation.aggregate import grid_aggregation
from pyamg_tpu_torch.gallery import poisson, stencil_grid
from pyamg_tpu_torch.relaxation import smoothing
from pyamg_tpu_torch.sparse import GridPoolOp, GridRepeatOp, SparseDIA

from test_torch_default_sa import _assert_hierarchies_match, _close

torch.set_num_threads(1)

CHEB_3D = dict(presmoother="chebyshev", postsmoother="chebyshev",
               improve_candidates=None,
               aggregate=("grid", {"block": (2, 2, 2)}), max_coarse=20)


def _jax(fn, *args, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_core, "have_native", lambda: True)
        return fn(*args, **kw)


def _iterations(ml, b, **kw):
    res = []
    ml.solve(b, tol=1e-8, accel="cg", residuals=res, **kw)
    return len(res) - 1


@pytest.fixture(scope="module", params=["default-12", "grid-cheb-16"])
def built(request):
    """(port hierarchy, JAX hierarchy, A) of the two 3-D calls."""
    if request.param == "default-12":
        A, J, kw = poisson((12,) * 3, format="csr"), \
            jax_poisson((12,) * 3, format="csr"), {}
    else:
        A, J, kw = poisson((16,) * 3, format="csr"), \
            jax_poisson((16,) * 3, format="csr"), CHEB_3D
    ours = pyamg_tpu_torch.smoothed_aggregation_solver(A, device="cpu", **kw)
    ref = _jax(pyamg_tpu.smoothed_aggregation_solver, J, **kw)
    return request.param, ours, ref, A


def test_3d_hierarchy_matches_jax_level_by_level(built):
    name, ours, ref, _ = built
    assert len(ours.levels) >= 2
    _assert_hierarchies_match(ours, ref)
    for lo, lr in zip(ours.levels, ref.levels):
        assert lo.A_csr.shape == lr.A_csr.shape
        if isinstance(lo.A, SparseDIA):
            assert lo.A.offsets == tuple(lr.A.offsets)
    if name == "grid-cheb-16":
        # every level a stencil: DIA operators, grid transfers of S and T
        assert all(isinstance(lvl.A, SparseDIA) for lvl in ours.levels)
        assert ours.levels[0].A.n_offsets == 7
        assert ours.levels[1].A.n_offsets >= 27
        assert [lvl.struct_meta["block"] for lvl in ours.levels[:-1]] == \
            [(2, 2, 2)] * (len(ours.levels) - 1)
        assert type(ours.levels[0].P).__name__ == "ComposedOp"
    else:
        # 3-D metadata with aggregate="standard": the unstructured chain
        assert not hasattr(ours.levels[0], "struct_meta")
        assert getattr(ours.levels[0], "root_dofs", None) is not None


def test_3d_solves_take_the_jax_iteration_counts(built):
    _, ours, ref, A = built
    b = np.random.default_rng(0).random(A.shape[0])
    it = _iterations(ours, b)
    assert it == _iterations(ref, b) and it <= 15
    x = ours.solve(b, tol=1e-10, accel="cg").numpy()
    assert np.linalg.norm(b - A @ x) <= 1e-9 * np.linalg.norm(b)


def test_3d_transfers_apply_their_host_matrices(built):
    _, ours, _, _ = built
    rng = np.random.default_rng(1)
    for lvl in ours.levels[:-1]:
        xc = rng.standard_normal(lvl.P_csr.shape[1])
        xf = rng.standard_normal(lvl.P_csr.shape[0])
        np.testing.assert_allclose(lvl.P.matvec(torch.from_numpy(xc)).numpy(),
                                   lvl.P_csr @ xc, rtol=1e-12, atol=1e-13)
        np.testing.assert_allclose(lvl.R.matvec(torch.from_numpy(xf)).numpy(),
                                   lvl.R_csr @ xf, rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("grid,block", [((5, 6, 7), (2, 2, 2)),
                                        ((7, 4, 5), (3, 3, 3)),
                                        ((6, 6, 6), (3, 1, 1))])
def test_grid_aggregation_and_grid_transfers_in_3d(grid, block):
    AggOp, roots, cgrid = grid_aggregation(grid, block)
    J, jroots, jcgrid = jax_grid_agg(grid, block)
    assert cgrid == tuple(jcgrid)
    np.testing.assert_array_equal(roots, np.asarray(jroots))
    assert abs(AggOp - J).nnz == 0
    n, nc = AggOp.shape
    rng = np.random.default_rng(2)
    w = rng.random(n)
    T = sp.csr_matrix(sp.diags(w) @ AggOp)
    Pop = GridRepeatOp(torch.from_numpy(w), grid, block, (n, nc))
    Rop = GridPoolOp(torch.from_numpy(w), grid, block, (nc, n))
    xc, xf = rng.standard_normal(nc), rng.standard_normal(n)
    np.testing.assert_allclose(Pop.matvec(torch.from_numpy(xc)).numpy(),
                               T @ xc, rtol=1e-13)
    np.testing.assert_allclose(Rop.matvec(torch.from_numpy(xf)).numpy(),
                               T.T @ xf, rtol=1e-13, atol=1e-14)
    _close(Pop.to_scipy(), T, 1e-15)
    # two candidates per coarse node, node-major
    w2 = rng.random((n, 2))
    P2 = GridRepeatOp(torch.from_numpy(w2), grid, block, (n, 2 * nc))
    T2 = P2.to_scipy()
    xc2 = rng.standard_normal(2 * nc)
    np.testing.assert_allclose(P2.matvec(torch.from_numpy(xc2)).numpy(),
                               T2 @ xc2, rtol=1e-13)
    R2 = GridPoolOp(torch.from_numpy(w2), grid, block, (2 * nc, n))
    np.testing.assert_allclose(R2.matvec(torch.from_numpy(xf)).numpy(),
                               T2.T @ xf, rtol=1e-13, atol=1e-14)


def _27_point(grid):
    """A 27-point 3-D stencil matrix (all neighbours coupled)."""
    st = -np.ones((3, 3, 3))
    st[1, 1, 1] = 26.0
    return stencil_grid(st, grid, format="csr")


@pytest.mark.parametrize("which", ["7-point", "27-point"])
def test_3d_coloring_is_geometric_valid_and_the_jaxs(which):
    grid = (6, 5, 4)
    A = poisson(grid, format="csr") if which == "7-point" else _27_point(grid)
    colors = smoothing._coloring(A, grid=grid)
    jcolors = np.asarray(jax_smoothing._coloring(A.copy(), grid=grid))
    np.testing.assert_array_equal(colors, jcolors)
    assert colors.max() + 1 == (2 if which == "7-point" else 8)
    coo = A.tocoo()
    off = coo.row != coo.col
    assert not (colors[coo.row[off]] == colors[coo.col[off]]).any()


def test_3d_stencils_take_the_dia_form():
    for A, k in ((poisson((6, 5, 4), format="csr"), 7),
                 (_27_point((6, 5, 4)), 27)):
        op = pyamg_tpu_torch.sparse.device_operator(A, device="cpu")
        assert isinstance(op, SparseDIA)
        assert op.n_offsets == k
        _close(op.to_scipy(), A, 0.0)
        x = np.random.default_rng(3).standard_normal(A.shape[0])
        np.testing.assert_allclose(op.matvec(torch.from_numpy(x)).numpy(),
                                   A @ x, rtol=1e-13, atol=1e-13)


# ---------------------------------------------------------------------------
# jacobi_weak: the semicoarsening levels of line smoothers
# ---------------------------------------------------------------------------

def _aniso(case):
    """(A, grid, block, q) of the two anisotropic grids, scalar or with two
    dofs per node."""
    if case.startswith("2d"):
        st = np.array([[0.0, -1.0, 0.0], [-1e-3, 2.002, -1e-3],
                       [0.0, -1.0, 0.0]])
        grid, block = (18, 15), (1, 3)
    else:
        st = np.zeros((3, 3, 3))
        st[0, 1, 1] = st[2, 1, 1] = -1e-3
        st[1, 0, 1] = st[1, 2, 1] = st[1, 1, 0] = st[1, 1, 2] = -1.0
        st[1, 1, 1] = 4.002
        grid, block = (7, 6, 5), (3, 1, 1)
    A = stencil_grid(st, grid, format="csr")
    J = jax_stencil_grid(st, grid, format="csr")
    np.testing.assert_array_equal(A.toarray(), J.toarray())
    q = 1
    if case.endswith("q2"):
        q = 2
        A = sp.kron(A, np.array([[2.0, -0.5], [-0.5, 2.0]])).tocsr()
    return A, grid, block, q


CASES = ["2d", "3d", "2d-q2", "3d-q2"]


@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("case", CASES)
def test_weak_axis_filter_compiled_python_and_jax_agree(case, index_dtype,
                                                        monkeypatch):
    A, grid, block, q = _aniso(case)
    A.indptr = A.indptr.astype(index_dtype)
    A.indices = A.indices.astype(index_dtype)
    strides = [int(np.prod(grid[k + 1:])) for k in range(len(grid))]
    ours = amg_core.weak_axis_filter_native(A, q, strides, block)
    ref = jax_core.weak_axis_filter_native(A, q, strides, block)
    assert ours is not None and ref is not None
    for M in (ref, aggregation.weak_axis_filter(A, q, grid, block)):
        np.testing.assert_array_equal(ours.indptr, M.indptr)
        np.testing.assert_array_equal(ours.indices, M.indices)
        np.testing.assert_array_equal(ours.data, M.data)
    monkeypatch.setattr(amg_core, "_lib", False)
    assert amg_core.weak_axis_filter_native(A, q, strides, block) is None
    py = aggregation.weak_axis_filter(A, q, grid, block)
    np.testing.assert_array_equal(ours.indices, py.indices)
    np.testing.assert_array_equal(ours.data, py.data)
    # only couplings along the coarsened (weak) axes and inside a node stay
    coo = py.tocoo()
    delta = (np.array(np.unravel_index(coo.col // q, grid))
             - np.array(np.unravel_index(coo.row // q, grid)))
    assert not delta[np.asarray(block) == 1].any()
    assert py.nnz < A.nnz


@pytest.mark.parametrize("library", ["compiled", "python"])
@pytest.mark.parametrize("case", CASES)
def test_jacobi_weak_smoother_equals_jax(case, library, monkeypatch):
    A, grid, block, q = _aniso(case)
    if library == "python":
        monkeypatch.setattr(amg_core, "_lib", False)
    S, degree = aggregation.structured_smoother_S(
        A.copy(), "jacobi_weak", {}, "hermitian", grid=grid, block=block,
        q_lvl=q)
    J, jdegree = _jax(jax_aggregation.structured_smoother_S, A.copy(), grid,
                      block, q, "jacobi_weak", {}, "hermitian")
    assert degree == jdegree == 1
    assert S.nnz == J.nnz < A.nnz
    _close(S, J, 1e-14)


@pytest.mark.parametrize("shape", [(48, 48), (12, 12, 12)])
def test_zebra_semicoarsened_hierarchy_equals_jax(shape):
    """Strong grid-aligned anisotropy with zebra smoothers: the weak axes
    coarsen, S is jacobi_weak, and the hierarchy equals the JAX
    package's."""
    if len(shape) == 2:
        A = stencil_grid(np.array([[0.0, -1.0, 0.0], [-1e-3, 2.002, -1e-3],
                                   [0.0, -1.0, 0.0]]), shape, format="csr")
    else:
        st = np.zeros((3, 3, 3))
        st[0, 1, 1] = st[2, 1, 1] = -1e-3
        st[1, 0, 1] = st[1, 2, 1] = st[1, 1, 0] = st[1, 1, 2] = -1.0
        st[1, 1, 1] = 4.002
        A = stencil_grid(st, shape, format="csr")
    J = A.copy()
    J.grid = A.grid
    # on a 3-D grid the structured path is the caller's choice
    kw = dict(presmoother="zebra", postsmoother="zebra",
              improve_candidates=None, max_coarse=20,
              aggregate="standard" if len(shape) == 2 else "grid")
    ours = pyamg_tpu_torch.smoothed_aggregation_solver(A, device="cpu", **kw)
    ref = _jax(pyamg_tpu.smoothed_aggregation_solver, J, **kw)
    _assert_hierarchies_match(ours, ref)
    metas = [lvl.struct_meta for lvl in ours.levels[:-1]]
    assert metas[0]["sfn"] == "jacobi_weak" and 1 in metas[0]["block"]
    for lo, lr in zip(ours.levels[:-1], ref.levels[:-1]):
        assert lo.struct_meta["block"] == tuple(lr.struct_meta["block"])
        _close(lo.struct_meta["S_csr"], lr.struct_meta["S_csr"], 1e-13)
    # (its solve: test_torch_adaptive.py, on the same branch)
