"""The port's structured SA setup against the JAX package's.

Both packages build the hierarchy of the same Poisson problem, each from its
own gallery matrix (so that no cached spectral estimate passes from one to
the other).  Levels, operator complexity, every level's A, P and weight map
must agree to float64 round-off, and the Chebyshev coefficients to 1e-14.
"""

import numpy as np
import pytest
import torch

import pyamg_tpu
import pyamg_tpu.amg_core as jax_core
from pyamg_tpu.gallery import poisson as jax_poisson
from pyamg_tpu.relaxation.smoothing import change_smoothers as jax_change
import pyamg_tpu_torch
from pyamg_tpu_torch.aggregation import fit_candidates, grid_aggregation
from pyamg_tpu_torch.gallery import poisson

torch.set_num_threads(1)

KW = dict(max_coarse=50, presmoother="chebyshev", postsmoother="chebyshev",
          improve_candidates=None)


def _csr_close(A, B, rtol=1e-12):
    A, B = A.tocsr(), B.tocsr()
    A.sort_indices()
    B.sort_indices()
    assert A.shape == B.shape
    np.testing.assert_array_equal(A.indptr, B.indptr)
    np.testing.assert_array_equal(A.indices, B.indices)
    assert np.abs(A.data - B.data).max() <= rtol * np.abs(B.data).max()


@pytest.fixture(scope="module", params=[64, 128])
def pair(request):
    N = request.param
    ref = pyamg_tpu.smoothed_aggregation_solver(
        jax_poisson((N, N), format="csr"), finalize_device=False, **KW)
    jax_change(ref, "chebyshev", "chebyshev")
    ours = pyamg_tpu_torch.smoothed_aggregation_solver(
        poisson((N, N), format="csr"), device="cpu", **KW)
    return ours, ref


def test_gallery_matches_jax():
    A, J = poisson((12, 9), format="csr"), jax_poisson((12, 9), format="csr")
    assert A.grid == J.grid == (12, 9)
    assert abs(A - J).max() == 0


def test_levels_and_complexity_match_jax(pair):
    ours, ref = pair
    assert len(ours.levels) == len(ref.levels)
    assert ours.operator_complexity() == ref.operator_complexity()
    assert [lv.A.shape for lv in ours.levels] == \
        [lv.A_csr.shape for lv in ref.levels]


def test_every_level_A_P_R_and_wmap_match_jax(pair):
    ours, ref = pair
    for lo, lr in zip(ours.levels, ref.levels):
        _csr_close(lo.A_csr, lr.A_csr)
        if not hasattr(lr, "P_csr"):
            continue
        _csr_close(lo.P_csr, lr.P_csr)
        _csr_close(lo.R_csr, lr.R_csr)
        np.testing.assert_allclose(lo.struct_meta["wmap"],
                                   lr.struct_meta["wmap"], rtol=1e-12)
        assert lo.struct_meta["block"] == lr.struct_meta["block"]
        assert lo.struct_meta["grid"] == lr.struct_meta["grid"]


def test_chebyshev_coefficients_match_jax(pair):
    ours, ref = pair
    for lo, lr in zip(ours.levels[:-1], ref.levels[:-1]):
        for a, b in ((lo.presmoother, lr.presmoother),
                     (lo.postsmoother, lr.postsmoother)):
            assert a.kind == b.kind == "polynomial"
            np.testing.assert_allclose(a.coefficients, b.coefficients,
                                       rtol=1e-14)


def test_device_operators_reproduce_host_matrices(pair):
    ours, _ = pair
    for lvl in ours.levels:
        assert lvl.A.dtype == torch.float64
        assert abs(lvl.A.to_scipy() - lvl.A_csr).max() == 0
        if hasattr(lvl, "P_csr"):
            assert abs(lvl.P.to_scipy() - lvl.P_csr).max() <= 1e-14
            assert abs(lvl.R.to_scipy() - lvl.R_csr).max() <= 1e-14


def test_op_dtype_builds_float32_operators():
    ml = pyamg_tpu_torch.smoothed_aggregation_solver(
        poisson((30, 30), format="csr"), device="cpu",
        op_dtype=torch.float32, **KW)
    for lvl in ml.levels[:-1]:
        assert lvl.A.dtype == lvl.P.dtype == lvl.R.dtype == torch.float32
    assert ml._coarse().dtype == torch.float32


@pytest.mark.parametrize("grid,block", [((10, 7), (3, 3)), ((8, 5), (2, 3))])
def test_grid_aggregation_and_fit_candidates_match_jax(grid, block):
    from pyamg_tpu.aggregation.aggregate import grid_aggregation as jga
    from pyamg_tpu.aggregation.tentative import fit_candidates as jfc

    Agg, roots, cg = grid_aggregation(grid, block)
    JAgg, jroots, jcg = jga(grid, block)
    assert cg == jcg
    np.testing.assert_array_equal(roots, jroots)
    assert abs(Agg - JAgg).max() == 0
    B = np.random.default_rng(0).random((Agg.shape[0], 1)) + 0.5
    T, Bc = fit_candidates(Agg, B)
    JT, JBc = jfc(JAgg, B)
    assert abs(T - JT).max() == 0
    np.testing.assert_array_equal(Bc, JBc)


@pytest.mark.parametrize("change", [
    {"improve_candidates": (("zebra", {}), None), "presmoother": "zebra"},
    {"smooth": ("energy", {"krylov": "gmres"}), "unstructured": True},
    {"presmoother": "gauss_seidel_nr"},
    {"symmetry": "nonsymmetric"},
    {"grid3d": True},
    {"unstructured": True, "aggregate": "lloyd"},
])
def test_setups_off_the_ported_path_raise(change):
    """Setups that raised and named their ROADMAP item until a slice
    ported them; each now builds the JAX package's hierarchy.  (Block
    Gauss-Seidel ``improve_candidates``, Richardson
    prolongation smoothing, Gauss-Seidel smoothers and matrices without
    grid metadata raised here before they were ported:
    ``test_torch_default_sa.py`` now compares them with the JAX package.
    Zebra smoothing and candidate relaxation raised until the classical
    slice ported the scalar line smoothers: they now build the JAX
    package's structured hierarchy, zebra smoothers included.  3-D grid
    metadata raised until the SA front-door slice: it now takes the JAX
    package's unstructured chain; ``test_torch_grid3d.py`` compares it
    level by level.  Energy smoothing by GMRES, the ``gauss_seidel_nr``
    smoother and the nonsymmetric setup raised until the nonsymmetric
    slice: they now build the JAX package's hierarchy, compared level by
    level here and in ``test_torch_nonsymmetric.py``.  Lloyd aggregation
    raised until the smoother-menu and matching slice: every setup of this
    list is now compared level by level, and
    ``test_torch_matching.py`` holds Lloyd and pairwise aggregation.)"""
    kw = dict(KW)
    kw.update({k: v for k, v in change.items()
               if k not in ("grid3d", "unstructured")})
    A = poisson((6, 6, 6) if change.get("grid3d") else (20, 20),
                format="csr")
    if change.get("unstructured"):
        A = A.tocoo().tocsr()           # a fresh matrix: no grid tag
    if kw.get("presmoother") == "zebra":
        ours = pyamg_tpu_torch.smoothed_aggregation_solver(A, device="cpu",
                                                           **kw)
        ref = pyamg_tpu.smoothed_aggregation_solver(
            jax_poisson((20, 20), format="csr"), **kw)
        assert len(ours.levels) == len(ref.levels) > 1
        for lo, lr in zip(ours.levels[:-1], ref.levels[:-1]):
            _csr_close(lo.A_csr, lr.A_csr)
            assert lo.presmoother.kind == lr.presmoother.kind == "zebra"
            np.testing.assert_allclose(lo.presmoother.line_tri.numpy(),
                                       np.asarray(lr.presmoother.line_tri),
                                       rtol=1e-12)
        return
    ours = pyamg_tpu_torch.smoothed_aggregation_solver(A, device="cpu",
                                                       **kw)
    J = jax_poisson((6, 6, 6) if change.get("grid3d") else (20, 20),
                    format="csr")
    if change.get("unstructured"):
        J = J.tocoo().tocsr()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_core, "have_native", lambda: True)
        ref = pyamg_tpu.smoothed_aggregation_solver(J, **kw)
    assert len(ours.levels) == len(ref.levels) > 1
    for lo, lr in zip(ours.levels, ref.levels):
        _csr_close(lo.A_csr, lr.A_csr)
        assert type(lo.A).__name__ == type(lr.A).__name__
    for lo, lr in zip(ours.levels[:-1], ref.levels[:-1]):
        _csr_close(lo.P_csr, lr.P_csr)
        _csr_close(lo.R_csr, lr.R_csr)
        assert lo.presmoother.kind == lr.presmoother.kind

