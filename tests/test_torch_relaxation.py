"""The port's smoother menu against the JAX package's.

The same numpy inputs, made from a seed, go through ``pyamg_tpu`` and the
port, in float64 unless stated:

* the host relaxation methods (``relaxation.relaxation``) and the utilities
  they and the setup use, to 1e-12;
* the colorings and every ``SmootherData`` the factory builds (masks,
  gather arrays, ``block_dinv``, omega), equal, on a DIA level with and
  without grid metadata and on a padded-ELL level;
* each device step against the JAX step, to 1e-12 in float64 and 1e-5 in
  float32; the gather form against the mask form of the port, to 1e-12.

The JAX reference is built with its ``have_native`` patched to True, so
that it colors first-fit whether or not its native library loaded in this
process (the port always does).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pyamg_tpu.amg_core as jax_core
import pyamg_tpu.relaxation.relaxation as jrel
import pyamg_tpu.relaxation.smoothing as jsmoothing
import pyamg_tpu.util.utils as jutils
from pyamg_tpu.multilevel import Level as JaxLevel
from pyamg_tpu.relaxation.device import apply_smoother as jax_apply
from pyamg_tpu.sparse import SparseELL as JaxELL
from pyamg_tpu.sparse import device_operator as jax_device_operator
from pyamg_tpu.util.linalg import pinv_array as jax_pinv_array
import pyamg_tpu_torch.relaxation.relaxation as rel
import pyamg_tpu_torch.relaxation.smoothing as smoothing
import pyamg_tpu_torch.util.utils as utils
from pyamg_tpu_torch.gallery import poisson
from pyamg_tpu_torch.multilevel import Level
from pyamg_tpu_torch.relaxation.device import (SmootherData, apply_smoother,
                                               multicolor_gs_gather_step,
                                               multicolor_gs_step)
from pyamg_tpu_torch.sparse import SparseELL, device_operator
from pyamg_tpu_torch.util.linalg import pinv_array

from sa_cases import ARRAYS, assert_same_smoother, blocked, unstructured

torch.set_num_threads(1)


MATRICES = {"poisson": lambda: poisson((12, 11), format="csr"),
            "unstructured": unstructured}


def _xb(n, seed=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n), rng.standard_normal(n)


@pytest.fixture
def first_fit(monkeypatch):
    """The JAX package colors first-fit whatever became of its native
    build in this process."""
    monkeypatch.setattr(jax_core, "have_native", lambda: True)


# ---------------------------------------------------------------------------
# host relaxation
# ---------------------------------------------------------------------------

HOST_CASES = {
    "gauss_seidel-forward": ("gauss_seidel", dict(sweep="forward")),
    "gauss_seidel-backward": ("gauss_seidel", dict(sweep="backward",
                                                   iterations=2)),
    "gauss_seidel-symmetric": ("gauss_seidel", dict(sweep="symmetric",
                                                    iterations=4)),
    "sor-forward": ("sor", dict(omega=1.3, sweep="forward")),
    "sor-backward": ("sor", dict(omega=0.8, sweep="backward")),
    "sor-symmetric": ("sor", dict(omega=1.2, sweep="symmetric",
                                  iterations=2)),
    "jacobi": ("jacobi", dict(omega=0.7, iterations=3)),
    "polynomial": ("polynomial", dict(coefficients=[0.01, -0.1, 0.5],
                                      iterations=2)),
    "block_jacobi-1": ("block_jacobi", dict(blocksize=1, omega=0.6)),
    "block_gauss_seidel-1": ("block_gauss_seidel",
                             dict(blocksize=1, sweep="symmetric",
                                  iterations=4)),
}


@pytest.mark.parametrize("matrix", sorted(MATRICES))
@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_smoother_matches_jax(case, matrix):
    name, kw = HOST_CASES[case]
    A = MATRICES[matrix]()
    x0, b = _xb(A.shape[0])
    x, xj = x0.copy(), x0.copy()
    out = getattr(rel, name)(A, x, b, **kw)
    getattr(jrel, name)(A.copy(), xj, b, **kw)
    assert out is x                               # in place
    assert np.abs(x - x0).max() > 1e-3
    np.testing.assert_allclose(x, xj, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name,kw", [
    ("block_jacobi", dict(omega=0.8, iterations=2)),
    ("block_gauss_seidel", dict(sweep="forward")),
    ("block_gauss_seidel", dict(sweep="backward")),
    ("block_gauss_seidel", dict(sweep="symmetric", iterations=2)),
], ids=["block_jacobi", "bgs-forward", "bgs-backward", "bgs-symmetric"])
def test_host_block_smoother_matches_jax(name, kw):
    A = blocked()
    x0, b = _xb(A.shape[0])
    x, xj = x0.copy(), x0.copy()
    getattr(rel, name)(A, x, b, blocksize=2, **kw)
    getattr(jrel, name)(A.copy(), xj, b, blocksize=2, **kw)
    np.testing.assert_allclose(x, xj, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("sweep", ["forward", "backward", "symmetric"])
def test_host_gauss_seidel_indexed_matches_jax(sweep):
    A = unstructured(200, seed=4)
    x0, b = _xb(200)
    idx = np.random.default_rng(5).permutation(200)[:120]
    x, xj = x0.copy(), x0.copy()
    rel.gauss_seidel_indexed(A, x, b, idx, iterations=2, sweep=sweep)
    jrel.gauss_seidel_indexed(A.copy(), xj, b, idx, iterations=2,
                              sweep=sweep)
    np.testing.assert_allclose(x, xj, rtol=1e-12, atol=1e-12)
    untouched = np.setdiff1d(np.arange(200), idx)
    np.testing.assert_array_equal(x[untouched], x0[untouched])


def test_host_gauss_seidel_is_the_lexicographic_sweep():
    A = MATRICES["poisson"]()
    x0, b = _xb(A.shape[0])
    x = x0.copy()
    rel.gauss_seidel(A, x, b)
    ref = x0.copy()
    Ad = A.toarray()
    for i in range(A.shape[0]):
        ref[i] = (b[i] - Ad[i] @ ref + Ad[i, i] * ref[i]) / Ad[i, i]
    np.testing.assert_allclose(x, ref, rtol=1e-12, atol=1e-12)


def test_host_gauss_seidel_skips_a_row_without_diagonal():
    """A row with no diagonal is left alone, as the JAX package's native
    sweep leaves it (its triangular-solve fallback moves it: ROADMAP.md,
    Queue 3); the oracle is the plain loop."""
    A = sp.lil_matrix(MATRICES["poisson"]())
    A[3, 3] = 0.0
    A = A.tocsr()
    A.eliminate_zeros()
    x0, b = _xb(A.shape[0])
    x = x0.copy()
    rel.gauss_seidel(A, x, b, sweep="symmetric")
    ref = x0.copy()
    Ad = A.toarray()
    n = A.shape[0]
    for i in list(range(n)) + list(range(n - 1, -1, -1)):
        if Ad[i, i] != 0:
            ref[i] = (b[i] - Ad[i] @ ref + Ad[i, i] * ref[i]) / Ad[i, i]
    assert x[3] == x0[3]
    np.testing.assert_allclose(x, ref, rtol=1e-12, atol=1e-12)
    if jax_core.have_native():
        xj = x0.copy()
        jrel.gauss_seidel(A.copy(), xj, b, sweep="symmetric")
        np.testing.assert_allclose(x, xj, rtol=1e-12, atol=1e-12)


def test_host_smoothers_validate_their_input():
    A = MATRICES["poisson"]()
    n = A.shape[0]
    with pytest.raises(ValueError, match="matching dimensions"):
        rel.jacobi(A, np.zeros(n + 1), np.zeros(n))
    with pytest.raises(ValueError, match="square"):
        rel.make_system(A[:, :-1], np.zeros(n), np.zeros(n))
    with pytest.raises(TypeError, match="float"):
        rel.gauss_seidel(A, np.zeros(n, dtype=np.int64), np.zeros(n))
    for fn in (rel.gauss_seidel, rel.gauss_seidel_indexed, rel.sor,
               rel.block_gauss_seidel):
        args = {rel.gauss_seidel_indexed: (np.arange(3),),
                rel.sor: (1.1,)}.get(fn, ())
        kw = {"blocksize": 2} if fn is rel.block_gauss_seidel else {}
        with pytest.raises(ValueError, match="sweep"):
            fn(A, np.zeros(n), np.zeros(n), *args, sweep="sideways", **kw)


@pytest.mark.parametrize("method", [
    ("block_gauss_seidel", {"sweep": "symmetric", "iterations": 4}),
    ("jacobi", {"omega": 0.5, "iterations": 2}),
    "gauss_seidel",
    ("multicolor_gauss_seidel", {}),       # no host method of that name
], ids=["default", "jacobi", "gauss_seidel", "device-only-name"])
def test_relaxation_as_linear_operator_matches_jax(method):
    A = MATRICES["unstructured"]()
    n = A.shape[0]
    b0 = np.zeros((n, 1))
    B = np.ones(n)
    ours = utils.relaxation_as_linear_operator(method, A, b0) @ B
    ref = jutils.relaxation_as_linear_operator(method, A.copy(), b0) @ B
    assert np.abs(ours - B).max() > 1e-3
    np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# utilities
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inv", [False, True])
def test_get_block_diag_matches_jax(inv):
    A = blocked()
    np.testing.assert_allclose(
        utils.get_block_diag(A, 2, inv_flag=inv),
        jutils.get_block_diag(A, 2, inv_flag=inv), rtol=1e-12, atol=1e-14)
    Ab = A.tobsr(blocksize=(2, 2))
    np.testing.assert_array_equal(utils.get_block_diag(Ab, 2, inv_flag=inv),
                                  utils.get_block_diag(A, 2, inv_flag=inv))
    with pytest.raises(ValueError, match="divisible"):
        utils.get_block_diag(A, 3)


@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_pinv_array_matches_jax(m):
    rng = np.random.default_rng(m)
    a = rng.standard_normal((30, m, m))
    a[3] = 0.0                                     # rank 0
    if m > 1:
        a[5, :, 1] = 2 * a[5, :, 0]                # rank-deficient
    ours, ref = pinv_array(a), jax_pinv_array(a)
    np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ours[5], np.linalg.pinv(a[5]), rtol=1e-8,
                               atol=1e-10)
    assert pinv_array(np.zeros((0, m, m))).shape == (0, m, m)


def test_amalgamate_matches_jax():
    A = blocked()
    assert abs(utils.amalgamate(A, 2) - jutils.amalgamate(A, 2)).max() == 0
    assert utils.amalgamate(A, 2).shape == (40, 40)
    assert abs(utils.amalgamate(A, 1) - A).max() == 0


@pytest.mark.parametrize("theta", [1.02, 0.5])
def test_eliminate_diag_dom_nodes_matches_jax(theta):
    A = sp.lil_matrix(MATRICES["unstructured"]())
    A[7, 7] = 100.0
    A[50, 50] = 100.0
    A = A.tocsr()
    C = abs(A)
    ours = utils.eliminate_diag_dom_nodes(A, C, theta=theta)
    ref = jutils.eliminate_diag_dom_nodes(A, C, theta=theta)
    assert abs(ours - ref).max() == 0 and ours.nnz == ref.nnz
    assert ours[7].nnz == 1 and ours[7, 7] != 0


@pytest.mark.parametrize("kw", [dict(), dict(lump=True),
                                dict(diagonal=True)],
                         ids=["plain", "lump", "diagonal"])
def test_filter_matrix_rows_matches_jax(kw):
    rng = np.random.default_rng(2)
    A = MATRICES["unstructured"]()
    A.data = A.data * rng.random(A.nnz)
    ours = utils.filter_matrix_rows(A, 0.5, **kw)
    ref = jutils.filter_matrix_rows(A, 0.5, **kw)
    assert ours.nnz == ref.nnz < A.nnz
    assert abs(ours - ref).max() <= 1e-14
    if kw.get("lump"):
        np.testing.assert_allclose(ours.sum(axis=1), A.sum(axis=1),
                                   rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# colorings and SmootherData
# ---------------------------------------------------------------------------

def _nine_point(grid):
    from pyamg_tpu_torch.gallery import stencil_grid

    st = -np.ones((3, 3))
    st[1, 1] = 8.0
    A = stencil_grid(st, grid, format="csr")
    return A


COLORING_CASES = {
    "grid-5pt": (lambda: poisson((9, 8), format="csr"), (9, 8), 2),
    "grid-9pt": (lambda: _nine_point((9, 8)), (9, 8), 4),
    "grid-3d-7pt": (lambda: poisson((4, 5, 3), format="csr"), (4, 5, 3), 2),
    "grid-stripped": (lambda: poisson((9, 8), format="csr"), None, 2),
    "grid-wrong-size": (lambda: poisson((9, 8), format="csr"), (9, 9), 2),
    "unstructured": (unstructured, None, None),
}


@pytest.mark.parametrize("case", sorted(COLORING_CASES))
def test_coloring_matches_jax(case, first_fit):
    make, grid, ncolors = COLORING_CASES[case]
    A = make()
    colors = smoothing._coloring(A, grid=grid)
    np.testing.assert_array_equal(colors,
                                  jsmoothing._coloring(A, grid=grid))
    rows = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr))
    off = rows != A.indices
    assert not (colors[rows[off]] == colors[A.indices[off]]).any()
    if ncolors:
        assert colors.max() + 1 == ncolors
    # the offsets of the level's DIA operator, handed in, change nothing
    offs = np.unique(A.indices - rows)
    np.testing.assert_array_equal(
        colors, smoothing._coloring(A, grid=grid, offsets=offs))


def test_block_coloring_and_masks_match_jax(first_fit):
    A = blocked()
    np.testing.assert_array_equal(smoothing._coloring(A, blocksize=2),
                                  jsmoothing._coloring(A, blocksize=2))
    masks = smoothing._color_masks(A, blocksize=2)
    np.testing.assert_array_equal(
        masks, np.asarray(jsmoothing._color_masks(A, blocksize=2)))
    assert masks.shape[1] == A.shape[0]
    np.testing.assert_array_equal(masks.sum(axis=0), 1)


def test_gather_arrays_match_jax_and_hold_the_matrix(first_fit):
    A = unstructured()
    colors = smoothing._coloring(A)
    rows, cols, data = smoothing._color_gather_arrays(A, colors)
    jr, jc, jd = jsmoothing._color_gather_arrays(A, colors)
    np.testing.assert_array_equal(rows, np.asarray(jr))
    np.testing.assert_array_equal(cols, np.asarray(jc))
    np.testing.assert_array_equal(data, np.asarray(jd))
    assert rows.dtype == cols.dtype == np.int64
    C, R, W, nbytes = smoothing.gather_form_bytes(A, colors, 8)
    assert rows.shape == (C, R) and cols.shape == data.shape == (C, R, W)
    assert nbytes == rows.nbytes + cols.nbytes + data.nbytes
    # every row once, with its entries
    valid = rows >= 0
    assert sorted(rows[valid]) == list(range(A.shape[0]))
    back = sp.coo_matrix(
        (data[valid].ravel(),
         (np.repeat(rows[valid], W), cols[valid].ravel())),
        shape=A.shape).tocsr()
    assert abs(back - A).max() == 0


def _levels(kind):
    """The same level for both packages: ``(ours, jax's)``."""
    if kind == "dia-grid":
        A, grid, blocksize = poisson((14, 13), format="csr"), (14, 13), 1
    elif kind == "dia-nogrid":
        A, grid, blocksize = poisson((14, 13), format="csr"), None, 1
    elif kind == "ell":
        A, grid, blocksize = unstructured(), None, 1
    else:
        A, grid, blocksize = blocked(), None, 2
    ours = Level(A_csr=A.copy(), grid=grid, blocksize=blocksize,
                 _sym_hint=True)
    ref = JaxLevel(A_csr=A.copy(), grid=grid, blocksize=blocksize,
                   _sym_hint=True)
    if kind == "ell":
        ours.A = SparseELL.from_scipy(A, device="cpu")
        ref.A = JaxELL.from_scipy(A)
    else:
        ours.A = device_operator(A, device="cpu")
        ref.A = jax_device_operator(A)
    return ours, ref


SMOOTHERS = {
    "default": ("block_gauss_seidel", {"sweep": "symmetric"}),
    "gauss_seidel-forward": ("gauss_seidel", {}),
    "gauss_seidel-backward-2": ("multicolor_gauss_seidel",
                                {"sweep": "backward", "iterations": 2}),
    "sor": ("sor", {"omega": 1.2, "sweep": "symmetric"}),
    "jacobi": ("jacobi", {"omega": 0.8}),
    "jacobi-norho": ("jacobi", {"omega": 0.6, "withrho": False}),
    "richardson": ("richardson", {"omega": 0.9, "iterations": 2}),
    "chebyshev": ("chebyshev", {"degree": 2}),
    "block_jacobi": ("block_jacobi", {"omega": 0.9}),
    "zebra": ("zebra", {"sweep": "symmetric"}),
    "line_jacobi": ("line_jacobi", {"iterations": 2}),
    "none": (None, {}),
}
@pytest.mark.parametrize("kind", ["dia-grid", "dia-nogrid", "ell", "blocked"])
@pytest.mark.parametrize("name", sorted(SMOOTHERS))
def test_smoother_data_and_step_match_jax(name, kind, first_fit):
    fn, kw = SMOOTHERS[name]
    ours, ref = _levels(kind)
    sm = smoothing.make_smoother_data(ours, fn, kw, device="cpu")
    jsm = jsmoothing.make_smoother_data(ref, fn, kw)
    assert_same_smoother(sm, jsm)
    gs = sm.kind == "gauss_seidel"
    assert (sm.color_rows is not None) == (gs and kind == "ell")
    if gs and kind == "dia-grid":
        assert sm.color_masks.shape[0] == 2          # red-black
    if name == "default" and kind == "blocked":
        assert sm.kind == "block_gauss_seidel" and sm.blocksize == 2
    x0, b = _xb(ours.A_csr.shape[0])
    y = apply_smoother(sm, ours.A, torch.from_numpy(x0), torch.from_numpy(b))
    yj = jax_apply(jsm, ref.A, jnp.asarray(x0), jnp.asarray(b))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-12,
                               atol=1e-12)
    if fn is not None:
        assert np.abs(y.numpy() - x0).max() > 1e-3


@pytest.mark.parametrize("kind", ["dia-grid", "ell", "blocked"])
@pytest.mark.parametrize("name", ["default", "sor", "block_jacobi",
                                  "richardson"])
def test_float32_step_matches_jax(name, kind, first_fit):
    fn, kw = SMOOTHERS[name]
    ours, ref = _levels(kind)
    ours.A, ref.A = ours.A.astype(torch.float32), ref.A.astype(jnp.float32)
    sm = smoothing.make_smoother_data(ours, fn, kw, dtype=torch.float32,
                                      device="cpu")
    jsm = jsmoothing.make_smoother_data(ref, fn, kw, dtype=jnp.float32)
    for name_ in ARRAYS:
        a = getattr(sm, name_)
        if a is not None:
            want = torch.int64 if name_ in ("color_rows", "color_cols") \
                else torch.float32
            assert a.dtype == want, name_
    x0, b = (v.astype(np.float32) for v in _xb(ours.A_csr.shape[0]))
    y = apply_smoother(sm, ours.A, torch.from_numpy(x0), torch.from_numpy(b))
    yj = np.asarray(jax_apply(jsm, ref.A, jnp.asarray(x0), jnp.asarray(b)))
    assert y.dtype == torch.float32
    assert np.abs(y.numpy() - yj).max() <= 1e-5 * np.abs(yj).max()


def test_identical_pre_and_post_smoothers_share_their_state():
    lvl, _ = _levels("ell")
    kw = {"sweep": "symmetric"}
    a = smoothing.make_smoother_data(lvl, "gauss_seidel", kw, device="cpu")
    assert smoothing.make_smoother_data(lvl, "gauss_seidel", dict(kw),
                                        device="cpu") is a
    Dinv = utils.get_block_diag(lvl.A_csr, 2)
    sm = smoothing.make_smoother_data(
        lvl, "block_jacobi", {"blocksize": 2, "Dinv": Dinv}, device="cpu")
    assert sm.kind == "block_jacobi"              # array options: no cache


@pytest.mark.parametrize("name", ["jacobi_ne", "gauss_seidel_nr", "zebra",
                                  "line_jacobi", "schwarz", "cgnr"])
def test_smoothers_outside_the_port_raise(name, first_fit):
    """The smoothers that raised and named their ROADMAP item until a
    slice ported them.  (``zebra`` and ``line_jacobi`` raised here until
    the classical slice ported them: they now build their line data on a
    grid level, and ``test_torch_classical.py`` compares them with the JAX
    package.  ``jacobi_ne``, ``gauss_seidel_nr`` and ``cgnr`` raised until
    the nonsymmetric slice: they now apply as the JAX package's, and
    ``test_torch_nonsymmetric.py`` holds all seven NE/NR and Krylov
    smoothers.  ``schwarz`` raised until the smoother-menu slice: it now
    applies as the JAX package's, and ``test_torch_smoothers.py`` holds
    it.)"""
    lvl, ref = _levels("dia-grid")
    if name in ("jacobi_ne", "gauss_seidel_nr", "cgnr"):
        sm = smoothing.make_smoother_data(lvl, name, {}, device="cpu")
        jsm = jsmoothing.make_smoother_data(ref, name, {})
        assert sm.kind == jsm.kind
        np.testing.assert_allclose(sm.omega, jsm.omega, rtol=1e-12)
        x0, b = _xb(lvl.A_csr.shape[0])
        y = apply_smoother(sm, lvl.A, torch.from_numpy(x0),
                           torch.from_numpy(b))
        yj = jax_apply(jsm, ref.A, jnp.asarray(x0), jnp.asarray(b))
        np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-12,
                                   atol=1e-12)
        return
    if name in ("zebra", "line_jacobi"):
        sm = smoothing.make_smoother_data(lvl, name, {}, device="cpu")
        assert sm.kind == name and sm.line_tri.shape[0] == 3
        n = lvl.A_csr.shape[0]
        x0, b = (torch.from_numpy(v) for v in _xb(n))
        r0 = torch.linalg.norm(b - lvl.A.matvec(x0))
        x1 = apply_smoother(sm, lvl.A, x0, b)
        assert torch.linalg.norm(b - lvl.A.matvec(x1)) < r0
        return
    # schwarz raised here until the smoother-menu slice ported it: it now
    # applies as the JAX package's (test_torch_smoothers.py holds its
    # state and step on more operators)
    sm = smoothing.make_smoother_data(lvl, name, {}, device="cpu")
    jsm = jsmoothing.make_smoother_data(ref, name, {})
    assert sm.kind == jsm.kind == "schwarz"
    x0, b = _xb(lvl.A_csr.shape[0])
    y = apply_smoother(sm, lvl.A, torch.from_numpy(x0), torch.from_numpy(b))
    yj = jax_apply(jsm, ref.A, jnp.asarray(x0), jnp.asarray(b))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-12,
                               atol=1e-12)
    # what is left outside the menu: an unknown name or kind
    with pytest.raises(ValueError, match="unknown smoother"):
        smoothing.make_smoother_data(lvl, "no_such_smoother", {},
                                     device="cpu")
    with pytest.raises(ValueError, match="unknown smoother kind"):
        apply_smoother(SmootherData(kind="no_such_kind"), lvl.A, None, None)


# ---------------------------------------------------------------------------
# gather form vs mask form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sweep", ["forward", "backward", "symmetric"])
def test_gather_form_equals_mask_form(sweep):
    A = unstructured()
    n = A.shape[0]
    lvl = Level(A_csr=A, A=SparseELL.from_scipy(A, device="cpu"))
    kw = {"sweep": sweep, "iterations": 2}
    gather = smoothing.make_smoother_data(lvl, "gauss_seidel", kw,
                                          device="cpu")
    colors = smoothing._coloring(A)
    masks = torch.from_numpy(smoothing._color_masks(A, colors=colors))
    mask = SmootherData(kind="gauss_seidel", sweep=sweep, iterations=2,
                        dinv=gather.dinv, color_masks=masks)
    assert gather.color_rows is not None and gather.color_masks is None
    x0, b = (torch.from_numpy(v) for v in _xb(n))
    y_g = apply_smoother(gather, lvl.A, x0, b)
    y_m = apply_smoother(mask, lvl.A, x0, b)
    np.testing.assert_allclose(y_g.numpy(), y_m.numpy(), rtol=1e-12,
                               atol=1e-12)


def test_gather_form_padding_adds_an_exact_zero_to_row_0():
    """Padded slots (-1) of a color are sent to row 0 with a zero update:
    a color that does not hold row 0 leaves x[0] bitwise alone, however
    many padded slots it has."""
    A = unstructured()
    colors = smoothing._coloring(A)
    lvl = Level(A_csr=A, A=SparseELL.from_scipy(A, device="cpu"))
    sm = smoothing.make_smoother_data(lvl, "gauss_seidel", {}, device="cpu")
    last = int(colors.max())
    assert colors[0] != last and int((sm.color_rows[last] < 0).sum()) > 1
    only_last = SmootherData(
        kind="gauss_seidel", dinv=sm.dinv,
        color_rows=sm.color_rows[last:], color_cols=sm.color_cols[last:],
        color_data=sm.color_data[last:])
    x0, b = (torch.from_numpy(v) for v in _xb(A.shape[0]))
    y = multicolor_gs_gather_step(only_last, x0, b)
    touched = np.flatnonzero(colors == last)
    assert y[0] == x0[0]
    assert (y[touched] != x0[touched]).all()
    rest = np.setdiff1d(np.arange(A.shape[0]), touched)
    np.testing.assert_array_equal(y.numpy()[rest], x0.numpy()[rest])


def test_multicolor_gs_is_gauss_seidel_in_the_color_order():
    A = poisson((10, 9), format="csr")
    n = A.shape[0]
    colors = smoothing._coloring(A, grid=(10, 9))
    order = np.argsort(colors, kind="stable")
    x0, b = _xb(n)
    ref = x0.copy()
    rel.gauss_seidel_indexed(A, ref, b, order)
    lvl = Level(A_csr=A, A=device_operator(A, device="cpu"), grid=(10, 9))
    masks = torch.from_numpy(smoothing._color_masks(A, colors=colors))
    dinv = torch.from_numpy(1.0 / A.diagonal())
    y = multicolor_gs_step(lvl.A, dinv, masks, torch.from_numpy(x0),
                           torch.from_numpy(b))
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-12, atol=1e-12)
