"""The port's compiled host library (``pyamg_tpu_torch.amg_core``, built from
``csrc/amg_core.cpp``) against its Python forms and against the JAX
package's ``pyamg_tpu.amg_core``.

Inputs come from a numpy seed.  Aggregates, colors, the S values and the DIA
arrays are equal exactly; the Gauss-Seidel sweeps and classical strength to
1e-12 relative.  Each call site takes the compiled route when the library
loaded and its Python form when ``amg_core._lib`` is forced to False, and
the hierarchy of the default call agrees with the JAX package's level by
level both ways, the JAX package's library forced the same way.
"""

import time
import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pyamg_tpu
import pyamg_tpu.amg_core as jax_core
import pyamg_tpu_torch
from pyamg_tpu_torch import _build, amg_core, graph, strength
from pyamg_tpu_torch.aggregation import aggregate, aggregation
from pyamg_tpu_torch.gallery import poisson
from pyamg_tpu_torch.relaxation import relaxation, smoothing
from pyamg_tpu_torch.sparse import SparseDIA, device_operator
from pyamg_tpu_torch.strength import symmetric_strength_of_connection

from sa_cases import unstructured
from test_torch_default_sa import _assert_hierarchies_match, _matrices

torch.set_num_threads(1)

GRAPHS = {"poisson48": lambda: poisson((48, 48), format="csr"),
          "unstructured": lambda: unstructured(800, seed=3)}


def _graph(name, index_dtype):
    A = sp.csr_matrix(GRAPHS[name]())
    A.sort_indices()
    A.indptr, A.indices = (A.indptr.astype(index_dtype),
                           A.indices.astype(index_dtype))
    return A


@pytest.fixture(autouse=True)
def jax_library():
    """The JAX package compiles its library at first use in every process,
    to one path: a process that met another's half-written file keeps
    ``_lib = False``.  Load again until the finished file is there."""
    for _ in range(60):
        if jax_core._lib or jax_core.have_native():
            break
        jax_core._lib = None
        time.sleep(1)
    assert jax_core.have_native()


@pytest.fixture
def python_forms(monkeypatch):
    """Force the port's Python forms for the rest of the test."""
    def off():
        monkeypatch.setattr(amg_core, "_lib", False)
        assert not amg_core.have_native()
    return off


def test_library_is_built_from_the_ports_source_into_the_build_dir():
    assert amg_core.have_native()
    built = list(_build.BUILD_DIR.glob("libamg_core-*.so"))
    assert built and _build.build_host("amg_core") in built
    assert not list(_build.CSRC.glob("*.so"))
    assert (_build.CSRC / "amg_core.cpp").is_file()


def test_without_a_compiler_the_python_forms_serve(monkeypatch):
    def no_compiler(name):
        raise RuntimeError("no host compiler found (g++, or nvcc)")

    monkeypatch.setattr(amg_core, "_lib", None)
    monkeypatch.setattr(_build, "build_host", no_compiler)
    with pytest.warns(UserWarning, match="native build unavailable"):
        assert not amg_core.have_native()
    C = symmetric_strength_of_connection(GRAPHS["poisson48"]())
    assert amg_core.standard_aggregation_native(C) is None
    assert amg_core.first_fit_coloring_native(C) is None
    x = np.ones(C.shape[0])
    assert not amg_core.gauss_seidel_sweeps_native(C, x, x.copy(), 1,
                                                   "forward")
    AggOp, roots = aggregate.standard_aggregation(C)
    assert AggOp.shape[1] == roots.size > 0


@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("method", ["standard", "naive"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_aggregation_native_python_and_jax_agree(name, method, index_dtype,
                                                 python_forms):
    C = symmetric_strength_of_connection(_graph(name, index_dtype))
    C.indptr, C.indices = (C.indptr.astype(index_dtype),
                           C.indices.astype(index_dtype))
    fn = getattr(aggregate, method + "_aggregation")
    labels, roots = getattr(amg_core, method + "_aggregation_native")(C)
    jlabels, jroots = getattr(jax_core, method + "_aggregation_native")(C)
    np.testing.assert_array_equal(labels, jlabels)
    np.testing.assert_array_equal(roots, jroots)
    AggOp, r = fn(C)
    python_forms()
    AggOp_py, r_py = fn(C)
    np.testing.assert_array_equal(r, roots)
    np.testing.assert_array_equal(r, r_py)
    assert (AggOp != AggOp_py).nnz == 0
    np.testing.assert_array_equal(AggOp.indices, labels[labels >= 0])


@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_first_fit_coloring_native_python_and_jax_agree(name, index_dtype,
                                                        python_forms):
    G = _graph(name, index_dtype)
    colors = graph.vertex_coloring(G, "FF")
    G1 = G.copy()
    G1.setdiag(0)
    G1.eliminate_zeros()
    np.testing.assert_array_equal(colors,
                                  jax_core.first_fit_coloring_native(G1))
    python_forms()
    np.testing.assert_array_equal(colors, graph.vertex_coloring(G, "FF"))
    rows = np.repeat(np.arange(G.shape[0]), np.diff(G.indptr))
    off = rows != G.indices
    assert not (colors[rows[off]] == colors[G.indices[off]]).any()


@pytest.mark.parametrize("sweep", ["forward", "backward", "symmetric"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_gauss_seidel_sweeps_native_python_and_jax_agree(name, sweep,
                                                         python_forms):
    A = _graph(name, np.int32)
    rng = np.random.default_rng(5)
    x0, b = rng.standard_normal(A.shape[0]), rng.standard_normal(A.shape[0])
    x = x0.copy()
    relaxation.gauss_seidel(A, x, b, iterations=3, sweep=sweep)
    xj = x0.copy()
    assert jax_core.gauss_seidel_sweeps_native(A, xj, b, 3, sweep)
    np.testing.assert_array_equal(x, xj)
    A64 = _graph(name, np.int64)
    x64 = x0.copy()
    assert amg_core.gauss_seidel_sweeps_native(A64, x64, b, 3, sweep)
    np.testing.assert_array_equal(x, x64)
    python_forms()
    xp = x0.copy()
    relaxation.gauss_seidel(A, xp, b, iterations=3, sweep=sweep)
    assert np.abs(x - xp).max() <= 1e-12 * np.abs(xp).max()
    assert np.abs(x - x0).max() > 1e-3


@pytest.mark.parametrize("sweep", ["forward", "backward", "symmetric"])
def test_gauss_seidel_indexed_native_and_python_agree(sweep, python_forms):
    A = _graph("unstructured", np.int32)
    rng = np.random.default_rng(6)
    x0, b = rng.standard_normal(A.shape[0]), rng.standard_normal(A.shape[0])
    order = rng.permutation(A.shape[0])[:500]
    x = x0.copy()
    relaxation.gauss_seidel_indexed(A, x, b, order, iterations=2,
                                    sweep=sweep)
    xj = x0.copy()
    for _ in range(2):
        if sweep in ("forward", "symmetric"):
            assert jax_core.gauss_seidel_indexed_native(A, xj, b, order)
        if sweep in ("backward", "symmetric"):
            assert jax_core.gauss_seidel_indexed_native(A, xj, b,
                                                        order[::-1])
    np.testing.assert_array_equal(x, xj)
    python_forms()
    xp = x0.copy()
    relaxation.gauss_seidel_indexed(A, xp, b, order, iterations=2,
                                    sweep=sweep)
    assert np.abs(x - xp).max() <= 1e-12 * np.abs(xp).max()
    untouched = np.setdiff1d(np.arange(A.shape[0]), order)
    np.testing.assert_array_equal(x[untouched], x0[untouched])


def test_native_sweeps_leave_other_dtypes_to_the_python_form():
    A = _graph("poisson48", np.int32)
    n = A.shape[0]
    xc = np.ones(n, dtype=np.complex128)
    Ac = A.astype(np.complex128)
    assert not amg_core.gauss_seidel_sweeps_native(Ac, xc, xc.copy(), 1,
                                                   "forward")
    assert not amg_core.gauss_seidel_indexed_native(Ac, xc, xc.copy(),
                                                    np.arange(n))
    assert amg_core.identity_minus_rowscaled_native(Ac, np.ones(n),
                                                    0.5) is None
    assert amg_core.classical_strength_native(Ac, 0.25) is None
    assert amg_core.csr_to_dia_native(Ac) is None
    x32 = np.ones(n, dtype=np.float32)
    assert not amg_core.gauss_seidel_sweeps_native(A.astype(np.float32), x32,
                                                   x32.copy(), 1, "forward")
    relaxation.gauss_seidel(Ac, xc, np.zeros(n, dtype=np.complex128))
    assert np.isfinite(xc).all() and np.abs(xc - 1).max() > 1e-3


@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_identity_minus_rowscaled_is_bitwise_the_numpy_expression(
        name, index_dtype, python_forms):
    A = _graph(name, index_dtype)
    Dinv = 1.0 / A.diagonal()
    c = 4.0 / 3.0 / 1.9731
    Sx = amg_core.identity_minus_rowscaled_native(A, Dinv, c)
    np.testing.assert_array_equal(
        Sx, jax_core.identity_minus_rowscaled_native(A, Dinv, c))
    S, degree = aggregation.structured_smoother_S(
        A, "jacobi", {"omega": 4.0 / 3.0}, "hermitian")
    python_forms()
    S_py, _ = aggregation.structured_smoother_S(
        A, "jacobi", {"omega": 4.0 / 3.0}, "hermitian")
    assert degree == 1
    np.testing.assert_array_equal(S.indices, S_py.indices)
    np.testing.assert_array_equal(S.data, S_py.data)
    # a row without a stored diagonal: the compiled pass declines
    B = sp.lil_matrix(A)
    B[3, 3] = 0.0
    B = sp.csr_matrix(B)
    B.eliminate_zeros()
    amg_core._lib = None
    assert amg_core.identity_minus_rowscaled_native(B, Dinv, c) is None


@pytest.mark.parametrize("theta", [0.0, 0.25, 0.6])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_classical_strength_native_python_and_jax_agree(name, theta,
                                                        python_forms):
    A = _graph(name, np.int32)
    rng = np.random.default_rng(8)
    A.data = A.data * (1 + 0.3 * rng.random(A.nnz))
    S = strength.classical_strength_of_connection(A, theta=theta)
    Sj = jax_core.classical_strength_native(A, theta)
    np.testing.assert_array_equal(S.indptr, Sj.indptr)
    np.testing.assert_array_equal(S.indices, Sj.indices)
    np.testing.assert_array_equal(S.data, Sj.data)
    python_forms()
    S_py = strength.classical_strength_of_connection(A, theta=theta)
    np.testing.assert_array_equal(S.indptr, S_py.indptr)
    np.testing.assert_array_equal(S.indices, S_py.indices)
    np.testing.assert_allclose(S.data, S_py.data, rtol=1e-12)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
def test_csr_to_dia_native_equals_the_numpy_staging(index_dtype, dtype,
                                                    python_forms):
    A = _graph("poisson48", index_dtype)
    A.data = A.data * (1 + np.random.default_rng(9).random(A.nnz))
    diags, offs = SparseDIA.host_diags(A, dtype=dtype)
    jdiags, joffs = jax_core.csr_to_dia_native(A, dtype=dtype)
    assert offs == joffs == (-48, -1, 0, 1, 48)
    np.testing.assert_array_equal(diags, jdiags)
    with pytest.raises(ValueError, match="distinct diagonals"):
        SparseDIA.host_diags(A, max_offsets=3)
    D = SparseDIA.from_scipy(A, dtype=dtype, device="cpu")
    python_forms()
    diags_py, offs_py = SparseDIA.host_diags(A, dtype=dtype)
    assert offs == offs_py and diags.dtype == diags_py.dtype == dtype
    np.testing.assert_array_equal(diags, diags_py)
    np.testing.assert_array_equal(D.diags.numpy(), diags_py)
    with pytest.raises(ValueError, match="distinct diagonals"):
        SparseDIA.host_diags(A, max_offsets=3)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_device_operator_takes_the_compiled_dia_passes(dtype, python_forms):
    A = _graph("poisson48", np.int32)
    A.data = A.data * (1 + np.random.default_rng(10).random(A.nnz))
    D = device_operator(A, dtype=dtype, device="cpu")
    wide = device_operator(_graph("unstructured", np.int32), dtype=dtype,
                           device="cpu", dia_max_offsets=8)
    python_forms()
    D_py = device_operator(A, dtype=dtype, device="cpu")
    assert isinstance(D, SparseDIA) and D.offsets == D_py.offsets
    assert D.dtype == D_py.dtype and torch.equal(D.diags, D_py.diags)
    wide_py = device_operator(_graph("unstructured", np.int32), dtype=dtype,
                              device="cpu", dia_max_offsets=8)
    assert type(wide) is type(wide_py) and not isinstance(wide, SparseDIA)


def test_coloring_and_sequential_limit_follow_the_library(monkeypatch,
                                                          python_forms):
    """With the library the setup colors first-fit and aggregates
    sequentially at any size; without it Jones-Plassmann rounds and, above
    50,000 rows, the round-based aggregation: the JAX package's
    branches."""
    G = _graph("unstructured", np.int32)
    calls = []
    monkeypatch.setattr(
        aggregation, "parallel_aggregation",
        lambda C, **kw: calls.append("parallel") or (None, None))
    monkeypatch.setattr(
        aggregation, "standard_aggregation",
        lambda C, **kw: calls.append("standard") or (None, None))
    big = sp.eye(50_001, format="csr")
    np.testing.assert_array_equal(smoothing._coloring(G),
                                  graph.vertex_coloring(G, "FF"))
    aggregation._aggregate(big, None, None, "standard")
    python_forms()
    np.testing.assert_array_equal(smoothing._coloring(G),
                                  graph.vertex_coloring(G, "JP"))
    aggregation._aggregate(big, None, None, "standard")
    aggregation._aggregate(G, None, None, "standard")
    aggregation._aggregate(G, None, None,
                           ("standard", {"sequential_limit": 10}))
    assert calls == ["standard", "parallel", "standard", "parallel"]


@pytest.mark.parametrize("library", ["on", "off"])
@pytest.mark.parametrize("case", ["grid-64", "plain-40"])
def test_default_hierarchy_matches_jax_with_the_library_on_and_off(
        case, library, monkeypatch):
    """Both packages with their library, and both without (each takes its
    numpy S, its triangular-solve Gauss-Seidel, its Python aggregation and
    Jones-Plassmann colors)."""
    if library == "off":
        monkeypatch.setattr(jax_core, "_lib", False)
        monkeypatch.setattr(amg_core, "_lib", False)
    assert amg_core.have_native() == jax_core.have_native() \
        == (library == "on")
    A, J = _matrices(case)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours = pyamg_tpu_torch.smoothed_aggregation_solver(
            A, max_coarse=30, device="cpu")
        ref = pyamg_tpu.smoothed_aggregation_solver(J, max_coarse=30)
    _assert_hierarchies_match(ours, ref)
    assert len(ours.levels) >= 3
    b = A @ np.random.default_rng(0).random(A.shape[0])
    res, res_ref = [], []
    ours.solve(b, tol=1e-8, accel="cg", residuals=res)
    ref.solve(b, tol=1e-8, accel="cg", residuals=res_ref)
    assert len(res) == len(res_ref) > 3
    np.testing.assert_allclose(res, res_ref, rtol=1e-6)
