"""The black-box solver, the work models and the host utilities they and the
other front doors use: the port against the JAX package.

* ``solver_configuration`` gives the JAX package's dict (strings, tuples,
  B) on a symmetric and on a nonsymmetric matrix; ``solve`` on the 40^2
  Poisson problem takes the JAX package's iterations and its x to 1e-8;
  the nonsymmetric ``solver`` builds the JAX package's hierarchy and
  ``solve`` runs GMRES on it.
* ``setup_complexity`` and ``cycle_complexity``: the bit-exact pins of the
  JAX package's tests (``tests/test_util.py::TestComplexity``: the 500^2
  SA profile against the reference model's values, AMLI beside W, the
  option awareness) reproduced on the port, and both packages equal on
  the same hierarchies (default SA, Chebyshev, zebra, root-node,
  classical, the black box's).
* ``util.linalg`` (``norm`` with ``"inf"``, ``infinity_norm``,
  ``residual_norm``, ``condest``, ``cond``, ``ishermitian``) and
  ``util.utils`` (``symmetric_rescaling``, ``truncate_rows``,
  ``filter_matrix_columns``, ``filter_operator``) equal to the JAX
  package's.

Every reference is built with the JAX package's ``have_native`` patched to
True.
"""

import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pyamg_tpu
import pyamg_tpu.amg_core as jax_core
from pyamg_tpu import complexity as jax_complexity
from pyamg_tpu.util import linalg as jax_linalg
from pyamg_tpu.util import utils as jax_utils
import pyamg_tpu_torch
from pyamg_tpu_torch import complexity
from pyamg_tpu_torch.gallery import (diffusion_stencil_2d, poisson,
                                     stencil_grid)
from pyamg_tpu_torch.util import linalg, utils

torch.set_num_threads(1)


def _jax(fn, *args, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_core, "have_native", lambda: True)
        return fn(*args, **kw)


def _close(A, B, tol=1e-12):
    A, B = sp.csr_matrix(A), sp.csr_matrix(B)
    assert A.shape == B.shape
    d = abs(A - B)
    assert (d.max() if d.nnz else 0.0) <= tol * max(abs(B).max(), 1e-300)


def _nonsymmetric(n=20):
    """A convection-diffusion matrix: upwinded, so not symmetric."""
    A = poisson((n, n), format="csr").tolil()
    for i in range(n * n - 1):
        A[i, i + 1] -= 0.5
    return A.tocsr()


def _same_config(ours, ref):
    assert set(ours) == set(ref)
    for key, value in ref.items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(ours[key], value)
            assert ours[key].dtype == value.dtype
        else:
            assert ours[key] == value, key


@pytest.mark.parametrize("kind", ["symmetric", "nonsymmetric", "bsr", "B"])
def test_solver_configuration_equals_jax(kind):
    B = None
    if kind == "nonsymmetric":
        A = _nonsymmetric()
    elif kind == "bsr":
        A = pyamg_tpu_torch.gallery.linear_elasticity((8, 8))[0]
    else:
        A = poisson((20, 20), format="csr")
        if kind == "B":
            B = np.arange(A.shape[0], dtype=float)
    ours = pyamg_tpu_torch.solver_configuration(A, B=B, verb=False)
    ref = pyamg_tpu.solver_configuration(A.copy(), B=B, verb=False)
    _same_config(ours, ref)
    assert ours["symmetry"] == ("nonsymmetric" if kind == "nonsymmetric"
                                else "hermitian")


def test_solve_takes_the_jax_iterations_and_x():
    A = poisson((40, 40), format="csr")
    b = np.arange(A.shape[0], dtype=float)
    r1, r2 = [], []
    x, ml = pyamg_tpu_torch.solve(A, b, verb=False, residuals=r1,
                                  return_solver=True, device="cpu")
    y = _jax(pyamg_tpu.solve, A.copy(), b, verb=False, residuals=r2)
    y = np.asarray(y)
    assert len(r1) == len(r2)
    assert np.linalg.norm(x.numpy() - y) <= 1e-8 * np.linalg.norm(y)
    assert np.linalg.norm(b - A @ x.numpy()) <= 1e-5 * np.linalg.norm(b)
    # the energy hierarchy of the configuration, reused
    assert ml.levels[0].symmetry == "hermitian"
    x2 = pyamg_tpu_torch.solve(A, b, existing_solver=ml, verb=False,
                               device="cpu")
    np.testing.assert_array_equal(x2.numpy(), x.numpy())


def test_solve_prints_what_the_jax_package_prints(capsys):
    A = poisson((12, 12), format="csr")
    pyamg_tpu_torch.solve(A, np.ones(A.shape[0]), device="cpu")
    out = capsys.readouterr().out
    assert "Detected a hermitian matrix" in out
    assert "Residual reduction factor" in out and "Number of Levels" in out


def test_nonsymmetric_solver_raises_before_any_setup(monkeypatch):
    """(A nonsymmetric matrix raised here, before any setup, until the
    nonsymmetric slice ported its chain: ``solver`` now builds the JAX
    package's nonsymmetric hierarchy, and ``solve`` runs GMRES on it;
    ``test_torch_nonsymmetric.py`` compares both level by level.)  A
    setup that fails raises ``TypeError``, as in the JAX package."""
    import pyamg_tpu_torch.aggregation as aggregation

    A = _nonsymmetric(24)
    config = pyamg_tpu_torch.solver_configuration(A, verb=False)
    ml = pyamg_tpu_torch.solver(A, config, device="cpu")
    ref = _jax(pyamg_tpu.solver, A.copy(),
               pyamg_tpu.solver_configuration(A, verb=False))
    assert [lvl.A_csr.nnz for lvl in ml.levels] == \
        [lvl.A_csr.nnz for lvl in ref.levels]
    assert ml.levels[0].symmetry == "nonsymmetric"
    assert ml.levels[0].presmoother.kind == "jacobi_nr"
    b = np.ones(A.shape[0])
    r1, r2 = [], []
    pyamg_tpu_torch.solve(A, b, verb=False, residuals=r1, device="cpu")
    _jax(pyamg_tpu.solve, A.copy(), b, verb=False, residuals=r2)
    assert len(r1) == len(r2) and r1[-1] <= 1e-5 * r1[0]

    def broken(*args, **kw):
        raise RuntimeError("setup failed")

    monkeypatch.setattr(aggregation, "smoothed_aggregation_solver", broken)
    with pytest.raises(TypeError, match="failed to generate solver"):
        pyamg_tpu_torch.solver(A, config, device="cpu")
    with pytest.raises(TypeError, match="square"):
        pyamg_tpu_torch.blackbox.make_csr(sp.random(4, 5, format="csr"))


# ---------------------------------------------------------------------------
# complexity
# ---------------------------------------------------------------------------

# tests/test_util.py::TestComplexity's profile of the 500^2 Poisson SA
# hierarchy and the reference model's values on it
PROFILE = [
    dict(a_nnz=1248000, n=250000, p_nnz=582000, p_rows=250000, b_cols=1),
    dict(a_nnz=249001, n=27889, p_nnz=76729, p_rows=27889, b_cols=1),
    dict(a_nnz=27556, n=3136, p_nnz=8464, p_rows=3136, b_cols=1),
    dict(a_nnz=3025, n=361, b_cols=1),
]
REF_SETUP = 18.582358074039597
REF_CYCLE = {"V": 4.888824519230769, "W": 5.9591378205128205,
             "F": 5.868393429487179}
PRES = ("block_gauss_seidel", {"sweep": "symmetric"})


def _mock_ml():
    levels = []
    for e in PROFILE:
        lvl = types.SimpleNamespace()
        lvl.A_csr = types.SimpleNamespace(nnz=e["a_nnz"],
                                          shape=(e["n"], e["n"]))
        if "p_nnz" in e:
            lvl.P_csr = types.SimpleNamespace(nnz=e["p_nnz"],
                                              shape=(e["p_rows"], 0))
        lvl.B = np.ones((e["n"], e["b_cols"]))
        levels.append(lvl)
    return types.SimpleNamespace(levels=levels)


def test_complexity_models_hold_the_reference_pins():
    impr = ("block_gauss_seidel", {"sweep": "symmetric", "iterations": 4})
    sc = complexity.setup_complexity(
        _mock_ml(), strength="symmetric",
        smooth=("jacobi", {"omega": 4.0 / 3.0}), improve_candidates=impr,
        aggregate="standard", presmoother=PRES, postsmoother=PRES)
    assert abs(sc - REF_SETUP) / REF_SETUP < 1e-10
    for cyc, want in REF_CYCLE.items():
        got = complexity.cycle_complexity(_mock_ml(), cyc, presmoothing=PRES,
                                          postsmoothing=PRES)
        assert abs(got - want) / want < 1e-10, (cyc, got, want)
    v, w, amli = (complexity.cycle_complexity(_mock_ml(), c,
                                              presmoothing=PRES,
                                              postsmoothing=PRES)
                  for c in ("V", "W", "AMLI"))
    assert v < w < amli
    with pytest.raises(ValueError, match="cycle"):
        complexity.cycle_complexity(_mock_ml(), "X", presmoothing=PRES)
    with pytest.raises(TypeError, match="unexpected"):
        complexity.setup_complexity(_mock_ml(), no_such_cost=1.0)


def test_complexity_reads_the_options_of_the_hierarchy():
    A = poisson((24, 24), format="csr")
    ml = pyamg_tpu_torch.smoothed_aggregation_solver(
        A, presmoother="chebyshev", postsmoother="chebyshev", max_coarse=30,
        improve_candidates=None, device="cpu")
    base = complexity.cycle_complexity(ml)       # chebyshev degree 3
    plain = complexity.cycle_complexity(ml, presmoothing="jacobi",
                                        postsmoothing="jacobi")
    assert base > 2.0 * plain
    two = complexity.cycle_complexity(
        ml, presmoothing=("jacobi", {"iterations": 2}),
        postsmoothing=("jacobi", {"iterations": 2}))
    coarse = ml.levels[-1].A_csr.nnz / ml.levels[0].A_csr.nnz
    assert abs((two - plain) - (plain - coarse)) < 1e-12
    assert complexity.setup_complexity(
        ml, strength=("evolution", {"k": 4})) > \
        complexity.setup_complexity(ml, strength="symmetric")


def _hierarchies(name):
    """(port hierarchy, JAX hierarchy, setup options) of one call."""
    A = poisson((24, 24), format="csr")
    J = A.copy()
    J.grid = A.grid
    if name == "default":
        return (pyamg_tpu_torch.smoothed_aggregation_solver(A, device="cpu"),
                _jax(pyamg_tpu.smoothed_aggregation_solver, J), {})
    if name == "chebyshev":
        kw = dict(presmoother="chebyshev", postsmoother="chebyshev",
                  improve_candidates=None, max_coarse=20)
        return (pyamg_tpu_torch.smoothed_aggregation_solver(A, device="cpu",
                                                            **kw),
                _jax(pyamg_tpu.smoothed_aggregation_solver, J, **kw), {})
    if name == "zebra":
        A = stencil_grid(diffusion_stencil_2d(epsilon=1e-3, theta=0.0,
                                              type="FD"), (27, 27),
                         format="csr")
        J = A.copy()
        J.grid = A.grid
        kw = dict(presmoother="zebra", postsmoother="zebra", max_coarse=20)
        return (pyamg_tpu_torch.smoothed_aggregation_solver(A, device="cpu",
                                                            **kw),
                _jax(pyamg_tpu.smoothed_aggregation_solver, J, **kw), {})
    if name == "rootnode":
        return (pyamg_tpu_torch.rootnode_solver(A, max_coarse=20,
                                                device="cpu"),
                _jax(pyamg_tpu.rootnode_solver, J, max_coarse=20),
                dict(smooth=("energy", {"maxiter": 4})))
    if name == "classical":
        return (pyamg_tpu_torch.ruge_stuben_solver(A, max_coarse=20,
                                                   device="cpu"),
                _jax(pyamg_tpu.ruge_stuben_solver, J, max_coarse=20),
                dict(strength="classical", smooth=None))
    config = pyamg_tpu_torch.solver_configuration(A, verb=False)
    return (pyamg_tpu_torch.solver(A, config, device="cpu"),
            _jax(pyamg_tpu.solver, J,
                 pyamg_tpu.solver_configuration(J, verb=False)),
            dict(strength=config["strength"], smooth=config["smooth"]))


@pytest.mark.parametrize("name", ["default", "chebyshev", "zebra",
                                  "rootnode", "classical", "blackbox"])
def test_complexity_equals_jax_on_the_same_hierarchies(name):
    ours, ref, kw = _hierarchies(name)
    assert [lvl.A_csr.nnz for lvl in ours.levels] == \
        [lvl.A_csr.nnz for lvl in ref.levels]
    for cycle in ("V", "W", "F", "AMLI"):
        got = complexity.cycle_complexity(ours, cycle)
        want = jax_complexity.cycle_complexity(ref, cycle)
        assert got == pytest.approx(want, rel=1e-14), cycle
    got = complexity.setup_complexity(ours, **kw)
    want = jax_complexity.setup_complexity(ref, **kw)
    assert got == pytest.approx(want, rel=1e-14)
    assert pyamg_tpu_torch.cycle_complexity is complexity.cycle_complexity


# ---------------------------------------------------------------------------
# util.linalg and util.utils
# ---------------------------------------------------------------------------

def test_linalg_functions_equal_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal(50) + 1j * rng.standard_normal(50)
    for p in ("2", "inf"):
        assert linalg.norm(x, p) == jax_linalg.norm(x, p)
    assert linalg.norm(np.zeros(0), "inf") == 0.0
    with pytest.raises(ValueError, match="norm"):
        linalg.norm(x, "fro")
    A = poisson((9, 9), format="csr")
    b = rng.standard_normal(81)
    assert linalg.infinity_norm(A) == jax_linalg.infinity_norm(A) == 8.0
    assert linalg.infinity_norm(A.toarray()) == 8.0
    assert linalg.residual_norm(A, b, b) == jax_linalg.residual_norm(A, b, b)
    assert linalg.cond(A) == pytest.approx(jax_linalg.cond(A), rel=1e-12)
    assert linalg.condest(A) == pytest.approx(jax_linalg.condest(A),
                                              rel=1e-12)
    big = poisson((50, 50), format="csr")
    assert linalg.condest(big) == jax_linalg.condest(big)


@pytest.mark.parametrize("matrix", ["poisson", "nonsymmetric", "complex",
                                    "dense"])
def test_ishermitian_equals_jax(matrix):
    if matrix == "poisson":
        A = poisson((10, 10), format="csr")
    elif matrix == "nonsymmetric":
        A = _nonsymmetric(10)
    elif matrix == "complex":
        A = pyamg_tpu_torch.gallery.gauge_laplacian(6, beta=0.1, seed=0)
    else:
        A = np.array([[1.0, 2.0], [0.0, 1.0]])
    for fast in (True, False):
        for seed in (0, 3):
            assert linalg.ishermitian(A, fast_check=fast, seed=seed) == \
                jax_linalg.ishermitian(A, fast_check=fast, seed=seed)
    assert linalg.ishermitian(A) == (matrix in ("poisson", "complex"))


def test_utils_filters_and_rescaling_equal_jax():
    rng = np.random.default_rng(7)
    A = (poisson((10, 10), format="csr")
         + sp.random(100, 100, density=0.05, random_state=1)).tocsr()
    for ours, ref in zip(utils.symmetric_rescaling(A),
                         jax_utils.symmetric_rescaling(A)):
        _close(ours, ref, 0.0) if sp.issparse(ref) else \
            np.testing.assert_array_equal(ours, ref)
    for k in (1, 3):
        _close(utils.truncate_rows(A, k), jax_utils.truncate_rows(A, k), 0.0)
        assert np.diff(utils.truncate_rows(A, k).indptr).max() <= k
    _close(utils.filter_matrix_columns(A, 0.3),
           jax_utils.filter_matrix_columns(A, 0.3), 0.0)
    T = sp.random(100, 20, density=0.2, random_state=2, format="csr")
    C = sp.random(100, 20, density=0.1, random_state=3, format="csr")
    Bc = rng.standard_normal((20, 2))
    Bf = T @ Bc
    F = utils.filter_operator(T, C, Bc, Bf)
    _close(F, jax_utils.filter_operator(T, C, Bc, Bf), 1e-13)
    # the constraint holds on every row that kept enough entries
    rows = np.diff(F.indptr) >= 2
    np.testing.assert_allclose((F @ Bc)[rows], Bf[rows], atol=1e-10)
