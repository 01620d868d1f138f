"""The port's strength measures (``pyamg_tpu_torch.strength``) and the
bindings of the compiled host library they call, against the JAX package.

The same numpy-seeded inputs go to both packages: a 5-point Poisson
operator, the rotated anisotropic stencil of the classical benchmark cell
(epsilon 0.01, theta pi/4, finite differences) and a Q1 elasticity operator
in BSR with its rigid-body modes.  Patterns are equal exactly, values to
1e-12 relative; each binding equals its Python form and the JAX package's
binding; with the port's library forced off, the Python forms give the
JAX package's results too.  Both constructors accept every strength name
the JAX package accepts.
"""

import time
import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pyamg_tpu
import pyamg_tpu.amg_core as jax_core
import pyamg_tpu.strength as jax_strength
import pyamg_tpu_torch
from pyamg_tpu_torch import amg_core, strength
from pyamg_tpu_torch.gallery import (diffusion_stencil_2d, linear_elasticity,
                                     poisson, stencil_grid)

from sa_cases import unstructured

torch.set_num_threads(1)

N = 24
ROTATED = dict(epsilon=0.01, theta=np.pi / 4, type="FD")


def _matrix(name, n=N):
    if name == "poisson":
        return sp.csr_matrix(poisson((n, n), format="csr"))
    if name == "aniso":
        return sp.csr_matrix(stencil_grid(diffusion_stencil_2d(**ROTATED),
                                          (n, n), format="csr"))
    if name == "elasticity":
        A, _B = linear_elasticity((n // 3, n // 3))
        return A
    raise KeyError(name)


def _coords(n):
    x, y = np.meshgrid(np.arange(n, dtype=float), np.arange(n, dtype=float),
                       indexing="ij")
    return np.column_stack([x.ravel(), y.ravel()])


def _same(S, J, rtol=1e-12):
    """Equal patterns, values to ``rtol`` of the largest."""
    S, J = sp.csr_matrix(S), sp.csr_matrix(J)
    S.sort_indices()
    J.sort_indices()
    assert S.shape == J.shape
    np.testing.assert_array_equal(S.indptr, J.indptr)
    np.testing.assert_array_equal(S.indices, J.indices)
    scale = max(float(np.abs(J.data).max()), 1e-300) if J.nnz else 1.0
    assert np.abs(S.data - J.data).max(initial=0.0) <= rtol * scale


@pytest.fixture(autouse=True)
def jax_library():
    """The JAX package builds its library at first use in each process, to
    one path; a process that met another's half-written file keeps
    ``_lib = False``: load again until the finished file is there."""
    for _ in range(60):
        if jax_core._lib or jax_core.have_native():
            break
        jax_core._lib = None
        time.sleep(1)
    assert jax_core.have_native()


@pytest.fixture
def python_forms(monkeypatch):
    """Force the port's Python forms."""
    monkeypatch.setattr(amg_core, "_lib", False)
    assert not amg_core.have_native()


# ---------------------------------------------------------------------------
# the bindings of the evolution measure
# ---------------------------------------------------------------------------

def _with_index(A, index_dtype):
    A = sp.csr_matrix(A).copy()
    A.sort_indices()
    A.indptr = A.indptr.astype(index_dtype)
    A.indices = A.indices.astype(index_dtype)
    return A


@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("name", ["poisson", "aniso"])
def test_scaled_identity_bindings(name, index_dtype):
    A = _with_index(_matrix(name), index_dtype)
    n = A.shape[0]
    Dinv = 1.0 / A.diagonal()
    c = 0.37
    got = amg_core.identity_minus_scaled_native(A, c)
    ref = (sp.eye(n, format="csr") - c * A).tocsr()
    ref.sort_indices()
    np.testing.assert_array_equal(got, ref.data)
    np.testing.assert_array_equal(got, jax_core.identity_minus_scaled_native(
        A, c))
    got = amg_core.identity_minus_colscaled_native(A, Dinv, c)
    form = -c * (A.data * Dinv[A.indices]) + (
        A.indices == np.repeat(np.arange(n), np.diff(A.indptr)))
    np.testing.assert_array_equal(got, form)
    np.testing.assert_array_equal(
        got, jax_core.identity_minus_colscaled_native(A, Dinv, c))
    # a row without its diagonal: the caller takes the sparse sum
    B = sp.csr_matrix(A.toarray() - np.diag(A.diagonal()) * (
        np.arange(n) == 3)[:, None])
    assert amg_core.identity_minus_scaled_native(B, c) is None


@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
def test_pattern_values_binding(index_dtype):
    A = _with_index(_matrix("aniso"), index_dtype)
    C = _with_index(strength.classical_strength_of_connection(A, 0.25),
                    index_dtype)
    got = amg_core.pattern_values_native(C, A)
    ones = C.copy()
    ones.data = np.ones_like(ones.data)
    form = ones.multiply(A).tocsr()
    form.sort_indices()
    np.testing.assert_array_equal(got, form.data)
    np.testing.assert_array_equal(got, jax_core.pattern_values_native(C, A))
    # an entry of C outside A: the exact intersection is scipy's
    C2 = (C + sp.csr_matrix(([1.0], ([0], [A.shape[0] - 1])),
                            shape=A.shape)).tocsr()
    C2.sort_indices()
    assert amg_core.pattern_values_native(C2, A) is None


def _evolved(name):
    """An evolved operator of the kind the evolution measure's fit
    receives: (I - D^-1 A / 2)^2 on A's pattern."""
    A = _matrix(name)
    Atilde = (sp.eye(A.shape[0]) - 0.5 * sp.diags(1 / A.diagonal()) @ A)
    M = (Atilde @ Atilde).multiply(A != 0).tocsr()
    M.sort_indices()
    return M


@pytest.mark.parametrize("name", ["poisson", "aniso"])
def test_evolution_fit_and_filter_bindings(name):
    M = _evolved(name)
    tiny = np.sqrt(np.finfo(float).eps)
    b1 = 0.5 + np.random.default_rng(0).random(M.shape[0])
    got, jax_got = M.copy(), M.copy()
    assert amg_core.evolution_nulldim1_native(got, b1, tiny)
    assert jax_core.evolution_nulldim1_native(jax_got, b1, tiny)
    np.testing.assert_array_equal(got.data, jax_got.data)
    # the Python form of the strength function: the fit's misfits
    coeff = M.diagonal() / b1
    rows = np.repeat(np.arange(M.shape[0]), np.diff(M.indptr))
    zhat = coeff[rows] * b1[M.indices]
    ratio = zhat / M.data
    form = np.where((zhat * M.data >= 0) & (np.abs(ratio) >= 1e-4),
                    np.abs(1 - ratio), 0.0)
    form[(form > 0) & (form < tiny)] = 1e-4
    np.testing.assert_array_equal(got.data, form)

    D = got.copy()
    D.eliminate_zeros()
    d1, d2 = D.copy(), D.copy()
    assert amg_core.distance_filter_native(d1, 4.0)
    assert jax_core.distance_filter_native(d2, 4.0)
    np.testing.assert_array_equal(d1.data, d2.data)
    d1.eliminate_zeros()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(amg_core, "_lib", False)
        _same(strength.apply_distance_filter(D, 4.0), d1, 0.0)
    _same(strength.apply_distance_filter(D, 4.0),
          jax_strength.apply_distance_filter(D.copy(), 4.0), 0.0)

    for sym in (True, False):
        got = amg_core.evolution_epilogue_native(D.copy(), 4.0, sym)
        _same(got, jax_core.evolution_epilogue_native(D.copy(), 4.0, sym),
              0.0)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(amg_core, "_lib", False)
            _same(strength._evolution_epilogue(D.copy(), 4.0, sym), got)


def test_bindings_refuse_what_they_do_not_take(python_forms):
    M = _evolved("poisson")
    assert amg_core.identity_minus_scaled_native(M, 0.5) is None
    assert amg_core.identity_minus_colscaled_native(
        M, np.ones(M.shape[0]), 0.5) is None
    assert amg_core.pattern_values_native(M, M) is None
    assert not amg_core.evolution_nulldim1_native(M, np.ones(M.shape[0]),
                                                  1e-8)
    assert not amg_core.distance_filter_native(M, 2.0)
    assert amg_core.evolution_epilogue_native(M, 2.0, True) is None


def test_bindings_take_real_float64_only():
    M = _evolved("poisson").astype(np.float32)
    assert amg_core.identity_minus_scaled_native(M, 0.5) is None
    assert amg_core.evolution_epilogue_native(M, 2.0, True) is None
    assert not amg_core.distance_filter_native(M, 2.0)


# ---------------------------------------------------------------------------
# the evolution measure
# ---------------------------------------------------------------------------

def _candidates(kind, n):
    rng = np.random.default_rng(7)
    if kind is None:
        return None
    if kind == "one":
        return 0.5 + rng.random((n, 1))
    return np.column_stack([np.ones(n), 0.5 + rng.random(n)])


@pytest.mark.parametrize("proj_type", ["l2", "D_A"])
@pytest.mark.parametrize("B", [None, "one", "two"])
@pytest.mark.parametrize("name", ["poisson", "aniso"])
def test_evolution_matches_jax(name, B, proj_type):
    A = _matrix(name)
    Bm = _candidates(B, A.shape[0])
    ours = strength.evolution_strength_of_connection(
        A, None if Bm is None else Bm.copy(), proj_type=proj_type)
    ref = jax_strength.evolution_strength_of_connection(
        A.copy(), None if Bm is None else Bm.copy(), proj_type=proj_type)
    _same(ours, ref)


@pytest.mark.parametrize("block_flag", [False, True])
@pytest.mark.parametrize("proj_type", ["l2", "D_A"])
def test_evolution_on_bsr_matches_jax(proj_type, block_flag):
    A, B = linear_elasticity((8, 8))
    ours = strength.evolution_strength_of_connection(
        A, B.copy(), proj_type=proj_type, block_flag=block_flag)
    ref = jax_strength.evolution_strength_of_connection(
        A.copy(), B.copy(), proj_type=proj_type, block_flag=block_flag)
    assert ours.shape == (A.shape[0] // 2,) * 2
    _same(ours, ref)


@pytest.mark.parametrize("kw", [dict(k=3), dict(k=1),
                                dict(symmetrize_measure=False),
                                dict(epsilon=np.inf), dict(epsilon=2.0)],
                         ids=["k3", "k1", "unsymmetrized", "eps-inf",
                              "eps2"])
def test_evolution_options_match_jax(kw):
    A = _matrix("aniso")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours = strength.evolution_strength_of_connection(A, **kw)
        ref = jax_strength.evolution_strength_of_connection(A.copy(), **kw)
    _same(ours, ref)


@pytest.mark.parametrize("name", ["poisson", "aniso"])
def test_evolution_python_forms_match_jax(name, python_forms):
    A = _matrix(name)
    _same(strength.evolution_strength_of_connection(A),
          jax_strength.evolution_strength_of_connection(A.copy()))
    # a nonsymmetric operator takes the transpose route
    Anon = (A + sp.diags(0.1 * np.ones(A.shape[0] - 1), 1)).tocsr()
    _same(strength.evolution_strength_of_connection(Anon),
          jax_strength.evolution_strength_of_connection(Anon.copy()))


def test_evolution_checks_and_hook():
    A = _matrix("poisson", 8)
    for kw in (dict(epsilon=0.5), dict(k=0), dict(proj_type="l1")):
        with pytest.raises(ValueError):
            strength.evolution_strength_of_connection(A, **kw)
    seen = []

    def hook(Atilde_T, nsquare, mask):
        seen.append(nsquare)
        return strength._masked_power(Atilde_T, nsquare, mask)

    _same(strength.evolution_strength_of_connection(
        A, _masked_power_impl=hook),
        strength.evolution_strength_of_connection(A), 0.0)
    assert seen == [1]
    with pytest.warns(DeprecationWarning):
        S = strength.ode_strength_of_connection(A)
    _same(S, jax_strength.evolution_strength_of_connection(A.copy()))


@pytest.mark.parametrize("nsquare", [0, 1, 2])
def test_masked_power_matches_jax(nsquare):
    M = _evolved("aniso")
    mask = _matrix("aniso")
    _same(strength._masked_power(M, nsquare, mask),
          jax_strength._masked_power(M.copy(), nsquare, mask.copy()))


# ---------------------------------------------------------------------------
# the other measures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("theta", [0.0, 0.3])
@pytest.mark.parametrize("name", ["poisson", "aniso", "elasticity"])
def test_energy_based_matches_jax(name, theta):
    A = _matrix(name, 9)
    _same(strength.energy_based_strength_of_connection(A, theta=theta),
          jax_strength.energy_based_strength_of_connection(A.copy(),
                                                           theta=theta))


def test_energy_based_checks():
    A = _matrix("poisson", 6)
    with pytest.raises(ValueError):
        strength.energy_based_strength_of_connection(A, theta=-1)
    with pytest.raises(ValueError):
        strength.energy_based_strength_of_connection(A, k=1.5)


@pytest.mark.parametrize("kw", [dict(), dict(theta=1.5),
                                dict(theta=np.inf),
                                dict(theta=1.2, relative_drop=False)],
                         ids=["default", "theta1.5", "no-filter",
                              "absolute"])
@pytest.mark.parametrize("name", ["poisson", "aniso", "elasticity"])
def test_distance_matches_jax(name, kw):
    A = _matrix(name)
    nodes = int(np.sqrt(A.shape[0] // (2 if name == "elasticity" else 1)))
    V = _coords(nodes) + 0.01 * np.random.default_rng(3).random(
        (nodes * nodes, 2))
    _same(strength.distance_strength_of_connection(A, V, **kw),
          jax_strength.distance_strength_of_connection(A.copy(), V, **kw))


@pytest.mark.parametrize("fn,kw", [
    ("affinity_distance", dict()),
    ("affinity_distance", dict(R=3, k=4, epsilon=2.0)),
    ("algebraic_distance", dict()),
    ("algebraic_distance", dict(p=np.inf)),
    ("algebraic_distance", dict(p=1, alpha=0.7))],
    ids=["affinity", "affinity-R3", "algebraic", "algebraic-inf",
         "algebraic-p1"])
@pytest.mark.parametrize("name", ["poisson", "aniso"])
def test_relaxation_distances_match_jax(name, fn, kw):
    A = _matrix(name)
    _same(getattr(strength, fn)(A, seed=5, **kw),
          getattr(jax_strength, fn)(A.copy(), seed=5, **kw))


def test_relaxation_vectors_and_distance_checks():
    A = _matrix("aniso", 10)
    np.testing.assert_allclose(
        strength.relaxation_vectors(A, 4, 6, 0.5, seed=2),
        jax_strength.relaxation_vectors(A.copy(), 4, 6, 0.5, seed=2),
        rtol=1e-12, atol=1e-15)
    for kw in (dict(alpha=-1), dict(R=0), dict(k=0), dict(epsilon=0.5)):
        with pytest.raises(ValueError):
            strength.affinity_distance(A, **kw)
    with pytest.raises(ValueError):
        strength.algebraic_distance(A, p=0.5)


@pytest.mark.parametrize("fn", ["apply_distance_filter",
                                "apply_absolute_distance_filter"])
def test_distance_filters_match_jax(fn):
    C = _evolved("aniso")
    C.data = np.abs(C.data) + 0.1
    for eps in (1.5, 4.0):
        _same(getattr(strength, fn)(C, eps),
              getattr(jax_strength, fn)(C.copy(), eps), 0.0)


# ---------------------------------------------------------------------------
# both constructors take every name
# ---------------------------------------------------------------------------

def _names(n):
    V = np.random.default_rng(1).random((n, 2))
    return {"classical": "classical", "symmetric": "symmetric",
            "evolution": "evolution", "ode": "ode",
            "energy_based": "energy_based",
            "distance": ("distance", {"V": V}),
            "affinity": ("affinity", {"seed": 0}),
            "algebraic_distance": ("algebraic_distance", {"seed": 0}),
            "none": None}


@pytest.mark.parametrize("name", list(_names(1)))
@pytest.mark.parametrize("constructor", ["smoothed_aggregation_solver",
                                         "ruge_stuben_solver"])
def test_both_constructors_take_every_strength(constructor, name):
    A = unstructured(300, seed=4, radius=0.12)
    flag = _names(A.shape[0])[name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ours = getattr(pyamg_tpu_torch, constructor)(
            A.copy(), strength=flag, max_coarse=30, device="cpu")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_core, "have_native", lambda: True)
            ref = getattr(pyamg_tpu, constructor)(A.copy(), strength=flag,
                                                  max_coarse=30)
    assert [lvl.A_csr.shape for lvl in ours.levels] == \
        [lvl.A_csr.shape for lvl in ref.levels]
    for lo, lr in zip(ours.levels, ref.levels):
        _same(lo.A_csr, lr.A_csr, 1e-10)
