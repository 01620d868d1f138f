"""The port's classical AMG (``pyamg_tpu_torch.classical``), its line
smoothers and its device setup ``parallel.classical_setup_sharded``,
against the JAX package.

Inputs come from numpy seeds: a 5-point Poisson operator and the rotated
anisotropic stencil of the classical benchmark cell (epsilon 0.01, theta
pi/4, finite differences), at most 64^2 (128^2 and 500^2 for the
reference fingerprints).  Splittings are equal bit for bit; interpolation
and hierarchy patterns exactly, values to 1e-12 relative (float64) and
1e-6 (the float32 device setup); iteration counts exactly.  The JAX
package runs as its own tests run it on the CPU, its
``amg_core.have_native`` patched to True.
"""

import hashlib
import json
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pyamg_tpu
import pyamg_tpu.amg_core as jax_core
import pyamg_tpu.classical.cr as jax_cr
import pyamg_tpu.classical.interpolate as jax_interp
import pyamg_tpu.classical.split as jax_split
import pyamg_tpu.relaxation.device as jax_device
import pyamg_tpu.relaxation.relaxation as jax_relax
import pyamg_tpu_torch
from pyamg_tpu_torch import amg_core
from pyamg_tpu_torch.classical import cr, interpolate, split
from pyamg_tpu_torch.gallery import (diffusion_stencil_2d, poisson,
                                     stencil_grid)
from pyamg_tpu_torch.parallel import classical_setup_sharded
from pyamg_tpu_torch.relaxation import relaxation
from pyamg_tpu_torch.relaxation.device import (apply_smoother,
                                               batched_tridiag_pcr,
                                               line_relaxation_step)
from pyamg_tpu_torch.strength import (classical_strength_of_connection,
                                      evolution_strength_of_connection)
from pyamg_tpu_torch.util.convert import hierarchy_from_numpy

from sa_cases import ARRAYS, assert_same_smoother

torch.set_num_threads(1)

ROTATED = dict(epsilon=0.01, theta=np.pi / 4, type="FD")
EVOLUTION = ("evolution", {"k": 2, "epsilon": 4.0})
FINGERPRINTS = Path(__file__).parent / "fixtures" / \
    "rs_reference_fingerprints.json"


def _matrix(name, n=32):
    if name == "poisson":
        return poisson((n, n), format="csr")
    return stencil_grid(diffusion_stencil_2d(**ROTATED), (n, n),
                        format="csr")


def _copy(A):
    """A copy of a gallery matrix that keeps its grid metadata."""
    B = A.copy()
    if hasattr(A, "grid"):
        B.grid = A.grid
    return B


def _same(S, J, rtol=1e-12):
    S, J = sp.csr_matrix(S), sp.csr_matrix(J)
    S.sort_indices()
    J.sort_indices()
    assert S.shape == J.shape
    np.testing.assert_array_equal(S.indptr, J.indptr)
    np.testing.assert_array_equal(S.indices, J.indices)
    scale = max(float(np.abs(J.data).max()), 1e-300) if J.nnz else 1.0
    assert np.abs(S.data - J.data).max(initial=0.0) <= rtol * scale


def _jax(fn, *args, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_core, "have_native", lambda: True)
        return fn(*args, **kw)


@pytest.fixture(autouse=True)
def jax_library():
    """The JAX package builds its library at first use in each process, to
    one path; load again until the finished file is there."""
    for _ in range(60):
        if jax_core._lib or jax_core.have_native():
            break
        jax_core._lib = None
        time.sleep(1)
    assert jax_core.have_native()


@pytest.fixture
def python_forms(monkeypatch):
    monkeypatch.setattr(amg_core, "_lib", False)
    assert not amg_core.have_native()


# ---------------------------------------------------------------------------
# the bindings of classical AMG
# ---------------------------------------------------------------------------

def _strength_pattern(name, index_dtype):
    C = classical_strength_of_connection(_matrix(name), 0.25)
    S, T = split.preprocess_strength(C)
    for M in (S, T):
        M.indptr = M.indptr.astype(index_dtype)
        M.indices = M.indices.astype(index_dtype)
    return C, S, T


@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("name", ["poisson", "aniso"])
def test_rs_binding_python_form_and_jax_agree(name, index_dtype,
                                              monkeypatch):
    C, S, T = _strength_pattern(name, index_dtype)
    native = amg_core.rs_cf_splitting(S, T)
    np.testing.assert_array_equal(native, jax_core.rs_cf_splitting(S, T))
    monkeypatch.setattr(amg_core, "_lib", False)
    assert amg_core.rs_cf_splitting(S, T) is None
    np.testing.assert_array_equal(split.RS(C), native)


@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("name", ["poisson", "aniso"])
def test_interpolation_bindings_python_forms_and_jax_agree(name,
                                                           index_dtype):
    A = sp.csr_matrix(_matrix(name))
    A.indptr = A.indptr.astype(index_dtype)
    A.indices = A.indices.astype(index_dtype)
    C = classical_strength_of_connection(A, 0.25)
    s = split.RS(C)
    cmap = np.cumsum(s) - s
    nc = int(s.sum())
    P = amg_core.direct_interpolation_native(A, C, s, cmap, nc)
    _same(P, jax_core.direct_interpolation_native(A, C, s, cmap, nc), 0.0)
    S = C.copy()
    S.data = amg_core.pattern_values_native(C, A)
    Ps = amg_core.standard_interpolation_native(A, S, s, cmap, nc)
    _same(Ps, jax_core.standard_interpolation_native(A, S, s, cmap, nc),
          0.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(amg_core, "_lib", False)
        _same(interpolate.direct_interpolation(A, C, s), P)
        _same(interpolate.standard_interpolation(A, C, s), Ps)
    _same(interpolate._standard_interpolation_loop(A, C, s), Ps)


def test_thomas_binding_python_form_and_jax_agree():
    rng = np.random.default_rng(3)
    dl, du = -rng.random((2, 37, 19))
    dm = 2.5 + rng.random((37, 19))
    dl[:, 0] = du[:, -1] = 0
    R = rng.standard_normal((37, 19))
    ours, ref = R.copy(), R.copy()
    assert amg_core.thomas_lines_native(dl, dm, du, ours)
    assert jax_core.thomas_lines_native(dl, dm, du, ref)
    np.testing.assert_array_equal(ours, ref)
    for line in range(0, 37, 6):
        T = sp.diags([dl[line, 1:], dm[line], du[line, :-1]], [-1, 0, 1])
        np.testing.assert_allclose(T @ ours[line], R[line], rtol=1e-12,
                                   atol=1e-12)
    assert not amg_core.thomas_lines_native(dl, dm, du, R.astype(np.float32))


def test_bindings_off_without_the_library(python_forms):
    C, S, T = _strength_pattern("poisson", np.int64)
    A = _matrix("poisson")
    s = split.RS(C)
    cmap = np.cumsum(s) - s
    assert amg_core.rs_cf_splitting(S, T) is None
    assert amg_core.direct_interpolation_native(A, C, s, cmap, 1) is None
    assert amg_core.standard_interpolation_native(A, C, s, cmap, 1) is None
    assert not amg_core.thomas_lines_native(*np.ones((4, 2, 3)))


# ---------------------------------------------------------------------------
# splittings and interpolation
# ---------------------------------------------------------------------------

SPLITTINGS = ["RS", "RS-python", "PMIS", "PMIS-seed", "PMISc", "CLJP",
              "CLJP-seed", "CLJPc", "MIS", "CR", "CR-concurrent",
              "CR-thetacs", "grid"]


def _split(mod, kind, A, C):
    if kind == "RS-python":
        kind = "RS"
    if kind == "grid":
        return mod.grid_splitting((32, 32))[0]
    if kind.startswith("CR"):
        kw = {"CR": {}, "CR-concurrent": {"method": "concurrent"},
              "CR-thetacs": {"thetacs": [0.3, 0.5], "B": np.linspace(
                  1, 2, A.shape[0])}}[kind]
        crmod = cr if mod is split else jax_cr
        return crmod.CR(_copy(A), **kw)
    kw = {"PMIS-seed": {"seed": 3}, "CLJP-seed": {"seed": 5}}.get(kind, {})
    return getattr(mod, kind.split("-")[0])(C.copy(), **kw)


@pytest.mark.parametrize("kind", SPLITTINGS)
@pytest.mark.parametrize("name", ["poisson", "aniso"])
def test_splittings_equal_jax_bitwise(name, kind, monkeypatch):
    A = _matrix(name)
    C = evolution_strength_of_connection(A) if name == "aniso" \
        else classical_strength_of_connection(A, 0.25)
    ref = _jax(_split, jax_split, kind, A, C)
    if kind == "RS-python":
        monkeypatch.setattr(amg_core, "_lib", False)
    ours = _split(split, kind, A, C)
    assert ours.dtype == np.int32
    np.testing.assert_array_equal(ours, ref)
    assert 0 < ours.sum() < ours.size


@pytest.mark.parametrize("interp", ["direct", "standard"])
@pytest.mark.parametrize("name", ["poisson", "aniso"])
def test_interpolation_matches_jax(name, interp):
    A = _matrix(name, 48)
    C = evolution_strength_of_connection(A)
    s = split.RS(C)
    fn = interp + "_interpolation"
    _same(getattr(interpolate, fn)(A, C, s),
          getattr(jax_interp, fn)(_copy(A), C.copy(), s))
    # the C/F splitting of PMIS: C points with no strong C neighbour
    sp_ = split.PMIS(C)
    _same(getattr(interpolate, fn)(A, C, sp_),
          getattr(jax_interp, fn)(_copy(A), C.copy(), sp_))


def test_masked_product_and_binormalize_match_jax(python_forms):
    A = _matrix("aniso", 16)
    pat = (A @ A).tocsr()
    pat.data[::3] = 0
    pat.eliminate_zeros()
    _same(interpolate._masked_product_csr(A, A, pat),
          jax_interp._masked_product_csr(A, A, pat))
    _same(cr.binormalize(A), jax_cr.binormalize(_copy(A)))


def test_cr_checks():
    A = _matrix("poisson", 8)
    for kw in (dict(method="x"), dict(thetacr=1.5), dict(thetacs=2.0)):
        with pytest.raises(ValueError):
            cr.CR(A, **kw)
    with pytest.raises(ValueError):
        cr.CR(sp.csr_matrix(np.ones((3, 4))))


# ---------------------------------------------------------------------------
# the hierarchy, level by level
# ---------------------------------------------------------------------------

def _assert_hierarchies_match(ours, ref, rtol=1e-12):
    assert len(ours.levels) == len(ref.levels)
    for lo, lr in zip(ours.levels, ref.levels):
        _same(lo.A_csr, lr.A_csr, rtol)
        assert type(lo.A).__name__ == type(lr.A).__name__
        if not hasattr(lr, "P_csr"):
            continue
        np.testing.assert_array_equal(lo.splitting, lr.splitting)
        _same(lo.P_csr, lr.P_csr, rtol)
        _same(lo.R_csr, lr.R_csr, rtol)
        assert type(lo.P).__name__ == type(lr.P).__name__
        assert type(lo.R).__name__ == type(lr.R).__name__
        for sm, jsm in ((lo.presmoother, lr.presmoother),
                        (lo.postsmoother, lr.postsmoother)):
            _assert_same_smoother(sm, jsm)


def _assert_same_smoother(sm, jsm):
    assert_same_smoother(sm, jsm)
    assert (sm.line_tri is None) == (jsm.line_tri is None)
    if sm.line_tri is not None:
        np.testing.assert_allclose(sm.line_tri.numpy(),
                                   np.asarray(jsm.line_tri), rtol=1e-12)
        assert sm.grid == tuple(jsm.grid) and sm.line_axis == jsm.line_axis


CALLS = {"default": {}, "standard": dict(interpolation="standard"),
         "coarse_filter": dict(coarse_filter=0.02, strength=EVOLUTION),
         "evolution": dict(strength=EVOLUTION, interpolation="standard"),
         "PMIS": dict(CF="PMIS"), "CR": dict(CF="CR"),
         "grid": dict(CF="grid"), "keep": dict(keep=True),
         "zebra": dict(presmoother="zebra", postsmoother="zebra"),
         "line_jacobi": dict(presmoother=("line_jacobi", {"omega": 0.6}),
                             postsmoother="line_jacobi"),
         "float32": dict(op_dtype=np.float32)}


@pytest.mark.parametrize("call", list(CALLS))
@pytest.mark.parametrize("name", ["poisson", "aniso"])
def test_hierarchy_matches_jax_level_by_level(name, call):
    A = _matrix(name, 48)
    kw = dict(CALLS[call], max_coarse=40)
    ours = pyamg_tpu_torch.ruge_stuben_solver(_copy(A), device="cpu", **kw)
    ref = _jax(pyamg_tpu.ruge_stuben_solver, _copy(A), **kw)
    _assert_hierarchies_match(ours, ref)
    assert len(ours.levels) > 2
    if call == "keep":
        assert ours.levels[0].C.nnz == ref.levels[0].C.nnz
    if call == "float32":
        assert all(lvl.A.dtype == torch.float32 for lvl in ours.levels)


def test_hierarchy_matches_jax_without_either_library(monkeypatch):
    monkeypatch.setattr(amg_core, "_lib", False)
    monkeypatch.setattr(jax_core, "_lib", False)
    A = _matrix("aniso", 40)
    kw = dict(strength=EVOLUTION, interpolation="standard", max_coarse=40)
    ours = pyamg_tpu_torch.ruge_stuben_solver(_copy(A), device="cpu", **kw)
    ref = pyamg_tpu.ruge_stuben_solver(_copy(A), **kw)
    _assert_hierarchies_match(ours, ref)


def test_options_and_errors():
    A = _matrix("poisson", 12)
    for kw in (dict(CF="nope"), dict(interpolation="nope"),
               dict(strength="nope")):
        with pytest.raises(ValueError):
            pyamg_tpu_torch.ruge_stuben_solver(A, max_coarse=10,
                                               device="cpu", **kw)
    with pytest.raises(ValueError):
        pyamg_tpu_torch.ruge_stuben_solver(sp.csr_matrix(np.ones((3, 4))),
                                           device="cpu")
    # no strength graph: the splitting sees A itself
    ml = pyamg_tpu_torch.ruge_stuben_solver(A, strength=None, max_coarse=10,
                                            device="cpu")
    ref = _jax(pyamg_tpu.ruge_stuben_solver, _copy(A), strength=None,
               max_coarse=10)
    _assert_hierarchies_match(ml, ref)
    # a diagonal operator splits all F: one level
    assert len(pyamg_tpu_torch.ruge_stuben_solver(
        sp.identity(600, format="csr"), device="cpu").levels) == 1


def _sha(*arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("which", ["aniso_128_evolution", "poisson_500"])
def test_port_holds_the_reference_fingerprints(which):
    """Bit-exact structure of the reference pyamg's classical hierarchies
    (fixture from the reference itself): splittings and A, P patterns by
    sha256, opc and gc, P's sum."""
    want = json.loads(FINGERPRINTS.read_text())[which]
    if which == "poisson_500":
        ml = pyamg_tpu_torch.ruge_stuben_solver(
            poisson((500, 500), format="csr"), device="cpu")
    else:
        ml = pyamg_tpu_torch.ruge_stuben_solver(
            _matrix("aniso", 128), strength=EVOLUTION, device="cpu")
    assert len(ml.levels) == len(want["levels"])
    assert abs(ml.operator_complexity() - want["opc"]) < 2e-6
    assert abs(ml.grid_complexity() - want["gc"]) < 2e-6
    for i, (lvl, w) in enumerate(zip(ml.levels, want["levels"])):
        A = lvl.A_csr.tocsr()
        A.sort_indices()
        assert (A.shape[0], A.nnz) == (w["n"], w["nnz"])
        assert _sha(A.indptr.astype(np.int64), A.indices.astype(np.int64)) \
            == w["A_struct_sha"]
        if i == len(ml.levels) - 1:
            continue
        assert _sha(np.asarray(lvl.splitting, np.int32)) \
            == w["splitting_sha"]
        P = lvl.P_csr.tocsr()
        P.sort_indices()
        assert (list(P.shape), P.nnz) == (w["P_shape"], w["P_nnz"])
        assert _sha(P.indptr.astype(np.int64), P.indices.astype(np.int64)) \
            == w["P_struct_sha"]
        np.testing.assert_allclose(float(P.sum()), w["P_data_sum"],
                                   rtol=1e-9)


# ---------------------------------------------------------------------------
# solves
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["gauss_seidel", "zebra"])
def solved(request):
    A = _matrix("poisson", 64)
    b = A @ np.random.default_rng(0).random(A.shape[0])
    kw = {} if request.param == "gauss_seidel" else dict(
        presmoother="zebra", postsmoother="zebra")
    ours = pyamg_tpu_torch.ruge_stuben_solver(A, max_coarse=50,
                                              device="cpu", **kw)
    ref = _jax(pyamg_tpu.ruge_stuben_solver, _copy(A), max_coarse=50, **kw)
    return request.param, A, b, ours, ref


def test_solve_residual_history_equals_jax(solved):
    _, A, b, ours, ref = solved
    res, jres = [], []
    x = ours.solve(b, tol=1e-10, residuals=res)
    ref.solve(b, tol=1e-10, residuals=jres)
    assert len(res) == len(jres)
    # equal to round-off: the last residuals sit near eps * |b|
    np.testing.assert_allclose(res, jres, rtol=1e-8, atol=1e-14 * jres[0])
    assert np.linalg.norm(b - A @ x.numpy()) <= 1e-10 * np.linalg.norm(b)


def test_solve_mp_inner_iterations_equal_jax(solved):
    smoother, A, b, ours, ref = solved
    x, info = ours.solve_mp(b, tol=1e-10, return_info=True)
    _, jinfo = ref.solve_mp(b, tol=1e-10, return_info=True)
    assert info["inner_iterations"] == jinfo["inner_iterations"]
    # the reference's counts on classical Poisson: zebra 7, color GS 8
    assert info["inner_iterations"] == {"gauss_seidel": 8, "zebra": 7}[
        smoother]
    assert np.linalg.norm(b - A @ x.numpy()) <= 1e-10 * np.linalg.norm(b)


def test_hierarchy_exported_from_jax_solves_like_jax(solved):
    """A JAX ruge_stuben_solver hierarchy exported as numpy arrays (device
    A, host P and R with the splitting, smoother arrays): the port builds
    the same transfers and solves with JAX's residual history."""
    _, A, b, _ours, ref = solved

    def sm_dict(sm):
        out = {"kind": sm.kind, "sweep": sm.sweep, "iterations":
               sm.iterations, "omega": sm.omega, "grid": sm.grid or None,
               "line_axis": sm.line_axis}
        for name in ARRAYS + ("line_tri",):
            a = getattr(sm, name)
            out[name] = None if a is None else np.asarray(a)
        return out

    levels = []
    for lvl in ref.levels:
        op = lvl.A
        spec = {"A": {"diags": np.asarray(op.diags),
                      "offsets": tuple(op.offsets), "shape": op.shape}}
        if hasattr(lvl, "P_csr"):
            spec |= {"splitting": lvl.splitting, "P_csr": lvl.P_csr,
                     "R_csr": lvl.R_csr,
                     "presmoother": sm_dict(lvl.presmoother),
                     "postsmoother": sm_dict(lvl.postsmoother)}
        levels.append(spec)
    loaded = hierarchy_from_numpy(levels, np.asarray(ref._dev()["coarse"][0]),
                                  "cpu", torch.float64)
    for lo, lr in zip(loaded.levels, ref.levels):
        assert type(getattr(lo, "P", None)).__name__ == \
            type(getattr(lr, "P", None)).__name__
    res, jres = [], []
    loaded.solve(b, tol=1e-10, residuals=res)
    ref.solve(b, tol=1e-10, residuals=jres)
    assert len(res) == len(jres)
    # equal to round-off: the last residuals sit near eps * |b|
    np.testing.assert_allclose(res, jres, rtol=1e-8, atol=1e-14 * jres[0])


# ---------------------------------------------------------------------------
# line smoothers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sweep", ["forward", "backward", "symmetric"])
@pytest.mark.parametrize("name", ["poisson", "aniso"])
def test_zebra_device_host_and_jax_agree(name, sweep):
    A = _matrix(name, 40)
    kw = {"sweep": sweep, "iterations": 2}
    ours = pyamg_tpu_torch.ruge_stuben_solver(
        A, presmoother=("zebra", kw), max_coarse=40, device="cpu")
    ref = _jax(pyamg_tpu.ruge_stuben_solver, _copy(A),
               presmoother=("zebra", kw), max_coarse=40)
    sm, jsm = ours.levels[0].presmoother, ref.levels[0].presmoother
    _assert_same_smoother(sm, jsm)
    rng = np.random.default_rng(1)
    x0, b = rng.standard_normal((2, A.shape[0]))
    y = apply_smoother(sm, ours.levels[0].A, torch.from_numpy(x0),
                       torch.from_numpy(b)).numpy()
    yj = np.asarray(jax_device.apply_smoother(jsm, ref.levels[0].A,
                                              jnp.asarray(x0),
                                              jnp.asarray(b)))
    np.testing.assert_allclose(y, yj, rtol=1e-10, atol=1e-10)
    # the host form's "symmetric" is its forward sweep, as in the JAX
    # package; the device's runs forward then backward
    xh = x0.copy()
    for _ in range(2):
        for direction in ({"symmetric": ("forward", "backward")}.get(
                sweep, (sweep,))):
            relaxation.zebra(A, xh, b, sweep=direction)
    np.testing.assert_allclose(y, xh, rtol=1e-10, atol=1e-10)
    xh = x0.copy()
    relaxation.zebra(A, xh, b, iterations=2, sweep=sweep)
    xj = x0.copy()
    jax_relax.zebra(_copy(A), xj, b, iterations=2, sweep=sweep)
    np.testing.assert_allclose(xh, xj, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", ["poisson", "aniso"])
def test_line_jacobi_device_host_and_jax_agree(name):
    A = _matrix(name, 40)
    ours = pyamg_tpu_torch.ruge_stuben_solver(
        A, presmoother="line_jacobi", max_coarse=40, device="cpu")
    sm = ours.levels[0].presmoother
    assert (sm.kind, sm.omega) == ("line_jacobi", 0.7)
    rng = np.random.default_rng(2)
    x0, b = rng.standard_normal((2, A.shape[0]))
    y = line_relaxation_step(ours.levels[0].A, sm, torch.from_numpy(x0),
                             torch.from_numpy(b)).numpy()
    xh = x0.copy()
    relaxation.line_jacobi(A, xh, b)
    np.testing.assert_allclose(y, xh, rtol=1e-10, atol=1e-10)
    xj = x0.copy()
    jax_relax.line_jacobi(_copy(A), xj, b)
    np.testing.assert_allclose(xh, xj, rtol=1e-12, atol=1e-12)
    xc = x0.copy()
    relaxation.line_gauss_seidel(A, xc, b)
    xz = x0.copy()
    relaxation.zebra(A, xz, b)
    np.testing.assert_array_equal(xc, xz)


def test_line_smoothers_fall_back_without_a_grid():
    """A level without its grid (every coarse level of classical AMG, or a
    matrix without ``A.grid``): multicolor Gauss-Seidel on the device;
    symmetric Gauss-Seidel and weighted Jacobi on the host.  The Python
    Thomas solves equal the compiled ones."""
    A = _matrix("poisson", 40)
    ml = pyamg_tpu_torch.ruge_stuben_solver(
        A, presmoother="zebra", postsmoother="line_jacobi", max_coarse=40,
        device="cpu")
    ref = _jax(pyamg_tpu.ruge_stuben_solver, _copy(A), presmoother="zebra",
               postsmoother="line_jacobi", max_coarse=40)
    for lvl, jlvl in zip(ml.levels[1:-1], ref.levels[1:-1]):
        assert lvl.presmoother.kind == "gauss_seidel"
        assert lvl.postsmoother.kind == "gauss_seidel"
        _assert_same_smoother(lvl.presmoother, jlvl.presmoother)
    plain = sp.csr_matrix(A.tocoo())
    rng = np.random.default_rng(3)
    x0, b = rng.standard_normal((2, A.shape[0]))
    for fn, ref_fn, kw in (
            (relaxation.zebra, relaxation.gauss_seidel,
             dict(sweep="symmetric")),
            (relaxation.line_jacobi, relaxation.jacobi, dict(omega=0.7))):
        x1, x2 = x0.copy(), x0.copy()
        fn(plain, x1, b)
        ref_fn(plain, x2, b, **kw)
        np.testing.assert_allclose(x1, x2, rtol=1e-12, atol=1e-14)
    x1, x2, x3 = x0.copy(), x0.copy(), x0.copy()
    relaxation.zebra(A, x1, b, sweep="symmetric")
    jax_relax.zebra(_copy(A), x2, b, sweep="symmetric")
    np.testing.assert_allclose(x1, x2, rtol=1e-12, atol=1e-12)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(amg_core, "_lib", False)     # the Python Thomas solves
        relaxation.zebra(A, x3, b, sweep="symmetric")
    np.testing.assert_allclose(x3, x1, rtol=1e-12, atol=1e-12)


def test_pcr_solves_the_lines_and_node_blocked_lines_raise():
    rng = np.random.default_rng(4)
    dl, du = -rng.random((2, 9, 13))
    d = 2.5 + rng.random((9, 13))
    dl[:, 0] = du[:, -1] = 0
    B = rng.standard_normal((9, 13))
    x = batched_tridiag_pcr(*(torch.from_numpy(a) for a in (dl, d, du, B)))
    xj = jax_device.batched_tridiag_pcr(*(jnp.asarray(a)
                                          for a in (dl, d, du, B)))
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-12)
    R = B.copy()
    assert amg_core.thomas_lines_native(dl, d, du, R)
    np.testing.assert_allclose(x.numpy(), R, rtol=1e-10, atol=1e-12)

    import pyamg_tpu.relaxation.smoothing as jax_smoothing
    from pyamg_tpu.multilevel import Level as JaxLevel
    from pyamg_tpu_torch.multilevel import Level
    from pyamg_tpu_torch.relaxation import make_smoother_data

    # a node-blocked grid level raised here until the smoother-menu slice
    # ported the block-tridiagonal lines: it now takes the JAX package's
    # (3, q, q, nlines, L) line blocks (test_torch_smoothers.py holds
    # their solves)
    A = _matrix("poisson", 6)
    A2 = sp.kron(A, np.eye(2)).tocsr()
    lvl = Level(A_csr=A2, grid=(6, 6), blocksize=2)
    sm = make_smoother_data(lvl, "zebra", {}, device="cpu")
    ref = jax_smoothing.make_smoother_data(
        JaxLevel(A_csr=A2.copy(), grid=(6, 6), blocksize=2), "zebra", {})
    assert tuple(sm.line_tri.shape) == (3, 2, 2, 6, 6)
    np.testing.assert_array_equal(sm.line_tri.numpy(),
                                  np.asarray(ref.line_tri))


# ---------------------------------------------------------------------------
# the device setup
# ---------------------------------------------------------------------------

SHARDED = {"direct": {}, "standard": dict(interpolation="standard"),
           "evolution": dict(strength=EVOLUTION, interpolation="standard"),
           "PMIS": dict(CF="PMIS"),
           "jacobi": dict(smoother=("jacobi", {"omega": 0.7}))}


@pytest.mark.parametrize("call", list(SHARDED))
def test_classical_setup_sharded_matches_jax(call):
    from pyamg_tpu.parallel import classical_setup_sharded as jax_setup
    from pyamg_tpu.parallel import make_mesh

    A = _matrix("aniso", 40)
    b = A @ np.random.default_rng(0).random(A.shape[0])
    kw = dict(SHARDED[call], max_coarse=40)
    ours = classical_setup_sharded(A, device="cpu", **kw)
    ref = _jax(jax_setup, _copy(A), mesh=make_mesh(1), spgemm="xla", **kw)
    assert len(ours.levels) == len(ref.levels) > 2
    for lo, lr in zip(ours.levels, ref.levels):
        _same(lo.A_csr, lr.A_csr, 1e-6)
        if hasattr(lr, "splitting"):
            np.testing.assert_array_equal(lo.splitting, lr.splitting)
            _same(lo.P.to_scipy(), lr.P.to_scipy(), 1e-6)
            _same(lo.R.to_scipy(), lr.R.to_scipy(), 1e-6)
    res, jres = [], []
    x = ours.solve(b, tol=1e-6, maxiter=60, accel="cg", residuals=res)
    ref.solve(b, tol=1e-6, maxiter=60, accel="cg", residuals=jres)
    assert len(res) == len(jres)
    r = np.linalg.norm(b - A @ x.double().numpy()) / np.linalg.norm(b)
    assert r <= 1e-5


def test_classical_setup_sharded_float64_equals_the_host_build():
    """In float64 the device setup gives the host hierarchy of the same
    operator: rows, nnz, splittings, values to 1e-12 (the comparison of
    the JAX package's ``tests/test_parallel.py``)."""
    A = _matrix("aniso", 48)
    kw = dict(strength=EVOLUTION, interpolation="standard", max_coarse=50)
    sol = classical_setup_sharded(A, dtype=np.float64, device="cpu", **kw)
    host = pyamg_tpu_torch.ruge_stuben_solver(A, device="cpu", **kw)
    assert len(sol.levels) == len(host.levels) > 2
    for ls, lh in zip(sol.levels, host.levels):
        _same(ls.A_csr, lh.A_csr, 1e-12)
        if hasattr(lh, "splitting"):
            np.testing.assert_array_equal(ls.splitting, lh.splitting)
            _same(ls.P.to_scipy(), lh.P_csr, 1e-12)


def test_classical_setup_sharded_routes_and_refusals(monkeypatch):
    """``spgemm="auto"`` sends every masked product through the module's
    ``masked_spgemm_auto`` (the kernels' router) and ``"xla"`` through
    the plain form, with the same levels; the setup's levels equal the
    host hierarchy's."""
    import pyamg_tpu_torch.parallel.classical_setup as cs

    A = _matrix("aniso", 32)
    calls = []
    real = cs.masked_spgemm_auto

    def counted(*operands):
        calls.append(operands[2].shape)
        return real(*operands)

    monkeypatch.setattr(cs, "masked_spgemm_auto", counted)
    kw = dict(strength=EVOLUTION, interpolation="standard", max_coarse=40)
    auto = cs.classical_setup_sharded(A, device="cpu", **kw)
    n_auto = len(calls)
    xla = cs.classical_setup_sharded(A, device="cpu", spgemm="xla", **kw)
    # per level: one evolution squaring, the two standard-interpolation
    # products and A*P, R*AP
    assert n_auto == 5 * (len(auto.levels) - 1) and len(calls) == n_auto
    host = pyamg_tpu_torch.ruge_stuben_solver(A.astype(np.float32),
                                              device="cpu", **kw)
    for la, lx, lh in zip(auto.levels, xla.levels, host.levels):
        _same(la.A_csr, lx.A_csr, 0.0)
        assert la.A_csr.shape == lh.A_csr.shape
        assert la.A_csr.nnz == lh.A_csr.nnz
        if hasattr(lh, "splitting"):
            np.testing.assert_array_equal(la.splitting, lh.splitting)
    for bad in (dict(n_devices=2), dict(mesh=object())):
        with pytest.raises(NotImplementedError, match="distributed path"):
            cs.classical_setup_sharded(A, device="cpu", **bad)
    for bad in (dict(interpolation="x"), dict(smoother="sor"),
                dict(CF="CR"), dict(strength="distance"),
                dict(spgemm="pallas")):
        with pytest.raises(ValueError):
            cs.classical_setup_sharded(A, device="cpu", **bad)
