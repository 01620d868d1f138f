"""The nonsymmetric SA chain: the port against the JAX package.

The same numpy inputs, made from a seed, go through ``pyamg_tpu`` and the
port, on the CPU, in float64 unless stated:

* the host normal-equation relaxations ``jacobi_ne``, ``gauss_seidel_ne``
  (Kaczmarz) and ``gauss_seidel_nr``, each sweep, real and complex, to
  1e-12; the compiled Kaczmarz sweep against its Python form;
* the device smoothers ``jacobi_ne``, ``gauss_seidel_ne``,
  ``gauss_seidel_nr``, ``cgnr``, ``cgne``, ``cg`` and ``gmres`` on a
  recirculating-flow level: their state (omega, the inverted norms, A^H)
  and one application, to 1e-12 in float64 and 1e-5 in float32;
* energy prolongation smoothing by CGNR and GMRES: the same pattern, the
  values to 1e-12;
* the explicit-R embedded transfers;
* ``smoothed_aggregation_solver(symmetry="nonsymmetric")`` and
  ``rootnode_solver(symmetry="nonsymmetric")`` level by level (A, P, R, B
  and BH to 1e-10, the device forms), their GMRES iteration counts and
  residual histories; a BSR case, whose Galerkin product takes the level's
  own R;
* the black box on nonsymmetric matrices, and the normal-equation
  accelerators on a nonsymmetric hierarchy.

Every reference is built with the JAX package's ``have_native`` patched to
True.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pyamg_tpu
import pyamg_tpu.amg_core as jax_core
import pyamg_tpu.relaxation.relaxation as jrel
import pyamg_tpu.relaxation.smoothing as jsmoothing
from pyamg_tpu.aggregation import smooth as jax_smooth
from pyamg_tpu.multilevel import Level as JaxLevel
from pyamg_tpu.relaxation.device import apply_smoother as jax_apply
from pyamg_tpu.sparse import device_operator as jax_device_operator
from pyamg_tpu.sparse.embed import embedded_dia_transfers as jax_embed
import pyamg_tpu_torch
import pyamg_tpu_torch.amg_core as amg_core
import pyamg_tpu_torch.relaxation.relaxation as rel
import pyamg_tpu_torch.relaxation.smoothing as smoothing
from pyamg_tpu_torch.aggregation import smooth
from pyamg_tpu_torch.aggregation.aggregate import standard_aggregation
from pyamg_tpu_torch.aggregation.tentative import fit_candidates
from pyamg_tpu_torch.gallery import linear_elasticity, load_example, poisson
from pyamg_tpu_torch.multilevel import Level
from pyamg_tpu_torch.relaxation.device import apply_smoother
from pyamg_tpu_torch.sparse import (CptProlongOp, CptRestrictOp,
                                    device_operator)
from pyamg_tpu_torch.sparse.embed import embedded_dia_transfers
from pyamg_tpu_torch.strength import (evolution_strength_of_connection,
                                      symmetric_strength_of_connection)

torch.set_num_threads(1)


def _jax(fn, *args, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_core, "have_native", lambda: True)
        return fn(*args, **kw)


def _close(A, B, tol=1e-10):
    A, B = sp.csr_matrix(A), sp.csr_matrix(B)
    assert A.shape == B.shape
    d = abs(A - B)
    assert (d.max() if d.nnz else 0.0) <= tol * max(abs(B).max(), 1e-300)


def recirc():
    """``recirc_flow``: upwinded -0.01 Laplacian + b.grad with the rotating
    wind b = (y - 1/2, 1/2 - x), 40^2."""
    return load_example("recirc_flow")["A"].tocsr()


def perturbed_poisson(n=24, seed=5):
    """The 2-D Poisson matrix plus a random diagonal, the JAX package's
    explicit-R case: symmetric, but set up as nonsymmetric, so that R is
    smoothed on A^H on its own path."""
    A = sp.csr_matrix(poisson((n, n), format="csr"))
    return (A + sp.diags(0.05 * np.random.default_rng(seed)
                         .standard_normal(A.shape[0]))).tocsr()


def convection(n=16, c=0.1):
    """Poisson plus a skew first-difference term (test_krylov's case)."""
    A = poisson((n, n), format="csr")
    N = A.shape[0]
    conv = sp.diags([np.ones(N - 1), -np.ones(N - 1)], [1, -1],
                    format="csr") * c
    return sp.csr_matrix(A + conv)


def blocked_nonsymmetric(n=12, seed=2):
    """2-D elasticity (BSR 2x2) with a skew perturbation of its node
    couplings, and its three rigid-body modes."""
    A, B = linear_elasticity((n, n))
    rng = np.random.default_rng(seed)
    S = sp.random(A.shape[0], A.shape[0], density=0.002, random_state=rng,
                  format="csr")
    A = (A.tocsr() + 0.05 * abs(A).max() * (S - S.T)).tobsr(blocksize=(2, 2))
    A.sort_indices()
    return A, B


def _xb(n, seed=3, complex_=False):
    rng = np.random.default_rng(seed)
    x, b = rng.standard_normal(n), rng.standard_normal(n)
    if complex_:
        x = x + 1j * rng.standard_normal(n)
        b = b + 1j * rng.standard_normal(n)
    return x, b


# ---------------------------------------------------------------------------
# host relaxations
# ---------------------------------------------------------------------------

HOST = [("jacobi_ne", dict(omega=0.8, iterations=2))] + [
    (name, dict(sweep=sweep, iterations=2, omega=0.9))
    for name in ("gauss_seidel_ne", "gauss_seidel_nr")
    for sweep in ("forward", "backward", "symmetric")]


def _complexify(A, seed=7):
    B = A.copy().astype(complex)
    B.data = B.data * (1 + 0.3j * np.random.default_rng(seed)
                       .standard_normal(B.nnz))
    return B


@pytest.mark.parametrize("kind", ["real", "complex"])
@pytest.mark.parametrize("name,kw", HOST,
                         ids=[f"{n}-{kw.get('sweep', 'all')}"
                              for n, kw in HOST])
def test_host_normal_equation_relaxation_matches_jax(name, kw, kind):
    A = recirc()
    if kind == "complex":
        A = _complexify(A)
    x0, b = _xb(A.shape[0], complex_=kind == "complex")
    x, xj = x0.copy(), x0.copy()
    out = getattr(rel, name)(A, x, b, **kw)
    _jax(getattr(jrel, name), A.copy(), xj, b, **kw)
    assert out is x                                   # in place
    r0 = np.linalg.norm(b - A @ x0)
    assert np.linalg.norm(b - A @ x) < r0
    np.testing.assert_allclose(x, xj, rtol=1e-12,
                               atol=1e-12 * np.abs(xj).max())


def test_host_normal_equation_relaxations_are_public():
    assert pyamg_tpu_torch.relaxation.jacobi_ne is rel.jacobi_ne
    assert pyamg_tpu_torch.relaxation.gauss_seidel_ne is rel.gauss_seidel_ne
    assert pyamg_tpu_torch.relaxation.gauss_seidel_nr is rel.gauss_seidel_nr
    with pytest.raises(ValueError, match="sweep"):
        rel.gauss_seidel_nr(recirc(), np.zeros(1600), np.ones(1600),
                            sweep="sideways")


@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
def test_kaczmarz_binding_matches_its_python_form(index_dtype, monkeypatch):
    A = recirc()
    A.indptr = A.indptr.astype(index_dtype)
    A.indices = A.indices.astype(index_dtype)
    x0, b = _xb(A.shape[0])
    x = x0.copy()
    assert amg_core.gauss_seidel_kaczmarz_native(A, x, b, 0.7)
    xj = x0.copy()
    assert jax_core.gauss_seidel_kaczmarz_native(A, xj, b, 0.7) \
        or not jax_core.have_native()
    if jax_core.have_native():
        np.testing.assert_array_equal(x, xj)
    # the Python form: the same sweep with the library off
    monkeypatch.setattr(amg_core, "_lib", False)
    xp = x0.copy()
    assert not amg_core.gauss_seidel_kaczmarz_native(A, xp, b, 0.7)
    rel.gauss_seidel_ne(A, xp, b, omega=0.7)
    np.testing.assert_allclose(x, xp, rtol=1e-12, atol=1e-12)
    monkeypatch.setattr(amg_core, "_lib", None)
    xs = x0.copy()
    rel.gauss_seidel_ne(A, xs, b, omega=0.7)
    np.testing.assert_array_equal(xs, x)
    # a complex or float32 input is not the library's: the Python form
    assert not amg_core.gauss_seidel_kaczmarz_native(
        A, x0.astype(np.float32), b, 0.7)


# ---------------------------------------------------------------------------
# device smoothers
# ---------------------------------------------------------------------------

DEVICE = ["jacobi_ne", "gauss_seidel_ne", "gauss_seidel_nr", "cgnr", "cgne",
          "cg", "gmres"]


def _recirc_levels():
    """Level 1 of the recirc-flow hierarchy (280 rows, banded, not
    symmetric), as a level of each package."""
    A = pyamg_tpu_torch.smoothed_aggregation_solver(
        recirc(), symmetry="nonsymmetric", max_coarse=20,
        finalize_device=False, device="cpu").levels[1].A_csr
    ours = Level(A_csr=A.copy(), grid=None, blocksize=1, _sym_hint=False)
    ref = JaxLevel(A_csr=A.copy(), grid=None, blocksize=1, _sym_hint=False)
    ours.A = device_operator(A, device="cpu")
    ref.A = jax_device_operator(A)
    return ours, ref


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", DEVICE)
def test_device_smoother_matches_jax(name, dtype):
    ours, ref = _recirc_levels()
    kw = {"iterations": 2} if name in ("jacobi_ne", "gmres") else {}
    tdt, jdt = (torch.float64, None) if dtype == "float64" \
        else (torch.float32, jnp.float32)
    if dtype == "float32":
        ours.A, ref.A = ours.A.astype(tdt), ref.A.astype(jdt)
    sm = smoothing.make_smoother_data(ours, name, kw, dtype=tdt,
                                      device="cpu")
    jsm = _jax(jsmoothing.make_smoother_data, ref, name, kw, dtype=jdt)
    assert (sm.kind, sm.iterations) == (jsm.kind, jsm.iterations)
    np.testing.assert_allclose(sm.omega, jsm.omega, rtol=1e-12)
    assert (sm.AT is None) == (jsm.AT is None)
    if sm.AT is not None:
        # A^H on the port's device operator (DIA here), equal to the JAX
        # package's padded ELL
        assert type(sm.AT).__name__ == "SparseDIA"
        assert sm.AT.dtype == tdt
        np.testing.assert_allclose(sm.AT.to_scipy().toarray(),
                                   jsm.AT.to_scipy().toarray(), rtol=1e-6)
        np.testing.assert_array_equal(
            sm.AT.astype(torch.float64).to_scipy().toarray() != 0,
            ours.A_csr.T.toarray() != 0)
    if jsm.dinv_ne is not None:
        assert sm.dinv_ne.dtype == tdt
        np.testing.assert_allclose(sm.dinv_ne.numpy(),
                                   np.asarray(jsm.dinv_ne),
                                   rtol=1e-12 if dtype == "float64" else 0)
    else:
        assert sm.dinv_ne is None
    x0, b = (v.astype(dtype) for v in _xb(ours.A_csr.shape[0]))
    y = apply_smoother(sm, ours.A, torch.from_numpy(x0), torch.from_numpy(b))
    yj = np.asarray(jax_apply(jsm, ref.A, jnp.asarray(x0), jnp.asarray(b)))
    assert y.dtype == tdt
    tol = 1e-12 if dtype == "float64" else 1e-5
    assert np.abs(y.numpy() - yj).max() <= tol * np.abs(yj).max()
    A = ours.A_csr
    assert np.linalg.norm(b - A @ y.numpy()) < np.linalg.norm(b - A @ x0)
    # a cast of the state keeps A^H in the same dtype as the rest
    sm32 = sm.astype(torch.float32)
    if sm.AT is not None:
        assert sm32.AT.dtype == torch.float32
    if sm.dinv_ne is not None:
        assert sm32.dinv_ne.dtype == torch.float32


def test_device_smoothers_on_a_complex_level_match_jax():
    A = _complexify(recirc())
    ours = Level(A_csr=A.copy(), grid=None, blocksize=1, _sym_hint=False)
    ref = JaxLevel(A_csr=A.copy(), grid=None, blocksize=1, _sym_hint=False)
    ours.A = device_operator(A, device="cpu")
    ref.A = jax_device_operator(A)
    x0, b = _xb(A.shape[0], complex_=True)
    for name in DEVICE:
        sm = smoothing.make_smoother_data(ours, name, {}, device="cpu")
        jsm = _jax(jsmoothing.make_smoother_data, ref, name, {})
        y = apply_smoother(sm, ours.A, torch.from_numpy(x0),
                           torch.from_numpy(b))
        yj = np.asarray(jax_apply(jsm, ref.A, jnp.asarray(x0),
                                  jnp.asarray(b)))
        assert np.abs(y.numpy() - yj).max() <= 1e-12 * np.abs(yj).max(), \
            name


# ---------------------------------------------------------------------------
# energy prolongation smoothing by CGNR and GMRES
# ---------------------------------------------------------------------------

def _energy_pieces(case):
    if case == "elasticity":
        A, B = linear_elasticity((12, 10))
        A = A.tocsr()
        C = symmetric_strength_of_connection(A.tobsr(blocksize=(2, 2)),
                                             theta=0.0)
        AggOp, _ = standard_aggregation(C)   # C: the node graph
    else:
        A = recirc()
        B = np.ones((A.shape[0], 1))
        C = evolution_strength_of_connection(A, B)
        AggOp, _ = standard_aggregation(C)
    T, Bc = fit_candidates(AggOp, B)
    return A, C, sp.csr_matrix(T), Bc, B


@pytest.mark.parametrize("weighting", ["local", "diagonal", "block"])
@pytest.mark.parametrize("krylov", ["cgnr", "gmres"])
@pytest.mark.parametrize("case", ["elasticity", "recirc"])
def test_energy_cgnr_and_gmres_match_jax(case, krylov, weighting):
    A, C, T, Bc, B = _energy_pieces(case)
    kw = dict(krylov=krylov, maxiter=3, weighting=weighting)
    P = smooth.energy_prolongation_smoother(A.copy(), T, C, Bc, **kw)
    J = _jax(jax_smooth.energy_prolongation_smoother, A.copy(), T, C, Bc,
             **kw)
    assert P.nnz == J.nnz
    np.testing.assert_array_equal(P.indptr, J.indptr)
    _close(P, J, 1e-12)
    assert abs(P - T).max() > 1e-3               # the smoothing did work
    if case == "recirc":
        # the constraint holds (with the three rigid-body modes a row of
        # few pattern entries cannot keep it, in both packages)
        np.testing.assert_allclose(P @ Bc, T @ Bc,
                                   atol=1e-9 * abs(T @ Bc).max())
    if krylov == "cgnr":
        # CGNR lowers ||A P|| from T's
        assert sp.linalg.norm(A @ P) < sp.linalg.norm(A @ T)


def test_energy_gmres_root_node_form_matches_jax():
    from pyamg_tpu_torch.util.utils import get_Cpt_params, scale_T

    A, C, T, Bc, B = _energy_pieces("recirc")
    AggOp, Cnodes = standard_aggregation(C)
    params = get_Cpt_params(A, Cnodes, AggOp, T)
    T = scale_T(T, params["P_I"], params["I_F"])
    Bc = np.asarray(params["P_I"].T @ B)
    for krylov in ("gmres", "cgnr"):
        P = smooth.energy_prolongation_smoother(
            A.copy(), T, C, Bc, B, (True, params), krylov=krylov)
        J = _jax(jax_smooth.energy_prolongation_smoother, A.copy(), T, C,
                 Bc, B, (True, params), krylov=krylov)
        assert P.nnz == J.nnz
        _close(P, J, 1e-12)
        np.testing.assert_allclose(P[params["Cpts"]].toarray(),
                                   np.eye(P.shape[1]), atol=1e-13)


# ---------------------------------------------------------------------------
# explicit-R embedded transfers
# ---------------------------------------------------------------------------

def _check_transfers(P, R, P_csr, R_csr, tol=1e-11, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(P_csr.shape[1])
    r = rng.standard_normal(R_csr.shape[1])
    assert np.abs(P.matvec(torch.from_numpy(x)).numpy()
                  - P_csr @ x).max() < tol
    assert np.abs(R.matvec(torch.from_numpy(r)).numpy()
                  - R_csr @ r).max() < tol


def test_explicit_restriction_embeds_r_at_the_roots():
    """tests/test_aggregation.py::test_sa_nonsymmetric_explicit_R_embed at
    24^2: each level's P and its independent R, embedded at the aggregate
    roots, apply as P_csr and R_csr."""
    A = perturbed_poisson(24)
    ml = pyamg_tpu_torch.smoothed_aggregation_solver(
        A, symmetry="nonsymmetric", smooth="jacobi", device="cpu")
    assert len(ml.levels) > 1
    for lvl in ml.levels[:-1]:
        _check_transfers(lvl.P, lvl.R, lvl.P_csr, lvl.R_csr)
        emb = embedded_dia_transfers(lvl.P_csr, lvl.root_dofs,
                                     max_offsets=1024, restrict="explicit",
                                     R_csr=lvl.R_csr, device="cpu")
        assert isinstance(emb[0], CptProlongOp)
        assert isinstance(emb[1], CptRestrictOp)
        _check_transfers(*emb, lvl.P_csr, lvl.R_csr)
        ref = jax_embed(lvl.P_csr, lvl.root_dofs, max_offsets=1024,
                        restrict="explicit", R_csr=lvl.R_csr)
        np.testing.assert_array_equal(emb[1].dia.offsets,
                                      ref[1].dia.offsets)
        np.testing.assert_allclose(emb[1].dia.diags.numpy(),
                                   np.asarray(ref[1].dia.diags), rtol=1e-14)
        # the cap declines: no embedding; nor without R
        assert embedded_dia_transfers(
            lvl.P_csr, lvl.root_dofs, max_offsets=2, restrict="explicit",
            R_csr=lvl.R_csr, device="cpu") is None
        assert embedded_dia_transfers(lvl.P_csr, lvl.root_dofs,
                                      restrict="explicit",
                                      device="cpu") is None
    with pytest.raises(ValueError, match="restrict"):
        embedded_dia_transfers(ml.levels[0].P_csr, ml.levels[0].root_dofs,
                               restrict="adjoint", device="cpu")


def test_a_large_nonsymmetric_level_embeds_its_transfers():
    """Above the dense limit the level-0 transfers of a nonsymmetric
    hierarchy take the root-embedded DIA form, R its own rows."""
    A = perturbed_poisson(72, seed=1)
    ml = pyamg_tpu_torch.smoothed_aggregation_solver(
        A, symmetry="nonsymmetric", smooth="jacobi", max_coarse=300,
        device="cpu")
    ref = _jax(pyamg_tpu.smoothed_aggregation_solver, A.copy(),
               symmetry="nonsymmetric", smooth="jacobi", max_coarse=300)
    lvl = ml.levels[0]
    assert isinstance(lvl.P, CptProlongOp)
    assert isinstance(lvl.R, CptRestrictOp)
    assert type(ref.levels[0].R).__name__ == "CptRestrictOp"
    _check_transfers(lvl.P, lvl.R, lvl.P_csr, lvl.R_csr)
    np.testing.assert_array_equal(lvl.R.dia.offsets,
                                  ref.levels[0].R.dia.offsets)


# ---------------------------------------------------------------------------
# nonsymmetric SA and root-node SA, level by level
# ---------------------------------------------------------------------------

RECIRC_KW = dict(smooth=("energy", {"krylov": "gmres", "maxiter": 2}),
                 presmoother=("gauss_seidel_nr", {"sweep": "symmetric"}),
                 postsmoother=("gauss_seidel_nr", {"sweep": "symmetric"}),
                 max_coarse=20)

SA_CASES = {
    # tests/test_aggregation.py::test_nonsymmetric_mode
    "recirc-energy-gmres": (recirc, RECIRC_KW),
    "perturbed-jacobi": (perturbed_poisson, dict(smooth="jacobi")),
    "recirc-no-improve": (recirc, dict(RECIRC_KW, improve_candidates=None)),
    "recirc-improve-nr": (recirc, dict(
        RECIRC_KW, improve_candidates=(("gauss_seidel_nr",
                                        {"sweep": "symmetric",
                                         "iterations": 2}), None))),
    "recirc-energy-cgnr": (recirc, dict(
        RECIRC_KW, smooth=("energy", {"krylov": "cgnr", "maxiter": 2}),
        presmoother=("cgnr", {}), postsmoother=("gauss_seidel_ne", {}))),
    "convection-default": (convection, dict(max_coarse=20)),
}


def _compare_levels(ours, ref, root=False, min_levels=2):
    assert len(ours.levels) == len(ref.levels) >= min_levels
    for lo, lr in zip(ours.levels, ref.levels):
        _close(lo.A_csr, lr.A_csr)
        assert lo.A_csr.nnz == lr.A_csr.nnz
        np.testing.assert_allclose(lo.B, np.asarray(lr.B), rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_allclose(lo.BH, np.asarray(lr.BH), rtol=1e-10,
                                   atol=1e-12)
        assert lo.symmetry == lr.symmetry == "nonsymmetric"
        assert type(lo.A).__name__ == type(lr.A).__name__
        if not hasattr(lr, "P_csr"):
            continue
        _close(lo.P_csr, lr.P_csr)
        _close(lo.R_csr, lr.R_csr)
        assert lo.P_csr.nnz == lr.P_csr.nnz and lo.R_csr.nnz == lr.R_csr.nnz
        assert type(lo.P).__name__ == type(lr.P).__name__
        assert type(lo.R).__name__ == type(lr.R).__name__
        if root:
            np.testing.assert_array_equal(lo.root_dofs, lr.root_dofs)
        pre, jpre = lo.presmoother, lr.presmoother
        assert pre.kind == jpre.kind
        np.testing.assert_allclose(pre.omega, jpre.omega, rtol=1e-10)


def _compare_solves(ours, ref, A, accel="gmres"):
    """Equal iteration counts and residual histories, and the same x.
    (Left-preconditioned GMRES tracks ||M r||, so the true residual is not
    held to the tolerance, in either package.)"""
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    r1, r2 = [], []
    x = ours.solve(b, tol=1e-8, maxiter=100, accel=accel, residuals=r1)
    xj = ref.solve(b, tol=1e-8, maxiter=100, accel=accel, residuals=r2)
    assert len(r1) == len(r2) < 100
    np.testing.assert_allclose(r1, r2, rtol=1e-6, atol=1e-10 * r1[0])
    assert r1[-1] <= 1e-8 * r1[0]
    xj = np.asarray(xj)
    assert np.abs(x.numpy() - xj).max() <= 1e-6 * np.abs(xj).max()


@pytest.fixture(scope="module", params=sorted(SA_CASES))
def sa_built(request):
    make, kw = SA_CASES[request.param]
    A = make()
    ours = pyamg_tpu_torch.smoothed_aggregation_solver(
        A, symmetry="nonsymmetric", device="cpu", **kw)
    ref = _jax(pyamg_tpu.smoothed_aggregation_solver, A.copy(),
               symmetry="nonsymmetric", **kw)
    return ours, ref, A


def test_nonsymmetric_sa_matches_jax_level_by_level(sa_built):
    ours, ref, _ = sa_built
    _compare_levels(ours, ref)


def test_nonsymmetric_sa_solve_takes_the_jax_iterations(sa_built):
    ours, ref, A = sa_built
    _compare_solves(ours, ref, A)


def test_nonsymmetric_sa_with_a_grid_takes_the_general_chain():
    """A nonsymmetric matrix with grid metadata does not take the
    structured path (its R is not P^H)."""
    A = poisson((20, 20), format="csr")
    A.data = A.data + 0.1 * np.random.default_rng(0).standard_normal(A.nnz)
    A.grid = (20, 20)
    ours = pyamg_tpu_torch.smoothed_aggregation_solver(
        A, symmetry="nonsymmetric", max_coarse=20, device="cpu")
    ref = _jax(pyamg_tpu.smoothed_aggregation_solver, A,
               symmetry="nonsymmetric", max_coarse=20)
    assert not hasattr(ours.levels[0], "struct_meta")
    _compare_levels(ours, ref)


def test_blocked_nonsymmetric_galerkin_takes_the_level_r():
    """On a BSR level with several candidates the Galerkin product runs in
    blocks; on a nonsymmetric level its restriction is the level's own R
    (R_csr in BSR blocks), not P^T."""
    A, B = blocked_nonsymmetric()
    kw = dict(B=B, max_coarse=20)
    ours = pyamg_tpu_torch.smoothed_aggregation_solver(
        A, symmetry="nonsymmetric", device="cpu", **kw)
    ref = _jax(pyamg_tpu.smoothed_aggregation_solver, A.copy(),
               symmetry="nonsymmetric", **kw)
    _compare_levels(ours, ref)
    lvl, coarse = ours.levels[0], ours.levels[1]
    assert lvl.blocksize == 2 and lvl.B.shape[1] == 3
    assert abs(lvl.R_csr - lvl.P_csr.T).max() > 1e-6
    assert coarse.A_bsr is not None and coarse.A_bsr.blocksize == (3, 3)
    _close(coarse.A_csr, lvl.R_csr @ A.tocsr() @ lvl.P_csr, 1e-12)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    res = []
    ours.solve(b, tol=1e-8, maxiter=100, accel="gmres", residuals=res)
    assert res[-1] <= 1e-8 * res[0] and len(res) < 20


ROOT_CASES = {
    "recirc-energy-gmres": (recirc, dict(
        smooth=("energy", {"krylov": "gmres"}), max_coarse=20)),
    "perturbed-default": (perturbed_poisson, dict(max_coarse=20)),
    "recirc-no-smoothing": (recirc, dict(smooth=None, max_coarse=20)),
}


@pytest.mark.parametrize("case", sorted(ROOT_CASES))
def test_nonsymmetric_rootnode_matches_jax(case):
    make, kw = ROOT_CASES[case]
    A = make()
    ours = pyamg_tpu_torch.rootnode_solver(A, symmetry="nonsymmetric",
                                           device="cpu", **kw)
    ref = _jax(pyamg_tpu.rootnode_solver, A.copy(), symmetry="nonsymmetric",
               **kw)
    _compare_levels(ours, ref, root=True)
    for lvl in ours.levels[:-1]:
        # the roots are identity rows of P and identity columns of R
        n_c = lvl.P_csr.shape[1]
        np.testing.assert_allclose(lvl.P_csr[lvl.root_dofs].toarray(),
                                   np.eye(n_c), atol=1e-13)
        np.testing.assert_allclose(lvl.R_csr[:, lvl.root_dofs].toarray(),
                                   np.eye(n_c), atol=1e-13)
    _compare_solves(ours, ref, A)


# ---------------------------------------------------------------------------
# the black box and the normal-equation accelerators
# ---------------------------------------------------------------------------

def _nonsymmetric(n=20):
    A = poisson((n, n), format="csr").tolil()
    for i in range(n * n - 1):
        A[i, i + 1] -= 0.5
    return A.tocsr()


@pytest.mark.parametrize("make", [_nonsymmetric, recirc],
                         ids=["upwinded", "recirc"])
def test_black_box_on_a_nonsymmetric_matrix_matches_jax(make):
    A = make()
    config = pyamg_tpu_torch.solver_configuration(A, verb=False)
    assert config["symmetry"] == "nonsymmetric"
    b = np.random.default_rng(1).standard_normal(A.shape[0])
    r1, r2 = [], []
    x, ml = pyamg_tpu_torch.solve(A, b, verb=False, residuals=r1,
                                  return_solver=True, device="cpu")
    xj, mj = _jax(pyamg_tpu.solve, A.copy(), b, verb=False, residuals=r2,
                  return_solver=True)
    # (the 400 rows of the upwinded matrix are below max_coarse: one level)
    _compare_levels(ml, mj, min_levels=1 if A.shape[0] <= 500 else 2)
    if len(ml.levels) > 1:
        assert ml.levels[0].presmoother.kind == "jacobi_nr"
    assert len(r1) == len(r2)
    np.testing.assert_allclose(r1, r2, rtol=1e-6, atol=1e-10 * r1[0])
    assert r1[-1] <= 1e-5 * r1[0]          # the tracked ||M r|| (GMRES)
    xj = np.asarray(xj)
    assert np.abs(x.numpy() - xj).max() <= 1e-6 * np.abs(xj).max()


@pytest.mark.parametrize("accel", ["cgnr", "cgne"])
def test_normal_equation_accels_on_a_nonsymmetric_hierarchy(accel):
    """tests/test_krylov.py::test_cgnr_cgne_accel_nonsymmetric_hierarchy:
    the normal-equation methods run with A^H from the host matrix, and
    reduce the residual (a cycle is a poor preconditioner for them, in
    both packages)."""
    A = convection()
    ml = pyamg_tpu_torch.smoothed_aggregation_solver(
        A, symmetry="nonsymmetric", device="cpu")
    ref = _jax(pyamg_tpu.smoothed_aggregation_solver, A.copy(),
               symmetry="nonsymmetric")
    b = np.random.default_rng(2).standard_normal(A.shape[0])
    r1, r2 = [], []
    x = ml.solve(b, tol=1e-3, accel=accel, maxiter=400, residuals=r1)
    xj = ref.solve(b, tol=1e-3, accel=accel, maxiter=400, residuals=r2)
    rr = np.linalg.norm(b - A @ x.numpy()) / np.linalg.norm(b)
    assert np.isfinite(rr) and rr < 1e-2
    rj = np.linalg.norm(b - A @ np.asarray(xj)) / np.linalg.norm(b)
    np.testing.assert_allclose(rr, rj, rtol=1e-6)
    assert ml._with_rmatvec(ml.levels[0].A).rmatvec is not None


def test_solve_mp_takes_a_hierarchy_whose_r_is_not_p_transposed():
    """float32 cycles in float64 GMRES, whose true residual is checked and
    its tracked tolerance tightened until it holds."""
    A = recirc()
    ml = pyamg_tpu_torch.smoothed_aggregation_solver(
        A, symmetry="nonsymmetric", op_dtype=torch.float32, device="cpu",
        **RECIRC_KW)
    assert abs(ml.levels[0].R_csr - ml.levels[0].P_csr.T).max() > 1e-6
    b = np.random.default_rng(4).standard_normal(A.shape[0])
    x, info = ml.solve_mp(b, tol=1e-10, accel="gmres", return_info=True)
    assert np.linalg.norm(b - A @ x.numpy()) <= 5e-10 * np.linalg.norm(b)
