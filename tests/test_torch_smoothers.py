"""The rest of the smoother menu: the port against the JAX package.

The same numpy inputs, made from a seed, go through ``pyamg_tpu`` and the
port, in float64 unless stated:

* ``mls_polynomial_coefficients``, to 1e-14 relative;
* overlapping Schwarz: ``schwarz_parameters`` (subdomains exactly, the
  pseudo-inverses to 1e-12), the host multiplicative sweeps (1e-12), the
  ``SmootherData`` fields (exactly), the device step (1e-12; float32
  1e-5), ``strength_based_schwarz`` equal to ``schwarz`` in both packages
  (the reference's strength matrix is never read), and a Schwarz SA
  hierarchy at 48^2 with the JAX package's CG iterations;
* the node-blocked line smoothers: the (3, q, q, nlines, L) line blocks
  exactly (q = 2 and 3, both axes, a zero dof row), the block-tridiagonal
  cyclic reduction against the JAX function (1e-12) and a dense solve,
  one line at a length that is not a power of 2, and the blocked zebra
  phases and line Jacobi step (1e-12);
* the two-candidate adaptive SA with full (3, 3) grid aggregation at 96^2
  (``benchmarks/reference_harness/our_k2.py``'s protocol; 96 is not a
  multiple of 3 on the coarse levels): level by level to 1e-10, and the
  JAX package's ``solve_mp`` inner iterations.

Every reference is built with the JAX package's ``have_native`` patched to
True; the Schwarz hierarchy is compared with the port's compiled library
on and off.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pyamg_tpu
import pyamg_tpu.amg_core as jax_core
import pyamg_tpu.relaxation.chebyshev as jcheb
import pyamg_tpu.relaxation.device as jdevice
import pyamg_tpu.relaxation.relaxation as jrel
import pyamg_tpu.relaxation.smoothing as jsmoothing
from pyamg_tpu.multilevel import Level as JaxLevel
from pyamg_tpu.sparse import device_operator as jax_device_operator
import pyamg_tpu_torch
from pyamg_tpu_torch import amg_core
from pyamg_tpu_torch.gallery import (diffusion_stencil_2d, linear_elasticity,
                                     poisson, stencil_grid)
from pyamg_tpu_torch.multilevel import Level
from pyamg_tpu_torch.relaxation import chebyshev, device, relaxation
from pyamg_tpu_torch.relaxation import smoothing
from pyamg_tpu_torch.sparse import device_operator

torch.set_num_threads(1)


def _jax(fn, *args, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_core, "have_native", lambda: True)
        return fn(*args, **kw)


def _nonsymmetric_with_empty_row():
    R = sp.random(30, 30, density=0.15, random_state=1, format="lil")
    R += 2.0 * sp.eye(30)
    R[7, :] = 0.0
    R = sp.csr_matrix(R)
    R.eliminate_zeros()
    return R


MATRICES = {
    "poisson-20": lambda: poisson((20, 20), format="csr"),
    "elasticity-12": lambda: linear_elasticity((12, 12))[0].tocsr(),
    "nonsymmetric-empty-row": _nonsymmetric_with_empty_row,
}


def _levels(A, grid=None, blocksize=1):
    """The same level for both packages: ``(ours, jax's)``."""
    ours = Level(A_csr=A.copy(), grid=grid, blocksize=blocksize,
                 _sym_hint=True)
    ref = JaxLevel(A_csr=A.copy(), grid=grid, blocksize=blocksize,
                   _sym_hint=True)
    ours.A = device_operator(A, device="cpu")
    ref.A = jax_device_operator(A)
    return ours, ref


def _xb(n, seed=3, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return rng.random(n).astype(dtype), rng.random(n).astype(dtype)


@pytest.mark.parametrize("rho,degree", [(1.0, 1), (2.0, 2), (4.3, 3),
                                        (7.9, 5)])
def test_mls_polynomial_coefficients_match_jax(rho, degree):
    ours = chebyshev.mls_polynomial_coefficients(rho, degree)
    ref = jcheb.mls_polynomial_coefficients(rho, degree)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, rtol=1e-14, atol=0)


# ---------------------------------------------------------------------------
# overlapping Schwarz
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("matrix", sorted(MATRICES))
def test_schwarz_parameters_match_jax(matrix):
    A = MATRICES[matrix]()
    ours = relaxation.schwarz_parameters(A)
    ref = jrel.schwarz_parameters(A)
    for name, a, b in zip(("subdomain", "subdomain_ptr"), ours, ref):
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(ours[3], ref[3])
    scale = np.abs(ref[2]).max()
    assert np.abs(ours[2] - ref[2]).max() <= 1e-12 * scale
    # a given subdomain set: every row with its two neighbours in turn
    n = A.shape[0]
    sub = np.stack([np.arange(n), (np.arange(n) + 1) % n,
                    (np.arange(n) + 5) % n], axis=1).ravel()
    ptr = np.arange(0, 3 * n + 1, 3)
    ours = relaxation.schwarz_parameters(A, sub, ptr)
    ref = jrel.schwarz_parameters(A, sub, ptr)
    np.testing.assert_array_equal(ours[3], ref[3])
    assert np.abs(ours[2] - ref[2]).max() <= 1e-12 * np.abs(ref[2]).max()


@pytest.mark.parametrize("matrix", sorted(MATRICES))
@pytest.mark.parametrize("sweep", ["forward", "backward", "symmetric"])
def test_host_schwarz_matches_jax(matrix, sweep):
    A = MATRICES[matrix]()
    x0, b = _xb(A.shape[0])
    ours, ref = x0.copy(), x0.copy()
    relaxation.schwarz(A, ours, b, iterations=2, sweep=sweep)
    jrel.schwarz(A, ref, b, iterations=2, sweep=sweep)
    np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=1e-12)
    assert not np.allclose(ours, x0)
    with pytest.raises(ValueError, match="sweep"):
        relaxation.schwarz(A, x0.copy(), b, sweep="sideways")


@pytest.mark.parametrize("matrix", sorted(MATRICES))
@pytest.mark.parametrize("name", ["schwarz", "strength_based_schwarz"])
def test_schwarz_smoother_data_and_step_match_jax(matrix, name):
    A = MATRICES[matrix]()
    lvl, ref = _levels(A)
    sm = smoothing.make_smoother_data(lvl, name, {"omega": 0.9},
                                      device="cpu")
    jsm = jsmoothing.make_smoother_data(ref, name, {"omega": 0.9})
    assert (sm.kind, sm.iterations, sm.omega) == \
        (jsm.kind, jsm.iterations, jsm.omega) == ("schwarz", 1, 0.9)
    np.testing.assert_array_equal(sm.subdomain_idx.numpy(),
                                  np.asarray(jsm.subdomain_idx))
    np.testing.assert_array_equal(sm.subdomain_inv.numpy(),
                                  np.asarray(jsm.subdomain_inv))
    # each dof's slots hold exactly the (subdomain, slot) pairs that name it
    idx = sm.subdomain_idx.numpy().ravel()
    slots = sm.dof_slots.numpy()
    for dof in range(A.shape[0]):
        got = slots[dof][slots[dof] < idx.size]
        np.testing.assert_array_equal(got, np.flatnonzero(idx == dof))
        assert sm.dof_weight[dof] == 1.0 / max(got.size, 1)
    x0, b = _xb(A.shape[0])
    y = device.apply_smoother(sm, lvl.A, torch.from_numpy(x0),
                              torch.from_numpy(b))
    yj = jdevice.apply_smoother(jsm, ref.A, jnp.asarray(x0), jnp.asarray(b))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-12,
                               atol=1e-12)
    # float32 state and vectors
    sm32 = sm.astype(torch.float32)
    assert sm32.subdomain_inv.dtype == sm32.dof_weight.dtype == torch.float32
    assert sm32.subdomain_idx.dtype == sm32.dof_slots.dtype == torch.int64
    x0, b = _xb(A.shape[0], dtype=np.float32)
    y = device.schwarz_step(lvl.A.astype(torch.float32), sm32,
                            torch.from_numpy(x0), torch.from_numpy(b))
    yj = np.asarray(jdevice.schwarz_step(
        ref.A, jsm.subdomain_idx, jsm.subdomain_inv, jnp.asarray(x0, float),
        jnp.asarray(b, float), 0.9))
    assert y.dtype == torch.float32
    assert np.abs(y.numpy() - yj).max() <= 1e-5 * np.abs(yj).max()


def test_strength_based_schwarz_takes_the_rows_of_a_in_both_packages():
    """The reference's ``strength_based_schwarz`` computes a strength
    matrix and never reads it (``pyamg_tpu/relaxation/smoothing.py:508``):
    its subdomains are A's rows, as for ``schwarz``.  The port carries
    this over on purpose (ROADMAP.md, Queue 3)."""
    A = sp.csr_matrix(stencil_grid(
        diffusion_stencil_2d(epsilon=0.01, theta=np.pi / 6, type="FE"),
        (10, 10), format="csr"))
    lvl, ref = _levels(A)
    data = {}
    for name in ("schwarz", "strength_based_schwarz"):
        data[name] = (smoothing.make_smoother_data(lvl, name, {},
                                                   device="cpu"),
                      jsmoothing.make_smoother_data(ref, name, {}))
    for ours, jsm in zip(data["schwarz"], data["strength_based_schwarz"]):
        np.testing.assert_array_equal(np.asarray(ours.subdomain_idx),
                                      np.asarray(jsm.subdomain_idx))
        np.testing.assert_array_equal(np.asarray(ours.subdomain_inv),
                                      np.asarray(jsm.subdomain_inv))
    rows = np.full(data["schwarz"][0].subdomain_idx.shape, -1)
    for i in range(A.shape[0]):
        cols = A.indices[A.indptr[i]:A.indptr[i + 1]]
        rows[i, :cols.size] = cols
    np.testing.assert_array_equal(data["schwarz"][0].subdomain_idx.numpy(),
                                  rows)


def test_schwarz_complexity_matches_jax():
    A = poisson((24, 24), format="csr")
    J = A.copy()
    J.grid = A.grid
    kw = dict(presmoother="schwarz", postsmoother=("schwarz", {}),
              max_coarse=20)
    ours = pyamg_tpu_torch.smoothed_aggregation_solver(A, device="cpu", **kw)
    ref = _jax(pyamg_tpu.smoothed_aggregation_solver, J, **kw)
    for fn in ("setup_complexity", "cycle_complexity"):
        got = getattr(pyamg_tpu_torch, fn)(ours)
        want = getattr(pyamg_tpu, fn)(ref)
        assert got == pytest.approx(want, rel=1e-12)
    assert pyamg_tpu_torch.cycle_complexity(ours, "W") == pytest.approx(
        pyamg_tpu.cycle_complexity(ref, "W"), rel=1e-12)


@pytest.mark.parametrize("native", [True, False], ids=["library", "python"])
def test_schwarz_hierarchy_takes_the_jax_cg_iterations(native, monkeypatch):
    if not native:
        monkeypatch.setattr(amg_core, "_lib", False)
    A = poisson((48, 48), format="csr")
    J = A.copy()
    J.grid = A.grid
    kw = dict(presmoother="schwarz", postsmoother="schwarz", max_coarse=50)
    ours = pyamg_tpu_torch.smoothed_aggregation_solver(A, device="cpu", **kw)
    ref = _jax(pyamg_tpu.smoothed_aggregation_solver, J, **kw)
    assert len(ours.levels) == len(ref.levels) == 3
    for lo, lr in zip(ours.levels[:-1], ref.levels[:-1]):
        d = abs(lo.A_csr - lr.A_csr)
        assert d.max() <= 1e-10 * abs(lr.A_csr).max()
        assert lo.presmoother.kind == lr.presmoother.kind == "schwarz"
        np.testing.assert_array_equal(lo.presmoother.subdomain_idx.numpy(),
                                      np.asarray(lr.presmoother.subdomain_idx))
    b = A @ np.random.default_rng(0).random(A.shape[0])
    res, jres = [], []
    x = ours.solve(b, tol=1e-8, accel="cg", residuals=res)
    if native:
        ref.solve(b, tol=1e-8, accel="cg", residuals=jres)
        assert len(res) == len(jres) > 3
        np.testing.assert_allclose(res, jres, rtol=1e-8)
    assert np.linalg.norm(b - A @ x.numpy()) <= 1e-8 * np.linalg.norm(b)


def _export_op(op):
    name = type(op).__name__
    if name == "SparseDIA":
        return {"diags": np.asarray(op.diags), "offsets": tuple(op.offsets),
                "shape": tuple(op.shape)}
    if name == "DenseOp":
        return {"mat": np.asarray(op.mat), "shape": tuple(op.shape)}
    assert name in ("CptProlongOp", "CptRestrictOp"), name
    return {"dia": _export_op(op.dia), "cpts": np.asarray(op.cpts),
            "shape": tuple(op.shape), "restrict": name == "CptRestrictOp"}


def test_schwarz_hierarchy_loaded_from_jax_arrays_cycles_like_the_port():
    """The JAX package's Schwarz hierarchy of a plain CSR matrix, exported
    array by array (the smoothers as their subdomain tables and inverses)
    and loaded with ``hierarchy_from_numpy``, which derives each dof's
    correction slots: its V-cycle equals the port's own hierarchy's."""
    from pyamg_tpu_torch.util.convert import hierarchy_from_numpy

    A = sp.csr_matrix(poisson((24, 24), format="csr").tocoo())
    kw = dict(presmoother="schwarz", postsmoother="schwarz", max_coarse=20)
    ours = pyamg_tpu_torch.smoothed_aggregation_solver(A, device="cpu", **kw)
    ref = _jax(pyamg_tpu.smoothed_aggregation_solver, A.copy(), **kw)
    levels = []
    for lvl in ref.levels:
        spec = {"A": _export_op(lvl.A)}
        if getattr(lvl, "P", None) is not None:
            sm = {"kind": "schwarz", "omega": lvl.presmoother.omega,
                  "subdomain_idx": np.asarray(lvl.presmoother.subdomain_idx),
                  "subdomain_inv": np.asarray(lvl.presmoother.subdomain_inv)}
            spec |= {"P": _export_op(lvl.P), "R": _export_op(lvl.R),
                     "presmoother": sm, "postsmoother": sm}
        levels.append(spec)
    loaded = hierarchy_from_numpy(levels, np.asarray(ref._dev()["coarse"][0]),
                                  "cpu", torch.float64)
    for lo, lr in zip(loaded.levels[:-1], ours.levels[:-1]):
        for name in ("subdomain_idx", "dof_slots", "dof_weight"):
            np.testing.assert_array_equal(
                getattr(lo.presmoother, name).numpy(),
                getattr(lr.presmoother, name).numpy())
    x0, b = _xb(A.shape[0])
    y = loaded.cycle_fn("V")(torch.from_numpy(x0), torch.from_numpy(b))
    y_ref = ours.cycle_fn("V")(torch.from_numpy(x0), torch.from_numpy(b))
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), rtol=1e-12,
                               atol=1e-12)


# ---------------------------------------------------------------------------
# node-blocked line smoothers
# ---------------------------------------------------------------------------

def _blocked_grid_matrix(q, grid=(7, 5), seed=0):
    """A q-dofs-a-node operator on a grid: the 5-point Poisson stencil
    times a random SPD node coupling, with one dof's rows and columns
    zeroed (as an eliminated adaptive-SA candidate leaves them)."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((q, q))
    Aq = sp.kron(poisson(grid, format="csr"), M @ M.T + q * np.eye(q))
    Aq = Aq.tolil()
    Aq[q + 1, :] = 0.0
    Aq[:, q + 1] = 0.0
    Aq = sp.csr_matrix(Aq)
    Aq.eliminate_zeros()
    return Aq


@pytest.mark.parametrize("q", [2, 3])
@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("name", ["zebra", "line_jacobi"])
def test_block_line_data_matches_jax(q, axis, name):
    grid = (7, 5)
    A = _blocked_grid_matrix(q, grid)
    lvl, ref = _levels(A, grid=grid, blocksize=q)
    kw = {} if axis is None else {"axis": axis}
    sm = smoothing.make_smoother_data(lvl, name, dict(kw), device="cpu")
    jsm = jsmoothing.make_smoother_data(ref, name, dict(kw))
    assert (sm.kind, sm.line_axis, sm.grid, sm.omega) == \
        (jsm.kind, jsm.line_axis, jsm.grid, jsm.omega)
    L = grid[sm.line_axis]
    assert tuple(sm.line_tri.shape) == (3, q, q, 35 // L, L)
    np.testing.assert_array_equal(sm.line_tri.numpy(),
                                  np.asarray(jsm.line_tri))
    # the zeroed dof (node (0, 1), dof 1) has the identity's row in its
    # diagonal node block
    line, pos = (0, 1) if sm.line_axis == 1 else (1, 0)
    d0 = sm.line_tri.numpy()[1, :, :, line, pos]
    assert d0[1, 1] == 1.0 and (np.delete(d0[1], 1) == 0).all()


@pytest.mark.parametrize("q", [2, 3])
def test_block_line_steps_match_jax(q):
    """Both zebra phases, the zebra sweep and a line Jacobi step on the
    blocked level; lines along the default (strong) axis."""
    grid = (7, 5)
    A = _blocked_grid_matrix(q, grid)
    lvl, ref = _levels(A, grid=grid, blocksize=q)
    x0, b = _xb(A.shape[0])
    for name, phases in (("zebra", (0, 1)), ("line_jacobi", (None,))):
        sm = smoothing.make_smoother_data(lvl, name, {}, device="cpu")
        jsm = jsmoothing.make_smoother_data(ref, name, {})
        for phase in phases:
            y = device.line_relaxation_step(lvl.A, sm, torch.from_numpy(x0),
                                            torch.from_numpy(b), phase)
            yj = jdevice.line_relaxation_step(ref.A, jsm, jnp.asarray(x0),
                                              jnp.asarray(b), phase)
            np.testing.assert_allclose(y.numpy(), np.asarray(yj),
                                       rtol=1e-12, atol=1e-12)
        y = device.apply_smoother(sm, lvl.A, torch.from_numpy(x0),
                                  torch.from_numpy(b))
        assert np.linalg.norm(b - A @ y.numpy()) \
            < np.linalg.norm(b - A @ x0)
    # the zebra sweep is the even phase, then the odd one from its result
    sm = smoothing.make_smoother_data(lvl, "zebra", {}, device="cpu")
    x = torch.from_numpy(x0)
    for phase in (0, 1):
        x = device.line_relaxation_step(lvl.A, sm, x, torch.from_numpy(b),
                                        phase)
    np.testing.assert_array_equal(
        device.apply_smoother(sm, lvl.A, torch.from_numpy(x0),
                              torch.from_numpy(b)).numpy(), x.numpy())


@pytest.mark.parametrize("q,L", [(2, 7), (3, 7), (4, 8)])
def test_block_tridiagonal_pcr_matches_jax_and_a_dense_solve(q, L):
    rng = np.random.default_rng(q * 100 + L)
    nlines = 5
    dl, du = (rng.standard_normal((q, q, nlines, L)) for _ in range(2))
    d = rng.standard_normal((q, q, nlines, L)) \
        + 4.0 * q * np.eye(q)[:, :, None, None]
    dl[..., 0] = 0.0
    du[..., -1] = 0.0
    B = rng.standard_normal((q, nlines, L))
    x = device.batched_block_tridiag_pcr(*(torch.from_numpy(a)
                                           for a in (dl, d, du, B)))
    xj = jdevice.batched_block_tridiag_pcr(*(jnp.asarray(a)
                                             for a in (dl, d, du, B)))
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-12,
                               atol=1e-12)
    for line in range(nlines):
        M = np.zeros((L * q, L * q))
        for i in range(L):
            s = slice(i * q, (i + 1) * q)
            M[s, s] = d[:, :, line, i]
            if i > 0:
                M[s, slice((i - 1) * q, i * q)] = dl[:, :, line, i]
            if i < L - 1:
                M[s, slice((i + 1) * q, (i + 2) * q)] = du[:, :, line, i]
        want = np.linalg.solve(M, B[:, line, :].T.ravel())
        np.testing.assert_allclose(x[:, line, :].numpy().T.ravel(), want,
                                   rtol=1e-10, atol=1e-12)
    inv = device._binv_small(torch.from_numpy(d)).numpy()
    want = np.moveaxis(np.linalg.inv(np.moveaxis(d, (0, 1), (-2, -1))),
                       (-2, -1), (0, 1))
    np.testing.assert_allclose(inv, want, rtol=1e-10, atol=1e-14)


# ---------------------------------------------------------------------------
# the two-candidate adaptive SA with full coarsening
# ---------------------------------------------------------------------------

K2_KW = dict(num_candidates=2, candidate_iters=5, prepostsmoother="zebra",
             aggregate=("grid", {"block": (3, 3)}), max_coarse=100)


def test_k2_full_coarsening_adaptive_sa_matches_jax():
    A = stencil_grid(diffusion_stencil_2d(epsilon=0.001, theta=0.0,
                                          type="FD"), (96, 96), format="csr")
    J = A.copy()
    J.grid = A.grid
    ours, work = pyamg_tpu_torch.adaptive_sa_solver(A, device="cpu", **K2_KW)
    ref, jwork = _jax(pyamg_tpu.adaptive_sa_solver, J, **K2_KW)
    assert work == pytest.approx(jwork, rel=1e-12)
    assert len(ours.levels) == len(ref.levels) == 4
    assert ours.operator_complexity() == pytest.approx(
        ref.operator_complexity(), rel=1e-12)
    assert ours.operator_complexity() < 2.1
    for i, (lo, lr) in enumerate(zip(ours.levels, ref.levels)):
        for name in ("A_csr", "P_csr") if i < 3 else ("A_csr",):
            M, JM = getattr(lo, name), getattr(lr, name)
            assert M.shape == JM.shape
            assert abs(M - JM).max() <= 1e-10 * abs(JM).max(), (i, name)
        np.testing.assert_allclose(lo.B, np.asarray(lr.B), rtol=0,
                                   atol=1e-10)
        if lo.presmoother is not None:
            # level 0: one dof a node, scalar lines; below: 2 dofs a node,
            # 342-style partial blocks at the edge, block lines
            assert lo.presmoother.line_tri.dim() == (3 if i == 0 else 5)
            np.testing.assert_allclose(lo.presmoother.line_tri.numpy(),
                                       np.asarray(lr.presmoother.line_tri),
                                       rtol=1e-10, atol=1e-12)
    assert [lvl.A_csr.shape[0] for lvl in ours.levels] == \
        [9216, 2 * 32 * 32, 2 * 11 * 11, 2 * 4 * 4]
    b = A @ np.random.default_rng(0).random(A.shape[0])
    x, info = ours.astype(torch.float32).solve_mp(
        b, tol=1e-10, return_info=True, inner_maxiter=60)
    _, jinfo = ref.astype(jnp.float32).solve_mp(b, tol=1e-10,
                                                 return_info=True,
                                                 inner_maxiter=60)
    assert info == jinfo
    assert np.linalg.norm(b - A @ x.numpy()) <= 1e-10 * np.linalg.norm(b)
