"""``smoothed_aggregation_solver(A)`` with its default arguments: the port
against the JAX package.

Both packages get the same matrix, each its own copy (so that no cached
spectral estimate passes from one to the other), in float64:

* (a) a gallery Poisson matrix with ``A.grid`` (64^2, 128^2): the
  structured branch after ``improve_candidates``, red-black Gauss-Seidel in
  mask form;
* (b) the same matrix as plain CSR without ``.grid`` (a 40x40 grid, 128^2),
  and an unstructured graph Laplacian of 5,000 nodes: the unstructured
  chain, root-embedded DIA transfers where the embedded pattern is banded,
  padded-ELL levels with gather-form Gauss-Seidel where it is not.

Level by level ``A_csr``, ``P_csr``, ``R_csr`` and B agree to 1e-10, the
device operators reproduce the host matrices and have the JAX package's
classes, the smoother state is equal, the CG and stand-alone iteration
counts are equal and the residual histories agree to 1e-6 relative.  The
pieces of the chain (classical strength, parallel aggregation, the
prolongation smoothers) and the constructor's other options are compared
one by one, and options outside the port raise.

Every reference is built with the JAX package's ``have_native`` patched to
True: four of its branches (the sequential limit of standard aggregation,
first-fit against Jones-Plassmann colors, the native S = I - c D^-1 A, the
native Gauss-Seidel sweep) depend on whether its native library loaded in
this process; one case forces the library off altogether.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import pyamg_tpu
import pyamg_tpu.amg_core as jax_core
from pyamg_tpu.aggregation.aggregate import parallel_aggregation as jax_par
from pyamg_tpu.aggregation.aggregate import standard_aggregation as jax_std
from pyamg_tpu.aggregation.smooth import (
    jacobi_prolongation_smoother as jax_jacobi_P,
    richardson_prolongation_smoother as jax_richardson_P)
from pyamg_tpu.aggregation.tentative import fit_candidates as jax_fit
from pyamg_tpu.gallery import poisson as jax_poisson
from pyamg_tpu.strength import classical_strength_of_connection as jax_classical
from pyamg_tpu.strength import symmetric_strength_of_connection as jax_soc
import pyamg_tpu_torch
from pyamg_tpu_torch.aggregation import (jacobi_prolongation_smoother,
                                         parallel_aggregation,
                                         richardson_prolongation_smoother)
from pyamg_tpu_torch.gallery import poisson
from pyamg_tpu_torch.sparse import (CptProlongOp, CptRestrictOp, SparseELL,
                                    embedded_dia_transfers)
from pyamg_tpu_torch.strength import classical_strength_of_connection
from pyamg_tpu_torch.util.convert import hierarchy_from_numpy

from sa_cases import ARRAYS, assert_same_smoother, unstructured

torch.set_num_threads(1)


def _matrices(case):
    """``(ours, jax's)``: the same matrix, one copy for each package."""
    kind, n = case.split("-")
    if kind == "unstructured":
        A = unstructured(int(n), seed=7, radius=0.03)
        return A, A.copy()
    A = poisson((int(n),) * 2, format="csr")
    J = jax_poisson((int(n),) * 2, format="csr")
    if kind == "plain":                 # what a matrix read from a file is
        A, J = sp.csr_matrix(A.tocoo()), sp.csr_matrix(J.tocoo())
        assert not hasattr(A, "grid")
    return A, J


def _jax_default(J, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_core, "have_native", lambda: True)
        return pyamg_tpu.smoothed_aggregation_solver(J, **kw)


def _close(A, B, tol=1e-10):
    assert A.shape == B.shape
    d = abs(sp.csr_matrix(A) - sp.csr_matrix(B))
    assert (d.max() if d.nnz else 0.0) <= tol * abs(B).max()


def _assert_hierarchies_match(ours, ref):
    assert len(ours.levels) == len(ref.levels)
    for lo, lr in zip(ours.levels, ref.levels):
        _close(lo.A_csr, lr.A_csr)
        assert lo.A_csr.nnz == lr.A_csr.nnz
        np.testing.assert_allclose(lo.B, lr.B, rtol=1e-10, atol=1e-12)
        assert type(lo.A).__name__ == type(lr.A).__name__
        _close(lo.A.to_scipy(), lo.A_csr, 1e-15)
        if not hasattr(lr, "P_csr"):
            continue
        _close(lo.P_csr, lr.P_csr)
        _close(lo.R_csr, lr.R_csr)
        assert type(lo.P).__name__ == type(lr.P).__name__
        assert type(lo.R).__name__ == type(lr.R).__name__
        _close(lo.P.to_scipy(), lo.P_csr, 1e-14)
        _close(lo.R.to_scipy(), lo.R_csr, 1e-14)
        assert_same_smoother(lo.presmoother, lr.presmoother)
        assert_same_smoother(lo.postsmoother, lr.postsmoother)
    assert ours.operator_complexity() == ref.operator_complexity()


CASES = ["grid-64", "grid-128", "plain-40", "plain-128", "unstructured-5000"]


@pytest.fixture(scope="module", params=CASES)
def pair(request):
    A, J = _matrices(request.param)
    ours = pyamg_tpu_torch.smoothed_aggregation_solver(A, device="cpu")
    ref = _jax_default(J)
    b = A @ np.random.default_rng(0).random(A.shape[0])
    return request.param, A, b, ours, ref


def test_default_hierarchy_matches_jax_level_by_level(pair):
    case, _, _, ours, ref = pair
    _assert_hierarchies_match(ours, ref)
    assert len(ours.levels) >= (3 if case == "plain-128" else 2)
    sm0 = ours.levels[0].presmoother
    assert (sm0.kind, sm0.sweep) == ("gauss_seidel", "symmetric")
    if case.startswith("grid"):
        assert hasattr(ours.levels[0], "struct_meta")
        assert sm0.color_masks.shape[0] == 2            # red-black
        # improve_candidates moved B off the constant at the boundary
        assert np.ptp(ours.levels[0].B) > 1e-3
    else:
        assert not hasattr(ours.levels[0], "struct_meta")
        assert ours.levels[0].root_dofs.size == ours.levels[1].A.shape[0]


def test_default_path_takes_the_embedded_and_the_gather_forms(pair):
    case, _, _, ours, _ = pair
    lvl0 = ours.levels[0]
    if case == "plain-128":
        assert isinstance(lvl0.P, CptProlongOp)
        assert isinstance(lvl0.R, CptRestrictOp)
        assert lvl0.P.cpts.dtype == torch.int64
    if case == "unstructured-5000":
        assert isinstance(lvl0.A, SparseELL) and isinstance(lvl0.P, SparseELL)
        assert lvl0.presmoother.color_rows is not None
        assert lvl0.presmoother.color_masks is None


@pytest.mark.parametrize("accel", ["cg", None])
def test_default_solve_matches_jax(pair, accel):
    _, A, b, ours, ref = pair
    res, res_ref = [], []
    x = ours.solve(b, tol=1e-8, accel=accel, residuals=res)
    ref.solve(b, tol=1e-8, accel=accel, residuals=res_ref)
    assert len(res) == len(res_ref) > 3
    np.testing.assert_allclose(res, res_ref, rtol=1e-6)
    assert np.linalg.norm(b - A @ x.numpy()) <= 1e-8 * np.linalg.norm(b)


def test_aspreconditioner_in_scipy_cg_matches_jax(pair):
    _, A, b, ours, ref = pair
    counts = []
    for M in (ours.aspreconditioner(), ref.aspreconditioner()):
        its = []
        x, info = spla.cg(A, b, rtol=1e-8, M=M,
                          callback=lambda xk: its.append(1))
        assert info == 0
        assert np.linalg.norm(b - A @ x) <= 1e-7 * np.linalg.norm(b)
        counts.append(len(its))
    assert counts[0] == counts[1] > 2


def test_setup_matches_jax_without_its_native_library(monkeypatch):
    """The reference built with its native library forced off (and
    ``have_native`` patched as everywhere): its numpy S, triangular-solve
    Gauss-Seidel and Python aggregation and coloring give the hierarchy the
    port builds."""
    monkeypatch.setattr(jax_core, "_lib", False)
    assert not jax_core.have_native()
    for case in ("grid-64", "plain-40"):
        A, J = _matrices(case)
        ours = pyamg_tpu_torch.smoothed_aggregation_solver(
            A, max_coarse=30, device="cpu")
        _assert_hierarchies_match(ours, _jax_default(J, max_coarse=30))
        assert len(ours.levels) >= 3


def test_float32_hierarchy_matches_jax():
    A, J = _matrices("plain-128")
    ours = pyamg_tpu_torch.smoothed_aggregation_solver(
        A, op_dtype=torch.float32, device="cpu")
    ref = _jax_default(J, op_dtype=jnp.float32)
    b = A @ np.random.default_rng(0).random(A.shape[0])
    for lo, lr in zip(ours.levels[:-1], ref.levels[:-1]):
        assert lo.A.dtype == lo.P.dtype == lo.R.dtype == torch.float32
        for name in ARRAYS:
            a, ja = (getattr(s.presmoother, name) for s in (lo, lr))
            assert (a is None) == (ja is None)
            if a is not None and a.is_floating_point():
                assert a.dtype == torch.float32
                np.testing.assert_allclose(a.numpy(), np.asarray(ja),
                                           rtol=1e-6)
    res, res_ref = [], []
    x = ours.solve(b, tol=1e-5, accel="cg", residuals=res)
    ref.solve(b, tol=1e-5, accel="cg", residuals=res_ref)
    assert x.dtype == torch.float32
    assert abs(len(res) - len(res_ref)) <= 1
    assert np.linalg.norm(b - A @ x.double().numpy()) \
        <= 1e-4 * np.linalg.norm(b)


# ---------------------------------------------------------------------------
# the constructor's other options
# ---------------------------------------------------------------------------

def _predefined(A):
    C = jax_soc(A, theta=0.1)
    return {"strength": ("predefined", {"C": C}), "max_levels": 2,
            "aggregate": ("predefined", {"AggOp": jax_std(C)[0]})}


OPTIONS = {
    "classical-strength": dict(strength=("classical", {"theta": 0.3})),
    "no-strength": dict(strength=None),
    "symmetric-theta": dict(strength=("symmetric", {"theta": 0.2}),
                            symmetry="symmetric"),
    "parallel": dict(aggregate="parallel"),
    "mis-seeded": dict(aggregate=("mis", {"seed": 3})),
    "naive": dict(aggregate="naive"),
    "sequential-limit": dict(aggregate=("standard",
                                        {"sequential_limit": 1000})),
    "predefined": _predefined,
    "richardson-P": dict(smooth=("richardson", {"omega": 1.0})),
    "jacobi-P-degree-2-local": dict(smooth=("jacobi", {"degree": 2,
                                                       "weighting": "local",
                                                       "omega": 0.6})),
    "no-P-smoothing": dict(smooth=None),
    "diagonal-dominance": dict(diagonal_dominance=True),
    "coarse-filter": dict(coarse_filter=0.05),
    "per-level": dict(strength=["symmetric", ("classical", {"theta": 0.1})],
                      aggregate=["standard", "naive"],
                      smooth=[("jacobi", {"omega": 1.0}), None],
                      improve_candidates=[("gauss_seidel",
                                           {"sweep": "forward"}), None]),
    "jacobi-smoothers": dict(presmoother=("jacobi", {"omega": 0.7}),
                             postsmoother=("sor", {"omega": 1.1}),
                             improve_candidates=None),
    "given-B": dict(B=np.linspace(1.0, 2.0, 1600)),
    "max-levels-2": dict(max_levels=2),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_option_matches_jax(option):
    A, J = _matrices("plain-40")
    if option == "diagonal-dominance":
        for M in (A, J):
            M.setdiag(np.where(np.arange(1600) % 7 == 0, 9.0, 4.0))
    kw = OPTIONS[option]
    kw = kw(A) if callable(kw) else kw
    ours = pyamg_tpu_torch.smoothed_aggregation_solver(
        A, max_coarse=40, device="cpu", **kw)
    ref = _jax_default(J, max_coarse=40, **kw)
    _assert_hierarchies_match(ours, ref)
    assert len(ours.levels) == (2 if option == "max-levels-2" else
                                len(ref.levels)) >= 2
    b = np.random.default_rng(1).standard_normal(A.shape[0])
    x0 = np.random.default_rng(2).standard_normal(A.shape[0])
    y = ours.cycle_fn("V")(torch.from_numpy(x0), torch.from_numpy(b))
    y_ref = np.asarray(ref.cycle_fn("V")(jnp.asarray(x0), jnp.asarray(b)))
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("option", ["richardson-P", "no-P-smoothing",
                                    "jacobi-smoothers"])
def test_structured_option_matches_jax(option):
    A, J = _matrices("grid-64")
    kw = OPTIONS[option]
    ours = pyamg_tpu_torch.smoothed_aggregation_solver(
        A, max_coarse=40, device="cpu", **kw)
    ref = _jax_default(J, max_coarse=40, **kw)
    _assert_hierarchies_match(ours, ref)
    assert all(hasattr(lvl, "struct_meta") for lvl in ours.levels[:-1])


def test_keep_holds_the_setup_byproducts():
    A, _ = _matrices("plain-40")
    ml = pyamg_tpu_torch.smoothed_aggregation_solver(A, keep=True,
                                                     device="cpu")
    lvl = ml.levels[0]
    assert lvl.C.shape == A.shape and lvl.AggOp.shape == lvl.T.shape
    assert pyamg_tpu_torch.smoothed_aggregation_solver(
        A, device="cpu").levels[0].C is None
    host = pyamg_tpu_torch.smoothed_aggregation_solver(
        A, finalize_device=False, device="cpu")
    assert not hasattr(host.levels[0], "A") and host.levels[0].P_csr.nnz


# options that raised until a later slice ported them: they now build the
# JAX package's hierarchy (the blocked options: test_torch_blocked.py and
# test_torch_energy.py compare them level by level; the evolution and
# energy-based strength and the zebra smoother, of the classical slice:
# test_torch_strength.py and test_torch_classical.py; 3-D grid metadata:
# test_torch_grid3d.py; the nonsymmetric setup, energy smoothing by CGNR
# and the NE/NR smoothers: test_torch_nonsymmetric.py; Lloyd and pairwise
# aggregation: test_torch_matching.py)
PORTED_SINCE = ("two-candidates", "filtered-jacobi", "bsr", "evolution",
                "energy_based", "zebra", "grid3d", "nonsymmetric", "energy",
                "jacobi_ne", "lloyd", "pairwise")


@pytest.mark.parametrize("kw", [
    dict(symmetry="nonsymmetric"),
    dict(B=np.ones((400, 2))),
    dict(strength="evolution"),
    dict(strength=("energy_based", {})),
    dict(aggregate="lloyd"),
    dict(aggregate="pairwise"),
    dict(smooth=("energy", {"krylov": "cgnr"})),
    dict(smooth=("jacobi", {"filter": True})),
    dict(presmoother="zebra"),
    dict(postsmoother=("jacobi_ne", {})),
    {"bsr": True},
    {"grid3d": True},
], ids=["nonsymmetric", "two-candidates", "evolution", "energy_based",
        "lloyd", "pairwise", "energy", "filtered-jacobi", "zebra",
        "jacobi_ne", "bsr", "grid3d"])
def test_options_outside_the_port_raise(kw, request):
    kw = dict(kw)
    A = sp.csr_matrix(poisson((20, 20), format="csr").tocoo())
    if kw.pop("bsr", False):
        A = A.tobsr(blocksize=(2, 2))
    if kw.pop("grid3d", False):
        A = poisson((6, 6, 6), format="csr")
    if request.node.callspec.id in PORTED_SINCE:
        ours = pyamg_tpu_torch.smoothed_aggregation_solver(
            A, max_coarse=20, device="cpu", **kw)
        ref = _jax_default(A.copy(), max_coarse=20, **kw)
        assert [lvl.A_csr.shape for lvl in ours.levels] == \
            [lvl.A_csr.shape for lvl in ref.levels]
        assert len(ours.levels) > 1
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pyamg_tpu_torch.smoothed_aggregation_solver(A, max_coarse=20,
                                                    device="cpu", **kw)


@pytest.mark.parametrize("kw,err", [
    (dict(symmetry="skew"), "symmetry"),
    (dict(strength="no_such"), "strength"),
    (dict(aggregate="no_such"), "aggregation"),
    (dict(smooth="no_such"), "prolongation smoother"),
    (dict(presmoother="no_such"), "unknown smoother"),
    (dict(coarse_solver="no_such"), "coarse solver"),
    (dict(B=np.ones(7)), "near nullspace"),
], ids=["symmetry", "strength", "aggregate", "smooth", "presmoother",
        "coarse_solver", "B"])
def test_unknown_options_raise_value_error(kw, err):
    A = sp.csr_matrix(poisson((20, 20), format="csr").tocoo())
    with pytest.raises(ValueError, match=err):
        pyamg_tpu_torch.smoothed_aggregation_solver(A, max_coarse=20,
                                                    device="cpu", **kw)


# ---------------------------------------------------------------------------
# the pieces of the unstructured chain
# ---------------------------------------------------------------------------

GRAPHS = {"poisson": lambda: poisson((30, 31), format="csr"),
          "unstructured": lambda: unstructured(800, seed=5, radius=0.07)}


@pytest.mark.parametrize("theta", [0.0, 0.25, 0.6])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_classical_strength_matches_jax(graph, theta):
    A = GRAPHS[graph]()
    A.data = A.data * (1 + np.random.default_rng(0).random(A.nnz))
    ours = classical_strength_of_connection(A, theta=theta)
    ref = jax_classical(A.copy(), theta=theta)
    assert ours.nnz == ref.nnz and abs(ours - ref).max() <= 1e-15
    with pytest.raises(ValueError, match="theta"):
        classical_strength_of_connection(A, theta=1.5)
    # a block (BSR) operator: filtered entry by entry, then amalgamated
    Ab = A[:A.shape[0] // 2 * 2, :A.shape[0] // 2 * 2].tobsr(blocksize=(2, 2))
    ours_b = classical_strength_of_connection(Ab, theta=theta)
    ref_b = jax_classical(Ab.copy(), theta=theta)
    assert ours_b.shape == (Ab.shape[0] // 2,) * 2
    assert ours_b.nnz == ref_b.nnz and abs(ours_b - ref_b).max() == 0


@pytest.mark.parametrize("seed", [0, 4])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_parallel_aggregation_matches_jax(graph, seed):
    C = jax_soc(GRAPHS[graph]())
    (Agg, roots), (JAgg, jroots) = (parallel_aggregation(C, seed=seed),
                                    jax_par(C, seed=seed))
    assert abs(Agg - JAgg).max() == 0 and Agg.nnz == JAgg.nnz
    np.testing.assert_array_equal(roots, jroots)
    assert Agg.shape == (C.shape[0], roots.size)
    np.testing.assert_array_equal(np.diff(Agg.indptr), 1)   # a partition
    # no two roots adjacent
    assert C[roots][:, roots].nnz == roots.size


def _tentative(A):
    C = jax_soc(A)
    AggOp, _ = jax_std(C)
    B = np.random.default_rng(2).random((A.shape[0], 1)) + 0.5
    T, Bc = jax_fit(AggOp, B)
    return C, T, Bc


@pytest.mark.parametrize("kw", [
    dict(), dict(sym_hint=True), dict(omega=1.0, degree=2),
    dict(weighting="local", omega=0.5), dict(weighting="block"),
], ids=["default", "sym-hint", "degree-2", "local", "block-on-scalar"])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_jacobi_prolongation_smoother_matches_jax(graph, kw):
    A = GRAPHS[graph]()
    C, T, Bc = _tentative(A)
    P = jacobi_prolongation_smoother(A.copy(), T, C, Bc, **kw)
    JP = jax_jacobi_P(A.copy(), T, C, Bc, **kw)
    assert P.nnz == JP.nnz > T.nnz
    _close(P, JP, 1e-12)


def test_jacobi_prolongation_smoother_without_a_stored_diagonal():
    A = sp.lil_matrix(GRAPHS["poisson"]())
    A[4, 4] = 0.0
    A = A.tocsr()
    A.eliminate_zeros()
    C, T, Bc = _tentative(A)
    _close(jacobi_prolongation_smoother(A.copy(), T, C, Bc),
           jax_jacobi_P(A.copy(), T, C, Bc), 1e-12)


@pytest.mark.parametrize("kw", [dict(), dict(sym_hint=True, degree=2)],
                         ids=["default", "sym-hint-degree-2"])
def test_richardson_prolongation_smoother_matches_jax(kw):
    A = GRAPHS["unstructured"]()
    _, T, _ = _tentative(A)
    _close(richardson_prolongation_smoother(A.copy(), T, **kw),
           jax_richardson_P(A.copy(), T, **kw), 1e-12)


# ---------------------------------------------------------------------------
# embedded transfers and the loader
# ---------------------------------------------------------------------------

def test_embedded_transfers_apply_P_and_R():
    A, _ = _matrices("plain-128")
    lvl = pyamg_tpu_torch.smoothed_aggregation_solver(
        A, device="cpu").levels[0]
    P, R = lvl.P, lvl.R
    rng = np.random.default_rng(0)
    xc, xf = rng.standard_normal(P.shape[1]), rng.standard_normal(P.shape[0])
    np.testing.assert_allclose(P.matvec(torch.from_numpy(xc)).numpy(),
                               lvl.P_csr @ xc, rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(R.matvec(torch.from_numpy(xf)).numpy(),
                               lvl.R_csr @ xf, rtol=1e-12, atol=1e-13)
    assert P.astype(torch.float32).dtype == torch.float32
    assert R.astype(torch.float32).matvec(
        torch.from_numpy(xf).float()).dtype == torch.float32
    # a pattern with more diagonals than the cap, or roots that do not
    # number the coarse dofs: no embedding
    assert embedded_dia_transfers(lvl.P_csr, lvl.root_dofs, max_offsets=3,
                                  device="cpu") is None
    assert embedded_dia_transfers(lvl.P_csr, lvl.root_dofs[:-1],
                                  device="cpu") is None
    # an explicit restriction (a nonsymmetric level's R) embeds its own
    # rows at the same roots; here R = P^T, so it equals the transpose form
    Pe, Re = embedded_dia_transfers(lvl.P_csr, lvl.root_dofs,
                                    restrict="explicit", R_csr=lvl.R_csr,
                                    device="cpu")
    np.testing.assert_allclose(Re.matvec(torch.from_numpy(xf)).numpy(),
                               R.matvec(torch.from_numpy(xf)).numpy(),
                               rtol=1e-12, atol=1e-13)
    assert embedded_dia_transfers(lvl.P_csr, lvl.root_dofs,
                                  restrict="explicit", device="cpu") is None


def _export_op(op):
    name = type(op).__name__
    if name == "SparseDIA":
        return {"diags": np.asarray(op.diags), "offsets": tuple(op.offsets),
                "shape": tuple(op.shape)}
    if name == "SparseELL":
        return {k: np.asarray(getattr(op, k))
                for k in ("data", "cols", "row_nnz")} | {"shape": op.shape}
    if name == "DenseOp":
        return {"mat": np.asarray(op.mat), "shape": tuple(op.shape)}
    assert name in ("CptProlongOp", "CptRestrictOp")
    return {"dia": _export_op(op.dia), "cpts": np.asarray(op.cpts),
            "shape": tuple(op.shape), "restrict": name == "CptRestrictOp"}


def _export_smoother(sm):
    out = {"kind": sm.kind, "sweep": sm.sweep, "iterations": sm.iterations,
           "omega": sm.omega, "blocksize": sm.blocksize,
           "coefficients": tuple(sm.coefficients)}
    for name in ARRAYS:
        a = getattr(sm, name)
        out[name] = None if a is None else np.asarray(a)
    return out


@pytest.mark.parametrize("pair", ["plain-128", "unstructured-5000"],
                         indirect=True)
def test_hierarchy_loaded_from_jax_arrays_cycles_like_jax(pair):
    """The JAX package's default hierarchy, exported array by array and
    loaded with ``hierarchy_from_numpy``: levels that mix DIA, dense,
    padded-ELL and embedded operators and carry mask- and gather-form
    smoothers."""
    _, A, b, _, ref = pair
    coarse = np.asarray(ref._dev()["coarse"][0])
    levels = []
    for lvl in ref.levels:
        spec = {"A": _export_op(lvl.A)}
        if getattr(lvl, "P", None) is not None:
            spec |= {"P": _export_op(lvl.P), "R": _export_op(lvl.R),
                     "presmoother": _export_smoother(lvl.presmoother),
                     "postsmoother": _export_smoother(lvl.postsmoother)}
        levels.append(spec)
    loaded = hierarchy_from_numpy(levels, coarse, "cpu", torch.float64)
    for lo, lr in zip(loaded.levels, ref.levels):
        assert type(lo.A).__name__ == type(lr.A).__name__
    x0 = np.random.default_rng(1).standard_normal(b.shape[0])
    y = loaded.cycle_fn("V")(torch.from_numpy(x0), torch.from_numpy(b))
    y_ref = np.asarray(ref.cycle_fn("V")(jnp.asarray(x0), jnp.asarray(b)))
    assert np.abs(y.numpy() - y_ref).max() <= 1e-12 * np.abs(y_ref).max()
    with pytest.raises(ValueError, match="operator dict"):
        hierarchy_from_numpy([{"A": {"shape": (2, 2)}}], coarse, "cpu",
                             torch.float64)
