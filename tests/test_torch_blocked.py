"""Blocked smoothed aggregation: the port against the JAX package.

The same numpy inputs (``np.random.default_rng(seed)``, the gallery's Q1
linear elasticity) go through both packages on the CPU:

* ``SparseBDIA`` and ``BlockELL``: round trips through scipy, ``matvec``
  and ``matmat`` against the JAX classes (float64 1e-12, float32 1e-6
  relative), the host transpose, diagonals and casts;
* block classical and symmetric strength of connection, exactly;
* ``fit_candidates`` for (K, bs) in {(1, 2), (3, 2), (3, 3), (3, 1)}: T and
  the coarse candidates within 1e-12;
* Jacobi prolongation smoothing of a BSR operator for each weighting, with
  and without the strength filter; ``satisfy_constraints``; the util
  helpers and ``bsr_utils``; the host block Gauss-Seidel sweep;
* whole hierarchies level by level: the default call on
  ``linear_elasticity``'s BSR with its grid (Jacobi P on the structured
  K-candidate path, ``SparseBDIA`` smoothers in the transfers), the same
  with the rigid-body modes, the same matrix as plain CSR with B (scalar,
  K = 3), and one case with both host libraries forced off.  Levels, rows,
  nnz and aggregates equal; P, R and A within 1e-10 relative; the operator
  form of each level equal; CG iteration counts to 1e-8 equal.

Every reference is built with the JAX package's ``have_native`` patched to
True (its standard aggregation and coloring depend on it), but in the case
that forces both host libraries off, at sizes under 50,000 rows.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pyamg_tpu
import pyamg_tpu.amg_core as jax_core
from pyamg_tpu.aggregation.smooth import (
    jacobi_prolongation_smoother as jax_jacobi_P,
    satisfy_constraints as jax_satisfy)
from pyamg_tpu.aggregation.tentative import fit_candidates as jax_fit
from pyamg_tpu.gallery import linear_elasticity as jax_elasticity
from pyamg_tpu.relaxation.relaxation import block_gauss_seidel as jax_bgs
from pyamg_tpu.sparse import BlockELL as JaxBlockELL
from pyamg_tpu.sparse import SparseBDIA as JaxSparseBDIA
from pyamg_tpu.strength import classical_strength_of_connection as jax_cls
from pyamg_tpu.strength import symmetric_strength_of_connection as jax_sym
from pyamg_tpu.util import bsr_utils as jax_bsr_utils
from pyamg_tpu.util import utils as jax_utils
import pyamg_tpu_torch
from pyamg_tpu_torch import amg_core
from pyamg_tpu_torch.aggregation import smooth
from pyamg_tpu_torch.aggregation.aggregate import standard_aggregation
from pyamg_tpu_torch.aggregation.tentative import fit_candidates
from pyamg_tpu_torch.gallery import linear_elasticity
from pyamg_tpu_torch.relaxation.relaxation import block_gauss_seidel
from pyamg_tpu_torch.sparse import BlockELL, SparseBDIA
from pyamg_tpu_torch.strength import (classical_strength_of_connection,
                                      symmetric_strength_of_connection)
from pyamg_tpu_torch.util import bsr_utils, utils

from sa_cases import assert_same_smoother

torch.set_num_threads(1)


def _rel(a, b):
    d = abs(sp.csr_matrix(a) - sp.csr_matrix(b))
    return (d.max() if d.nnz else 0.0) / max(abs(sp.csr_matrix(b)).max(),
                                             1e-300)


def _blocked(K, nb=60, seed=0, bandwidth=3):
    """A random symmetric, diagonally dominant BSR matrix of (K, K) blocks
    on the block diagonals -bandwidth .. bandwidth."""
    rng = np.random.default_rng(seed)
    offs = list(range(-bandwidth, bandwidth + 1))
    pat = sp.diags([np.ones(nb - abs(o)) for o in offs], offs)
    mask = sp.kron(pat, np.ones((K, K))).toarray() != 0
    M = np.where(mask, rng.standard_normal(mask.shape), 0.0)
    A = M + M.T + 4.0 * K * len(offs) * np.eye(nb * K)
    return sp.bsr_matrix(A, blocksize=(K, K))


# ---------------------------------------------------------------------------
# SparseBDIA and BlockELL
# ---------------------------------------------------------------------------

BDIA_CASES = {"elasticity": lambda: linear_elasticity((9, 7))[0],
              "K3": lambda: _blocked(3, nb=40, seed=1),
              "K2-wide": lambda: _blocked(2, nb=50, seed=2, bandwidth=6)}


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-6)])
@pytest.mark.parametrize("case", sorted(BDIA_CASES))
def test_sparse_bdia_matches_jax(case, dtype, tol):
    A = BDIA_CASES[case]()
    rng = np.random.default_rng(3)
    x = rng.standard_normal(A.shape[0]).astype(dtype)
    X = rng.standard_normal((A.shape[0], 3)).astype(dtype)
    ours = SparseBDIA.from_scipy_bsr(A, dtype=dtype, device="cpu")
    ref = JaxSparseBDIA.from_scipy_bsr(A, dtype=dtype)
    assert ours.offsets == ref.offsets and ours.blocksize == ref.blocksize
    np.testing.assert_array_equal(ours.blocks.numpy(), np.asarray(ref.blocks))
    assert ours.nnz == ref.nnz and ours.dtype == torch.from_numpy(x).dtype
    y, jy = ours.matvec(torch.from_numpy(x)).numpy(), np.asarray(ref @ x)
    np.testing.assert_allclose(y, jy, rtol=tol, atol=tol * abs(jy).max())
    Y, jY = (ours @ torch.from_numpy(X)).numpy(), np.asarray(ref @ X)
    np.testing.assert_allclose(Y, jY, rtol=tol, atol=tol * abs(jY).max())
    ref_y = (A.astype(np.float64) @ x.astype(np.float64))
    assert abs(y - ref_y).max() <= 10 * tol * abs(ref_y).max()
    # the round trip, the diagonals, the transpose, a cast
    assert _rel(ours.to_scipy(), A.astype(dtype)) == 0
    np.testing.assert_array_equal(ours.diagonal().numpy(),
                                  np.asarray(ref.diagonal()))
    np.testing.assert_array_equal(ours.block_diagonal().numpy(),
                                  np.asarray(ref.block_diagonal()))
    blocks, offs = SparseBDIA.host_blocks(A, dtype=dtype)
    for conj in (False, True):
        bt, ot = SparseBDIA.host_transpose(blocks, offs, conj=conj)
        jbt, jot = JaxSparseBDIA.host_transpose(blocks, offs, conj=conj)
        assert ot == jot
        np.testing.assert_array_equal(bt, jbt)
    AT = SparseBDIA(torch.from_numpy(bt), ot, A.shape)
    assert _rel(AT.to_scipy(), A.T.astype(dtype)) == 0
    assert ours.astype(torch.float64).dtype == torch.float64
    with pytest.raises(ValueError, match="block diagonals"):
        SparseBDIA.host_blocks(A, max_offsets=2)


def test_sparse_bdia_without_a_main_block_diagonal():
    A = sp.bsr_matrix(sp.diags([np.ones(8)], [2]).tocsr(), blocksize=(2, 2))
    ours = SparseBDIA.from_scipy_bsr(A, device="cpu")
    assert ours.offsets == (1,)
    assert not ours.diagonal().any() and not ours.block_diagonal().any()
    x = torch.arange(10, dtype=torch.float64)
    np.testing.assert_array_equal(ours.matvec(x).numpy(), A @ x.numpy())
    with pytest.raises(ValueError, match="square blocks"):
        SparseBDIA.host_blocks(sp.bsr_matrix(np.eye(6), blocksize=(2, 3)))


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-6)])
@pytest.mark.parametrize("case", sorted(BDIA_CASES))
def test_block_ell_matches_jax(case, dtype, tol):
    A = BDIA_CASES[case]()
    x = np.random.default_rng(5).standard_normal(A.shape[0]).astype(dtype)
    ours = BlockELL.from_scipy(A, dtype=dtype, device="cpu")
    ref = JaxBlockELL.from_scipy(A, dtype=dtype)
    np.testing.assert_array_equal(ours.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(ours.cols.numpy(), np.asarray(ref.cols))
    np.testing.assert_array_equal(ours.valid_mask().numpy(),
                                  np.asarray(ref.valid_mask()))
    np.testing.assert_array_equal(ours.block_diagonal().numpy(),
                                  np.asarray(ref.block_diagonal()))
    y, jy = (ours @ torch.from_numpy(x)).numpy(), np.asarray(ref @ x)
    np.testing.assert_allclose(y, jy, rtol=tol, atol=tol * abs(jy).max())
    assert _rel(ours.to_scipy(), A.astype(dtype)) == 0
    # to_csr takes both block operators, as the JAX package's does
    assert _rel(utils.to_csr(ours), jax_utils.to_csr(ref)) == 0
    bd = SparseBDIA.from_scipy_bsr(A, dtype=dtype, device="cpu")
    assert _rel(utils.to_csr(bd), A.astype(dtype)) == 0
    wide = BlockELL.from_scipy(A.tocsr(), blocksize=A.blocksize[0],
                               width=ours.width + 2, device="cpu")
    assert wide.width == ours.width + 2
    assert ours.astype(torch.float64).dtype == torch.float64


# ---------------------------------------------------------------------------
# strength, fit_candidates, Jacobi P on blocks, helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("theta", [0.0, 0.08, 0.5])
@pytest.mark.parametrize("case", sorted(BDIA_CASES))
def test_block_strength_matches_jax(case, theta):
    A = BDIA_CASES[case]()
    for ours_fn, jax_fn in ((classical_strength_of_connection, jax_cls),
                            (symmetric_strength_of_connection, jax_sym)):
        S = ours_fn(A.copy(), theta=theta)
        J = jax_fn(A.copy(), theta=theta)
        nb = A.shape[0] // A.blocksize[0]
        assert S.shape == (nb, nb)
        assert S.nnz == J.nnz and _rel(S, J) == 0


@pytest.mark.parametrize("K,bs", [(1, 2), (3, 2), (3, 3), (3, 1)])
def test_fit_candidates_matches_jax(K, bs):
    rng = np.random.default_rng(K * 10 + bs)
    n_nodes, n_agg = 90, 14
    labels = rng.integers(0, n_agg, n_nodes)
    labels[:n_agg] = np.arange(n_agg)          # no empty aggregate
    labels[::17] = -1                          # unaggregated nodes
    keep = labels >= 0
    AggOp = sp.csr_matrix((np.ones(keep.sum()), (np.flatnonzero(keep),
                                                 labels[keep])),
                          shape=(n_nodes, n_agg))
    B = rng.standard_normal((n_nodes * bs, K))
    if K > 1:
        B[:, -1] = B[:, 0]                     # a dependent candidate
        B[:, 1] *= -1
    T, Bc = fit_candidates(AggOp, B)
    JT, JBc = jax_fit(AggOp, B)
    assert T.shape == JT.shape == (n_nodes * bs, n_agg * K)
    assert T.nnz == JT.nnz and abs(T - JT).max() <= 1e-12
    np.testing.assert_allclose(Bc, JBc, rtol=0, atol=1e-12)
    rows = np.repeat(keep, bs)
    np.testing.assert_allclose((T @ Bc)[rows], B[rows], atol=1e-12)
    # the coarse candidates of each aggregate are upper triangular with a
    # non-negative diagonal
    R = Bc.reshape(n_agg, K, K)
    assert (np.diagonal(R, axis1=1, axis2=2) >= 0).all()
    assert np.abs(np.tril(R, -1)).max(initial=0) == 0


def _elasticity_pieces(grid=(14, 12)):
    A, B = linear_elasticity(grid)
    C = symmetric_strength_of_connection(A, theta=0.0)
    AggOp, _ = standard_aggregation(C)
    T, Bc = fit_candidates(AggOp, B)
    return A, B, C, T, Bc


@pytest.mark.parametrize("weighting", ["diagonal", "local", "block"])
@pytest.mark.parametrize("filt", [False, True], ids=["plain", "filter"])
def test_jacobi_prolongation_on_bsr_matches_jax(weighting, filt):
    A, _B, C, T, Bc = _elasticity_pieces()
    kw = dict(omega=4.0 / 3.0, degree=2, filter=filt, weighting=weighting)
    P = smooth.jacobi_prolongation_smoother(A.copy(), T, C, Bc, **kw)
    J = jax_jacobi_P(A.copy(), T, C, Bc, **kw)
    assert P.nnz == J.nnz and _rel(P, J) <= 1e-12
    if filt:
        # the filter keeps the candidates' interpolation exactly
        np.testing.assert_allclose(P @ Bc, T @ Bc, atol=1e-9)


def test_satisfy_constraints_and_helpers_match_jax():
    A, B, C, T, Bc = _elasticity_pieces((10, 9))
    U = (A @ T).tocsr()
    G = utils.compute_BtBinv(Bc, U)
    np.testing.assert_allclose(G, jax_utils.compute_BtBinv(Bc, U),
                               rtol=1e-12, atol=1e-12)
    V = smooth.satisfy_constraints(U, Bc, G)
    assert _rel(V, jax_satisfy(U, Bc, G)) <= 1e-12
    assert abs(V @ Bc).max() <= 1e-9 * abs(U @ Bc).max()
    assert _rel(utils.unamal(C, 2, 3), jax_utils.unamal(C, 2, 3)) == 0
    assert utils.blocksize(A) == jax_utils.blocksize(A) == 2
    assert utils.blocksize(A.tocsr()) == 1
    # float32 candidates take the padded numpy Gram
    G32 = utils.compute_BtBinv(Bc.astype(np.float32), U)
    np.testing.assert_allclose(G32, G, rtol=1e-3, atol=1e-3 * abs(G).max())


def test_bsr_utils_match_jax():
    A = BDIA_CASES["K3"]().astype(np.float64)
    for i in (0, 4, 59):
        v, c = bsr_utils.bsr_get_row(A, i)
        jv, jc = jax_bsr_utils.bsr_get_row(A, i)
        np.testing.assert_array_equal(v, jv)
        np.testing.assert_array_equal(c, jc)
    A1, A2 = A.copy(), A.copy()
    bsr_utils.bsr_row_write_scalar(A1, 7, 2.5)
    jax_bsr_utils.bsr_row_write_scalar(A2, 7, 2.5)
    n_row = (A.indptr[3] - A.indptr[2]) * 3
    vals = np.arange(n_row, dtype=float)
    bsr_utils.BSR_Row_WriteVect(A1, 8, vals)
    jax_bsr_utils.BSR_Row_WriteVect(A2, 8, vals)
    np.testing.assert_array_equal(A1.data, A2.data)
    with pytest.raises(TypeError):
        bsr_utils.bsr_get_row(A.tocsr(), 0)


@pytest.mark.parametrize("sweep", ["forward", "backward", "symmetric"])
@pytest.mark.parametrize("bs", [2, 3])
def test_host_block_gauss_seidel_matches_jax(bs, sweep, monkeypatch):
    A = _blocked(bs, nb=50, seed=bs)
    rng = np.random.default_rng(bs)
    b = rng.standard_normal(A.shape[0])
    x0 = rng.standard_normal(A.shape[0])
    x, xj = x0.copy(), x0.copy()
    block_gauss_seidel(A, x, b, blocksize=bs, iterations=2, sweep=sweep)
    jax_bgs(A, xj, b, blocksize=bs, iterations=2, sweep=sweep)
    np.testing.assert_allclose(x, xj, rtol=1e-12, atol=1e-12)
    # the Python sweep, with the library forced off, gives the same x
    monkeypatch.setattr(amg_core, "_lib", False)
    xp = x0.copy()
    block_gauss_seidel(A, xp, b, blocksize=bs, iterations=2, sweep=sweep)
    np.testing.assert_allclose(xp, x, rtol=1e-12, atol=1e-12)
    assert np.linalg.norm(b - A @ x) < np.linalg.norm(b - A @ x0)


# ---------------------------------------------------------------------------
# whole hierarchies
# ---------------------------------------------------------------------------

def _jax_sa(A, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_core, "have_native", lambda: True)
        return pyamg_tpu.smoothed_aggregation_solver(A, **kw)


def assert_blocked_hierarchies_match(ours, ref):
    """Levels, rows, nnz, blocksizes and forms equal; A, P, R and B within
    1e-10 relative; each device operator reproduces its host matrix."""
    assert [lvl.A_csr.shape for lvl in ours.levels] == \
        [lvl.A_csr.shape for lvl in ref.levels]
    for lo, lr in zip(ours.levels, ref.levels):
        assert lo.A_csr.nnz == lr.A_csr.nnz
        assert _rel(lo.A_csr, lr.A_csr) <= 1e-10
        assert lo.blocksize == lr.blocksize
        assert (lo.A_bsr is None) == (getattr(lr, "A_bsr", None) is None)
        if lo.A_bsr is not None:
            assert lo.A_bsr.blocksize == lr.A_bsr.blocksize
            assert _rel(lo.A_bsr, lo.A_csr) <= 1e-15
        np.testing.assert_allclose(lo.B, lr.B, rtol=1e-10,
                                   atol=1e-10 * abs(lr.B).max())
        assert type(lo.A).__name__ == type(lr.A).__name__
        assert _rel(lo.A.to_scipy(), lo.A_csr) <= 1e-15
        if not hasattr(lr, "P_csr"):
            continue
        assert lo.P_csr.nnz == lr.P_csr.nnz
        assert _rel(lo.P_csr, lr.P_csr) <= 1e-10
        assert _rel(lo.R_csr, lr.R_csr) <= 1e-10
        for op, jop in ((lo.P, lr.P), (lo.R, lr.R)):
            assert type(op).__name__ == type(jop).__name__
            if type(op).__name__ == "ComposedOp":
                assert [type(o).__name__ for o in op.ops] == \
                    [type(o).__name__ for o in jop.ops]
        assert _rel(lo.P.to_scipy(), lo.P_csr) <= 1e-13
        assert _rel(lo.R.to_scipy(), lo.R_csr) <= 1e-13
        meta, jmeta = (getattr(lo, "struct_meta", None),
                       getattr(lr, "struct_meta", None))
        assert (meta is None) == (jmeta is None)
        if meta is not None:
            assert (meta["K"], meta["q"], meta["block"]) == \
                (jmeta["K"], jmeta["q"], jmeta["block"])
            np.testing.assert_allclose(meta["wmap"], jmeta["wmap"],
                                       rtol=1e-10, atol=1e-12)
        assert (getattr(lo, "root_dofs", None) is None) == \
            (getattr(lr, "root_dofs", None) is None)
        assert_same_smoother(lo.presmoother, lr.presmoother)
    assert ours.operator_complexity() == pytest.approx(
        ref.operator_complexity(), rel=1e-14)


def _cg_iterations(ml, b):
    res = []
    ml.solve(b, tol=1e-8, accel="cg", maxiter=100, residuals=res)
    return len(res) - 1


CASES = {
    # the default call on the gallery's BSR with its grid: B = kron(1, I2)
    "bsr-grid-default": dict(B=False),
    # ... and with the rigid-body modes: K = 3 on 2 dofs per node
    "bsr-grid-rbm": dict(),
    # the same matrix as plain CSR with B: the scalar chain with K = 3
    "csr-rbm": dict(csr=True, max_coarse=40),
    # the BSR input without grid metadata: the blocked general chain
    "bsr-plain-rbm": dict(plain=True, max_coarse=40),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    kw = dict(CASES[request.param])
    A, B = linear_elasticity((24, 24))
    J, JB = jax_elasticity((24, 24))
    if kw.pop("B", True) is False:
        B = JB = None
    if kw.pop("csr", False):
        A, J = sp.csr_matrix(A.tocoo()), sp.csr_matrix(J.tocoo())
    if kw.pop("plain", False):
        A, J = sp.bsr_matrix(A.tocoo().tocsr(), blocksize=(2, 2)), \
            sp.bsr_matrix(J.tocoo().tocsr(), blocksize=(2, 2))
        assert not hasattr(A, "grid")
    ours = pyamg_tpu_torch.smoothed_aggregation_solver(A, B=B, device="cpu",
                                                       **kw)
    ref = _jax_sa(J, B=JB, **kw)
    return request.param, A, ours, ref


def test_blocked_hierarchy_matches_jax_level_by_level(pair):
    case, A, ours, ref = pair
    assert_blocked_hierarchies_match(ours, ref)
    lvl0 = ours.levels[0]
    assert len(ours.levels) >= 2
    if case.startswith("bsr-grid"):
        # structured K-candidate path: the smoother S of the transfers is
        # SparseBDIA, A is flattened to scalar diagonals
        assert hasattr(lvl0, "struct_meta")
        assert lvl0.struct_meta["q"] == 2
        assert [type(o).__name__ for o in lvl0.P.ops] == \
            ["SparseBDIA", "GridRepeatOp"]
        assert type(lvl0.A).__name__ == "SparseDIA"
        assert ours.levels[1].blocksize == lvl0.B.shape[1]
    elif case == "csr-rbm":
        assert lvl0.blocksize == 1 and lvl0.A_bsr is None
        assert ours.levels[1].blocksize == 3
    else:
        assert lvl0.blocksize == 2 and not hasattr(lvl0, "struct_meta")
        # K = 3 on q = 2: no aggregate-root embedding at level 0
        assert getattr(lvl0, "root_dofs", None) is None
    sm = lvl0.presmoother
    expect = 1 if case == "csr-rbm" else 2
    assert sm.blocksize == expect or sm.kind == "gauss_seidel"


def test_blocked_cg_iterations_match_jax(pair):
    _case, A, ours, ref = pair
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    it = _cg_iterations(ours, b)
    assert it == _cg_iterations(ref, b)
    assert it <= 30


def test_blocked_default_without_host_libraries(monkeypatch):
    """Both host libraries off: the Python forms build the same
    hierarchy in both packages."""
    A, B = linear_elasticity((18, 18))
    J, JB = jax_elasticity((18, 18))
    monkeypatch.setattr(amg_core, "_lib", False)
    monkeypatch.setattr(jax_core, "_lib", False)
    kw = dict(B=B, max_coarse=30)
    ours = pyamg_tpu_torch.smoothed_aggregation_solver(
        sp.bsr_matrix(A.tocoo().tocsr(), blocksize=(2, 2)), device="cpu",
        **kw)
    ref = pyamg_tpu.smoothed_aggregation_solver(
        sp.bsr_matrix(J.tocoo().tocsr(), blocksize=(2, 2)), B=JB,
        max_coarse=30)
    assert not amg_core.have_native() and not jax_core.have_native()
    assert_blocked_hierarchies_match(ours, ref)
    b = np.random.default_rng(1).standard_normal(A.shape[0])
    assert _cg_iterations(ours, b) == _cg_iterations(ref, b)


def test_blocked_levels_smoothers_and_options():
    """Block Gauss-Seidel with bs = 2 at level 0 and bs = 3 below on the
    device; the warning past 5 candidates; the evolution measure on a BSR
    operator with its candidates (it raised until the classical slice
    ported it) builds the JAX package's hierarchy."""
    A, B = linear_elasticity((15, 15))
    Ab = sp.bsr_matrix(A.tocoo().tocsr(), blocksize=(2, 2))
    ml = pyamg_tpu_torch.smoothed_aggregation_solver(
        Ab, B=B, max_coarse=10, device="cpu")
    ref = _jax_sa(sp.bsr_matrix(A.tocoo().tocsr(), blocksize=(2, 2)), B=B,
                  max_coarse=10)
    assert [lvl.presmoother.blocksize for lvl in ml.levels[:-1]] == \
        [2] + [3] * (len(ml.levels) - 2)
    for lo, lr in zip(ml.levels[:-1], ref.levels[:-1]):
        assert_same_smoother(lo.presmoother, lr.presmoother)
        assert_same_smoother(lo.postsmoother, lr.postsmoother)
    x = torch.zeros(A.shape[0], dtype=torch.float64)
    b = torch.from_numpy(np.random.default_rng(2).standard_normal(
        A.shape[0]))
    from pyamg_tpu_torch.relaxation.device import apply_smoother

    x1 = apply_smoother(ml.levels[0].presmoother, ml.levels[0].A, x, b)
    r0 = float(torch.linalg.norm(b))
    assert float(torch.linalg.norm(b - ml.levels[0].A.matvec(x1))) < r0
    B6 = np.column_stack([B, B[:, ::-1] * 1.5 + 0.1])
    with pytest.warns(UserWarning, match="5 candidates"):
        pyamg_tpu_torch.smoothed_aggregation_solver(
            Ab, B=B6, max_coarse=1000, device="cpu")
    ml = pyamg_tpu_torch.smoothed_aggregation_solver(
        Ab, B=B, strength="evolution", max_coarse=10, device="cpu")
    ref = _jax_sa(sp.bsr_matrix(A.tocoo().tocsr(), blocksize=(2, 2)), B=B,
                  strength="evolution", max_coarse=10)
    assert [lvl.A_csr.shape for lvl in ml.levels] == \
        [lvl.A_csr.shape for lvl in ref.levels]
    for lo, lr in zip(ml.levels, ref.levels):
        assert abs(lo.A_csr - lr.A_csr).max() <= 1e-10 * abs(lr.A_csr).max()


def test_blocked_astype_and_float32_operators():
    """Float32 operators from the float64 setup: ``solve_mp`` reaches a
    float64 relres of 1e-10; ``astype`` casts the device operators (the
    BDIA smoothers too) and leaves the BSR twins as they are."""
    A, B = linear_elasticity((12, 12))
    ml = pyamg_tpu_torch.smoothed_aggregation_solver(
        A, B=B, max_coarse=20, op_dtype=torch.float32, device="cpu")
    assert all(lvl.A.dtype == torch.float32 for lvl in ml.levels)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    x, info = ml.solve_mp(b, tol=1e-10, return_info=True)
    assert x.dtype == torch.float64 and info["rounds"] >= 1
    assert np.linalg.norm(b - A @ x.numpy()) <= 1e-9 * np.linalg.norm(b)
    ml.astype(torch.float64)
    S = ml.levels[0].P.ops[0]
    assert isinstance(S, SparseBDIA) and S.dtype == torch.float64
    assert ml.levels[0].A.dtype == torch.float64
    assert ml.levels[0].A_bsr.blocksize == (2, 2)
    assert ml.levels[0].A_bsr.dtype == np.float64
