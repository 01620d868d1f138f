"""The port's padded ELL and masked SpGEMM against the JAX package's.

The plain PyTorch twin of the two masked-SpGEMM kernels
(``masked_matmul_vals_plain``, behind ``masked_spgemm_ell``) is held
against the Pallas kernels K4 (banded) and K5 (one-hot), run in the Pallas
interpreter as tests/test_pallas.py runs them, on the same cases
(tests/spgemm_cases.py draws them as that file does), and
against the JAX package's exact XLA formulation.  Tolerances, relative to
the largest value of the reference product:

* K4 is exact float32 arithmetic: 1e-6 (summation order only);
* K5 contracts in three bf16 passes: 5e-5 (its own tests' bound);
* the JAX XLA form: 1e-6 in float32, 1e-12 in float64;
* on slabs wider than 64 slots, the plain-PyTorch reference
  (``amgbench/reference/masked_product.py``, a dense product a block of
  rows at a time): 1e-12 in float64, 1e-6 in float32.

The CUDA kernels themselves run only on the card
(tests/test_torch_kernel.py); here every wrapper takes its CPU branch.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from amgbench.reference.masked_product import masked_product
from pyamg_tpu.gallery import poisson
from pyamg_tpu.sparse import spgemm_dia as jax_spd
from pyamg_tpu.sparse import spgemm_pallas as jax_spp
from pyamg_tpu.sparse.ell import SparseELL as JaxELL
from pyamg_tpu.sparse.spgemm_device import ell_transpose_onto as jax_transpose
from pyamg_tpu.sparse.spgemm_device import masked_spgemm_ell as jax_mm
from pyamg_tpu.sparse.spgemm_device import pattern_spgemm as jax_pattern
from pyamg_tpu.sparse.spgemm_device import rap_pattern as jax_rap_pattern
from pyamg_tpu_torch.sparse import SparseELL, device_operator, spgemm_kernel
from pyamg_tpu_torch.sparse.ell import ell_matvec
from pyamg_tpu_torch.sparse.spgemm_device import (ell_transpose_onto,
                                                  masked_spgemm_auto,
                                                  masked_spgemm_ell,
                                                  pattern_spgemm, rap_pattern,
                                                  sentinel_cols)
from pyamg_tpu_torch.sparse.spgemm_dia import BandedSpgemmPlan
from pyamg_tpu_torch.sparse.spgemm_kernel import (MAX_SHARED_BYTES, TILE_ROWS,
                                                  shared_bytes, tile_geometry)
from spgemm_cases import (BANDED, EDGES, GENERAL, NOT_BANDED, WIDE, banded,
                          irregular, near_band)

torch.set_num_threads(1)


def _ell(M, dtype):
    return SparseELL.from_scipy(M, dtype=dtype, device="cpu")


def _jell(M, dtype):
    return JaxELL.from_scipy(M, dtype=dtype)


def _rel(out, ref):
    o = np.asarray(out, dtype=np.float64)
    r = np.asarray(ref, dtype=np.float64)
    return np.abs(o - r).max() / (np.abs(r).max() or 1.0)


@pytest.fixture
def k4_interpret():
    jax_spd._INTERPRET[0] = True
    yield
    jax_spd._INTERPRET[0] = False


@pytest.fixture
def k5_interpret():
    jax_spp._INTERPRET[0] = True
    yield
    jax_spp._INTERPRET[0] = False


# ---------------------------------------------------------------------------
# the twin against K4 and K5 in the Pallas interpreter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(BANDED))
def test_twin_matches_k4_interpret(case, k4_interpret):
    A_csr, B_csr = BANDED[case]()
    jA, jB = _jell(A_csr, np.float32), _jell(B_csr, np.float32)
    jpat = jax_pattern(A_csr, B_csr, dtype=np.float32)
    jplan = jax_spd.BandedSpgemmPlan(jA, jB, jpat)
    assert jplan.feasible, jplan.describe()
    k4 = jplan(jA, jB)

    A, B = _ell(A_csr, np.float32), _ell(B_csr, np.float32)
    pat = pattern_spgemm(A_csr, B_csr, dtype=np.float32, device="cpu")
    plan = BandedSpgemmPlan(A, B, pat)
    assert plan.feasible and plan.offsets == jplan.offsets
    twin = masked_spgemm_ell(A, B, pat)
    assert _rel(twin.data, k4.data) <= 1e-6
    # the banded plan on a CPU tensor runs the twin
    assert torch.equal(plan(A, B).data, twin.data)


@pytest.mark.parametrize("case", sorted(GENERAL))
def test_twin_matches_k5_interpret(case, k5_interpret):
    A_csr, B_csr = GENERAL[case]()
    jA, jB = _jell(A_csr, np.float32), _jell(B_csr, np.float32)
    jpat = jax_pattern(A_csr, B_csr, dtype=np.float32)
    jplan = jax_spp.MaskedSpgemmPlan(jA, jB, jpat, T=64, Wc=64)
    assert jplan.feasible
    k5 = jplan(jA, jB)

    A, B = _ell(A_csr, np.float32), _ell(B_csr, np.float32)
    pat = pattern_spgemm(A_csr, B_csr, dtype=np.float32, device="cpu")
    twin = masked_spgemm_ell(A, B, pat)
    assert _rel(twin.data, k5.data) <= 5e-5
    # the gather kernel's wrapper on a CPU tensor runs the twin
    out = spgemm_kernel.masked_spgemm_gather(A.data, A.cols, B.data, B.cols,
                                             sentinel_cols(pat))
    assert torch.equal(out, twin.data)


def test_twin_matches_k5_interpret_on_a_galerkin_chain(k5_interpret):
    from pyamg_tpu.classical.classical import ruge_stuben_solver

    A_csr = sp.csr_matrix(poisson((24, 24), format="csr"))
    ml = ruge_stuben_solver(A_csr, max_levels=2, max_coarse=10)
    P_csr = sp.csr_matrix(ml.levels[0].P_csr if hasattr(ml.levels[0], "P_csr")
                          else ml.levels[0].P)
    R_csr = sp.csr_matrix(P_csr.T)
    R_csr.sort_indices()
    jA, jP, jR = (_jell(M, np.float32) for M in (A_csr, P_csr, R_csr))
    jpAP, jpRAP = jax_rap_pattern(R_csr, A_csr, P_csr, dtype=np.float32)
    jAP = jax_spp.MaskedSpgemmPlan(jA, jP, jpAP, T=64, Wc=64)(jA, jP)
    k5 = jax_spp.MaskedSpgemmPlan(jR, jpAP, jpRAP, T=64, Wc=64)(jR, jAP)

    A, P, R = (_ell(M, np.float32) for M in (A_csr, P_csr, R_csr))
    pAP, pRAP = rap_pattern(R_csr, A_csr, P_csr, dtype=np.float32,
                             device="cpu")
    np.testing.assert_array_equal(pRAP.cols.numpy(), np.asarray(jpRAP.cols))
    AP = masked_spgemm_ell(A, P, pAP)
    RAP = masked_spgemm_ell(R, AP, pRAP)
    assert _rel(RAP.data, k5.data) <= 5e-5
    exact = R_csr @ A_csr @ P_csr
    got = RAP.to_scipy().astype(np.float64)
    assert abs(got - exact).max() / abs(exact).max() <= 1e-6


# ---------------------------------------------------------------------------
# the twin against the JAX XLA formulation, in float32 and float64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6), (np.float64, 1e-12)])
@pytest.mark.parametrize("case", ["5pt", "wideA", "rectangular",
                                  "multichunk"])
def test_twin_matches_jax_masked_spgemm_ell(case, dtype, tol):
    A_csr, B_csr = {**BANDED, **GENERAL}[case]()
    jpat = jax_pattern(A_csr, B_csr, dtype=dtype)
    ref = jax_mm(_jell(A_csr, dtype), _jell(B_csr, dtype), jpat)
    pat = pattern_spgemm(A_csr, B_csr, dtype=dtype, device="cpu")
    np.testing.assert_array_equal(pat.cols.numpy(), np.asarray(jpat.cols))
    np.testing.assert_array_equal(pat.row_nnz.numpy(),
                                  np.asarray(jpat.row_nnz))
    out = masked_spgemm_ell(_ell(A_csr, dtype), _ell(B_csr, dtype), pat)
    assert out.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
    assert _rel(out.data, ref.data) <= tol


# ---------------------------------------------------------------------------
# the edges of the tiled kernels: the twin against K4 in the Pallas
# interpreter where its plan takes A, and against the XLA form always
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6), (np.float64, 1e-12)])
@pytest.mark.parametrize("case", sorted(EDGES))
def test_twin_matches_jax_on_tile_edges(case, dtype, tol):
    A_csr, B_csr = EDGES[case]()
    jpat = jax_pattern(A_csr, B_csr, dtype=dtype)
    ref = jax_mm(_jell(A_csr, dtype), _jell(B_csr, dtype), jpat)
    A, B = _ell(A_csr, dtype), _ell(B_csr, dtype)
    pat = pattern_spgemm(A_csr, B_csr, dtype=dtype, device="cpu")
    np.testing.assert_array_equal(pat.cols.numpy(), np.asarray(jpat.cols))
    twin = masked_spgemm_ell(A, B, pat)
    assert _rel(twin.data, ref.data) <= tol
    if dtype == np.float64:
        exact = (A_csr @ B_csr).tocsr()
        assert abs(twin.to_scipy() - exact).max() <= tol * abs(exact).max()
    # both wrappers on CPU tensors run the twin
    slabs = (A.data, A.cols, B.data, B.cols, sentinel_cols(pat))
    assert torch.equal(spgemm_kernel.masked_spgemm_gather(*slabs), twin.data)
    plan = BandedSpgemmPlan(A, B, pat)
    assert plan.feasible == (case not in NOT_BANDED)
    if plan.feasible:
        assert torch.equal(plan(A, B).data, twin.data)


@pytest.mark.parametrize("case", sorted(set(EDGES) - NOT_BANDED))
def test_twin_matches_k4_interpret_on_tile_edges(case, k4_interpret):
    A_csr, B_csr = EDGES[case]()
    jA, jB = _jell(A_csr, np.float32), _jell(B_csr, np.float32)
    jplan = jax_spd.BandedSpgemmPlan(jA, jB, jax_pattern(A_csr, B_csr,
                                                         dtype=np.float32))
    A, B = _ell(A_csr, np.float32), _ell(B_csr, np.float32)
    pat = pattern_spgemm(A_csr, B_csr, dtype=np.float32, device="cpu")
    plan = BandedSpgemmPlan(A, B, pat)
    twin = masked_spgemm_ell(A, B, pat)
    if not jplan.feasible:
        # the TPU plan's caps refuse 64 offsets; K4 cannot run it
        assert case == "band64" and plan.offsets == tuple(range(-32, 32))
        return
    assert plan.offsets == jplan.offsets
    assert _rel(twin.data, jplan(jA, jB).data) <= 1e-6


@pytest.mark.parametrize("case", ["alias", "tile_plus_one"])
def test_alias_cases_put_padding_on_a_stored_column(case):
    # a padding slot of B's row j names column j, which row j stores; every
    # row i of A with A[i, j] != 0 then has column j in its pattern, so the
    # padding lane and the real lane of one step meet in one output slot
    A_csr, B_csr = EDGES[case]()
    B = _ell(B_csr, np.float64)
    padded = (B.row_nnz < B.width).numpy()
    stored = B_csr.diagonal() != 0
    assert (padded & stored).sum() > B.shape[0] // 2
    pat = pattern_spgemm(A_csr, B_csr, device="cpu").to_scipy()
    rows, cols = A_csr.nonzero()
    hit = padded[cols] & stored[cols]
    assert np.all(pat[rows[hit], cols[hit]] != 0)


# ---------------------------------------------------------------------------
# slabs wider than 64 slots: the twin against the plain reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6), (np.float64, 1e-12)])
@pytest.mark.parametrize("case", sorted(WIDE))
def test_twin_matches_the_plain_reference_on_wide_slabs(case, dtype, tol):
    A_csr, B_csr = WIDE[case]()
    A, B = _ell(A_csr, dtype), _ell(B_csr, dtype)
    pat = pattern_spgemm(A_csr, B_csr, dtype=dtype, device="cpu")
    widths = (A.width, B.width, pat.width)
    if case == "wide_gather":
        assert min(widths) > 64
    elif case == "wide_banded":
        assert min(widths[1:]) > 64
    elif case == "p27_rap":
        assert widths == (125, 27, 27)
    slabs = (A.data, A.cols, B.data, B.cols, sentinel_cols(pat))
    twin = masked_spgemm_ell(A, B, pat)
    ref = masked_product(*slabs)
    assert ref.dtype == torch.float64
    assert _rel(twin.data, ref) <= tol
    if dtype == np.float64:
        exact = (A_csr @ B_csr).tocsr()
        assert abs(twin.to_scipy() - exact).max() <= tol * abs(exact).max()
    # the wrappers and the router on CPU tensors run the twin; the banded
    # plan takes a banded A at these widths
    assert torch.equal(spgemm_kernel.masked_spgemm_gather(*slabs), twin.data)
    plan = BandedSpgemmPlan(A, B, pat)
    assert plan.feasible == (case not in NOT_BANDED)
    if plan.feasible:
        assert torch.equal(plan(A, B).data, twin.data)
    assert torch.equal(masked_spgemm_auto(A, B, pat).data, twin.data)


def test_plain_reference_reads_padding_and_empty_rows_as_zero():
    A_csr, B_csr = EDGES["empty_rows"]()
    A, B = _ell(A_csr, np.float64), _ell(B_csr, np.float64)
    pat = pattern_spgemm(A_csr, B_csr, dtype=np.float64, device="cpu")
    ref = masked_product(A.data, A.cols, B.data, B.cols, sentinel_cols(pat),
                         block=7)
    assert _rel(ref, masked_spgemm_ell(A, B, pat).data) <= 1e-12
    assert not ref[~pat.valid_mask()].any()


# ---------------------------------------------------------------------------
# the tiled kernels' launch geometry
# ---------------------------------------------------------------------------

def _widest_square(itemsize, k):
    """The widest w such that A and the pattern w slots wide fit a tile of
    one row."""
    lo, hi = 1, 1 << 16
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if shared_bytes(1, mid, mid, itemsize, k) <= MAX_SHARED_BYTES:
            lo = mid
        else:
            hi = mid - 1
    return lo


@pytest.mark.parametrize("itemsize", [4, 8])
def test_tile_geometry_fits_every_width(itemsize):
    # B is not staged, so w_b only sets the lanes a row; k = 64 is the
    # banded kernel's widest case, k = 0 the gather kernel's.  Up to 64
    # slots a tile of 16 rows or more fits within the target; past that
    # the tile shrinks, below 16 rows only where 16 would not fit a block
    for w_b, k, n in ((1, 0, 1 << 20), (64, 64, 1000), (125, 0, 41_600)):
        top = _widest_square(itemsize, k)
        widths = list(range(1, 65)) + list(range(65, top, 97)) + [top]
        for w_a in widths:
            for w_out in widths:
                g = tile_geometry(n, w_a, w_b, w_out, itemsize, k)
                assert g.shared_bytes <= MAX_SHARED_BYTES
                assert g.shared_bytes == shared_bytes(g.rows, w_a, w_out,
                                                      itemsize, k)
                if max(w_a, w_out) <= 64:
                    assert g.rows in TILE_ROWS
                elif g.rows not in TILE_ROWS:
                    assert g.rows & (g.rows - 1) == 0 and shared_bytes(
                        2 * g.rows, w_a, w_out, itemsize, k) > \
                        MAX_SHARED_BYTES
                assert g.blocks <= g.tiles
                assert g.threads % 32 == 0 and g.threads <= 256
        # one slot more than a tile of one row holds
        with pytest.raises(ValueError, match="shared memory"):
            tile_geometry(n, top + 1, w_b, top + 1, itemsize, k)
    # R = 64 fits the widest case on its own
    assert shared_bytes(64, 64, 64, 8, 64) <= MAX_SHARED_BYTES
    # R (A P) of the 27-point operator at 104^3: 42,875 rows of R 125
    # slots wide, A P and the pattern 27: tiles of 16 rows, four lanes a row
    g = tile_geometry(42_875, 125, 27, 27, itemsize)
    assert (g.rows, g.lanes) == (16, 4)


def test_tile_geometry_gives_few_rows_more_lanes():
    # the level-0 products of the 1M setup: a thread walks its row alone
    assert tile_geometry(1 << 20, 5, 4, 6, 4, 5).lanes == 1
    assert tile_geometry(175104, 15, 6, 10, 4).lanes == 1
    # coarse levels: more lanes a row, up to B's width, in one pass
    g = tile_geometry(2154, 38, 9, 18, 4)
    assert g.lanes == 16 and g.rows * g.lanes <= 256 and g.tiles >= 132
    assert tile_geometry(219, 22, 1, 5, 4).lanes == 1


@pytest.mark.parametrize("shape", [(15, 6, 10, 4, 0), (5, 4, 6, 4, 5),
                                   (64, 64, 64, 8, 64), (3, 9, 1, 8, 3)])
def test_tile_geometry_covers_every_row_once(shape):
    w_a, w_b, w_out, itemsize, k = shape
    R = tile_geometry(1 << 20, w_a, w_b, w_out, itemsize, k).rows
    for n in (1, R - 1, R, R + 1, (1 << 20) + 3):
        for sms in (132, 3):
            g = tile_geometry(n, w_a, w_b, w_out, itemsize, k, sms=sms)
            seen = np.zeros(n, dtype=np.int64)
            for block in range(g.blocks):
                for rows in g.block_rows(block):
                    assert 0 < len(rows) <= g.rows
                    seen[rows.start:rows.stop] += 1
            assert (seen == 1).all(), (n, sms)


def test_wrappers_raise_on_a_geometry_that_does_not_fit(monkeypatch):
    A_csr, B_csr = EDGES["alias"]()
    A, B = _ell(A_csr, np.float32), _ell(B_csr, np.float32)
    pat = sentinel_cols(pattern_spgemm(A_csr, B_csr, device="cpu"))
    # a block too small for a tile of one row of these slabs
    monkeypatch.setattr(spgemm_kernel, "MAX_SHARED_BYTES", 64)
    before = (dict(spgemm_kernel.launches), spgemm_kernel.plain_cuda_calls,
              spgemm_kernel._lib)
    with pytest.raises(ValueError, match="shared memory"):
        spgemm_kernel.masked_spgemm_gather(A.data, A.cols, B.data, B.cols,
                                           pat)
    with pytest.raises(ValueError, match="shared memory"):
        spgemm_kernel.masked_spgemm_banded(A.data, A.cols, B.data, B.cols,
                                           pat, (-2, -1, 0, 1, 2))
    assert (dict(spgemm_kernel.launches), spgemm_kernel.plain_cuda_calls,
            spgemm_kernel._lib) == before


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6), (np.float64, 0)])
def test_transpose_onto_matches_jax(dtype, tol):
    P_csr = near_band(400, 130, 3, per_row=3, seed=5)
    patR = jax_pattern(sp.csr_matrix(P_csr.T), sp.identity(400), dtype=dtype)
    ref = jax_transpose(_jell(P_csr, dtype), patR)
    ours = ell_transpose_onto(_ell(P_csr, dtype),
                              pattern_spgemm(P_csr.T, sp.identity(400),
                                             dtype=dtype, device="cpu"))
    assert _rel(ours.data, ref.data) <= tol
    assert abs(ours.to_scipy() - P_csr.T).max() <= 1e-6 * abs(P_csr).max()


# ---------------------------------------------------------------------------
# plans and the router
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["5pt", "9pt", "63_offsets", "121_offsets",
                                  "irregular_left"])
def test_banded_feasibility_agrees_with_jax(case):
    if case == "irregular_left":         # test_infeasible_irregular_left
        A_csr = irregular(800, 0.01, seed=0)
        B_csr = A_csr
    elif case.endswith("_offsets"):      # 3 entries a row, offsets |d| < bw
        bw = {"63_offsets": 31, "121_offsets": 60}[case]
        A_csr = near_band(3000, 3000, bw, per_row=3, seed=3)
        B_csr = near_band(3000, 3000, 2, per_row=2, seed=4)
    else:
        A_csr, B_csr = BANDED[case]()
    jplan = jax_spd.BandedSpgemmPlan(
        _jell(A_csr, np.float32), _jell(B_csr, np.float32),
        jax_pattern(A_csr, B_csr, dtype=np.float32))
    A, B = _ell(A_csr, np.float32), _ell(B_csr, np.float32)
    plan = BandedSpgemmPlan(A, B, pattern_spgemm(A_csr, B_csr,
                                                   device="cpu"))
    assert plan.feasible == jplan.feasible
    if not plan.feasible:
        with pytest.raises(ValueError, match="infeasible"):
            plan(A, B)


def test_banded_probe_rejects_a_large_irregular_left_operand():
    # more than 16384 rows: the 4096-row sample alone has > 64 offsets
    A_csr = near_band(20000, 20000, 5000, per_row=3, seed=1)
    A = _ell(A_csr, np.float64)
    assert not BandedSpgemmPlan(
        A, A, pattern_spgemm(A_csr, A_csr, device="cpu")).feasible


def test_plans_refuse_slabs_wider_than_64():
    # slabs 70 wide, once refused, are taken; a banded A whose pattern is
    # one slot wider than a one-row tile holds is refused by the plan and
    # by both kernels, at one slot fewer taken
    A_csr = sp.csr_matrix(np.ones((4, 70)))
    B_csr = sp.csr_matrix(np.ones((70, 3)))
    A, B = _ell(A_csr, np.float32), _ell(B_csr, np.float32)
    pat = pattern_spgemm(A_csr, B_csr, device="cpu")
    assert not BandedSpgemmPlan(A, B, pat).feasible      # 70 offsets
    slabs = (A.data, A.cols, B.data, B.cols, sentinel_cols(pat))
    assert torch.equal(spgemm_kernel.masked_spgemm_gather(*slabs),
                       masked_spgemm_ell(A, B, pat).data)
    top = max(w for w in range(1, 1 << 16)
              if shared_bytes(1, 1, w, 4, 1) <= MAX_SHARED_BYTES
              and w % 64 == 0)
    for w, fits in ((top, True), (top + 64, False)):
        I_csr = sp.identity(2, format="csr")
        D_csr = sp.csr_matrix(np.ones((2, w)))
        I, D = _ell(I_csr, np.float32), _ell(D_csr, np.float32)
        pat = pattern_spgemm(I_csr, D_csr, device="cpu")
        assert pat.width == w
        assert BandedSpgemmPlan(I, D, pat).feasible == fits
        slabs = (I.data, I.cols, D.data, D.cols, sentinel_cols(pat))
        if fits:
            assert torch.equal(spgemm_kernel.masked_spgemm_banded(
                *slabs, (0,)), D.data)
            continue
        with pytest.raises(ValueError, match="shared memory"):
            spgemm_kernel.masked_spgemm_gather(*slabs)
        with pytest.raises(ValueError, match="shared memory"):
            spgemm_kernel.masked_spgemm_banded(*slabs, (0,))


def test_router_on_cpu_runs_the_twin_and_launches_nothing():
    A_csr, B_csr = BANDED["5pt"]()
    A, B = _ell(A_csr, np.float64), _ell(B_csr, np.float64)
    pat = pattern_spgemm(A_csr, B_csr, dtype=np.float64, device="cpu")
    before = (dict(spgemm_kernel.launches), spgemm_kernel._lib)
    out = masked_spgemm_auto(A, B, pat)
    assert (dict(spgemm_kernel.launches), spgemm_kernel._lib) == before
    assert torch.equal(out.data, masked_spgemm_ell(A, B, pat).data)


@pytest.mark.parametrize("bad", ["dtype_mix", "int64_cols", "wide",
                                 "offsets", "unsorted_offsets",
                                 "noncontiguous", "meta"])
def test_wrapper_argument_checks(bad):
    A_csr = banded(50, [-1, 0, 1], seed=0)
    A = _ell(A_csr, np.float32)
    Ad, Ac = A.data, A.cols
    pat = sentinel_cols(pattern_spgemm(A_csr, A_csr, device="cpu"))
    Bd, Bc, offsets = Ad, Ac, (-1, 0, 1)
    err = ValueError
    if bad == "dtype_mix":
        Bd, err = Ad.double(), TypeError
    elif bad == "int64_cols":
        Ac, err = Ac.long(), TypeError
    elif bad == "wide":
        # one slot wider than a tile of one row holds, beside this pattern
        w = next(w for w in range(1, 1 << 16)
                 if shared_bytes(1, w, pat.shape[1], 4, 0)
                 > MAX_SHARED_BYTES)
        Ad = torch.zeros((50, w))
        Ac = torch.zeros((50, w), dtype=torch.int32)
    elif bad == "offsets":
        offsets = tuple(range(65))
    elif bad == "unsorted_offsets":
        offsets = (0, -1, 1)
    elif bad == "noncontiguous":
        pat = pat.t().contiguous().t()
    else:
        Ad, Ac, Bd, Bc, pat = (t.to("meta") for t in (Ad, Ac, Bd, Bc, pat))
    with pytest.raises(err):
        spgemm_kernel.masked_spgemm_banded(Ad, Ac, Bd, Bc, pat, offsets)
    if not bad.endswith("offsets"):
        with pytest.raises(err):
            spgemm_kernel.masked_spgemm_gather(Ad, Ac, Bd, Bc, pat)


# ---------------------------------------------------------------------------
# SparseELL and the device-format chooser
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(60, 60), (90, 31), (31, 90)])
def test_ell_matches_jax_and_scipy(shape):
    M = near_band(shape[0], shape[1], 4, per_row=4, seed=3)
    M.data[M.indptr[3]:M.indptr[4]] = 0       # an empty row
    M.eliminate_zeros()
    E, J = _ell(M, np.float64), _jell(M, np.float64)
    for ours, ref in ((E.data, J.data), (E.cols, J.cols),
                      (E.row_nnz, J.row_nnz), (E.valid_mask(),
                                               J.valid_mask())):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(E.diagonal().numpy(),
                                  np.asarray(J.diagonal()))
    assert E.nnz == J.nnz == M.nnz and E.width == J.width
    assert abs(E.to_scipy() - M).max() == 0
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal(shape[1]), rng.standard_normal(shape[0])
    np.testing.assert_allclose(E.matvec(torch.as_tensor(x)).numpy(), M @ x,
                               rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(E.rmatvec(torch.as_tensor(y)).numpy(),
                               M.T @ y, rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(
        ell_matvec(E.data, E._cols_in_range(), torch.as_tensor(x)).numpy(),
        np.asarray(J.matvec(x)), rtol=1e-14, atol=1e-14)
    assert E.astype(torch.float32).dtype == torch.float32


def test_wide_offset_operator_gets_ell():
    # 2000 rows, > 512 distinct diagonals, too big for the dense form
    M = near_band(5000, 5000, 2000, per_row=3, seed=2)
    op = device_operator(M, dtype=np.float64, device="cpu")
    assert isinstance(op, SparseELL)
    x = np.random.default_rng(1).standard_normal(5000)
    np.testing.assert_allclose(op.matvec(torch.as_tensor(x)).numpy(), M @ x,
                               rtol=1e-12, atol=1e-12)
    from pyamg_tpu.sparse import device_operator as jax_device_operator
    assert type(jax_device_operator(M)).__name__ == "SparseELL"
