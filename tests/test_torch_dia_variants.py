"""The DIA SpMV variants of the port against the JAX package's kernels.

The same numpy inputs go through ``pyamg_tpu``'s Pallas kernels (in
interpret mode where the kernel has one) or its plain ``matvec_xla``, and
through the twins of the port's kernels on the CPU:

* ``dia_matvec_v2_plain`` (the Hopper kernel's floor split, lane rolls and
  select) against ``dia_matvec_pallas_v2(..., interpret=True)``, 1e-5
  absolute as tests/test_pallas.py holds the Pallas kernel;
* ``dia_matvec_v1_plain`` (the padded copy) against ``matvec_xla``: the TPU
  kernel ``dia_matvec_pallas_v1`` has no interpret mode, so its plain
  reference is the oracle;
* bfloat16 diagonals with a float32 x through ``dia_kernel`` against
  ``dia_matvec_pallas(..., interpret=True)`` on the same pair, 1e-6
  relative (both take each product and sum in float32, in offset order);
* ``dia_kernel`` on the short, wide operators of ``dia_cases.WIDE`` (the
  shapes of the kernel's wide route), every route, against
  ``matvec_xla`` bit for bit and the Pallas K1 in interpret mode.

Then the wrappers' refusals, the DIA benchmark's problem and byte counts
at a small grid, and the route sweep's operators.  The CUDA kernels
themselves are held against their twins in test_torch_kernel.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyamg_tpu.sparse import SparseDIA as JaxDIA
from pyamg_tpu.sparse.pallas_kernels import _plan as jax_plan
from pyamg_tpu.sparse.pallas_kernels import (dia_matvec_pallas,
                                             dia_matvec_pallas_v2)
from pyamg_tpu_torch.benchmarks import dia_route_sweep, dia_spmv_bench
from pyamg_tpu_torch.gallery import poisson
from pyamg_tpu_torch.sparse import SparseDIA, dia_kernel, dia_variants

import dia_cases

torch.set_num_threads(1)


V2_CASES = ["lane_multiples", "pallas300x257", "wide"]
V1_CASES = ["margin", "pallas300x257", "poisson512", "poisson70001"]


def _x(n, seed):
    return np.random.default_rng(seed).random(n).astype(np.float32)


def _jax_f32(A):
    return JaxDIA.from_scipy(A).astype(jnp.float32)


def _ours(A, dtype=np.float32):
    return SparseDIA.from_scipy(A, dtype=dtype, device="cpu")


@pytest.mark.parametrize("case", V2_CASES)
def test_v2_twin_matches_pallas_v2_interpret(case):
    A = dia_cases.ALL[case]()
    x = _x(A.shape[0], 2)
    J = _jax_f32(A)
    y_ref = np.asarray(dia_matvec_pallas_v2(J.diags, J.offsets,
                                            jnp.asarray(x), interpret=True))
    D = _ours(A)
    assert D.offsets == J.offsets
    y = dia_variants.dia_matvec_v2(D.diags, D.offsets, torch.from_numpy(x))
    assert y.dtype == torch.float32
    assert np.abs(y.numpy() - y_ref).max() < 1e-5


def test_v2_plan_takes_the_tpu_kernels_halo():
    for offsets in [(-257, -127, -1, 0, 1, 5, 257, 258), (-1, 0, 1),
                    (-256, 0, 256), (-4096, -1, 0, 1, 4096),
                    (-5000, 0, 129)]:
        halo, rows = dia_variants.plan_v2(offsets)
        assert halo == jax_plan(offsets, len(offsets), jnp.float32)[1]
        assert rows == dia_variants.ROWS
        assert (rows + 2 * halo) * dia_variants.LANES * 4 \
            <= dia_variants.SMEM_BYTES


def test_v2_plan_refuses_a_halo_beyond_shared_memory():
    # +-16256 and 16255 lie 127 rows away: a halo of 128 rows, the widest
    # that a block's shared memory holds beside its 32 rows
    halo, rows = dia_variants.plan_v2((-16256, -1, 0, 1, 16255, 16256))
    assert (halo, rows) == (128, dia_variants.ROWS)
    assert (rows + 2 * halo) * dia_variants.LANES * 4 \
        <= dia_variants.SMEM_BYTES
    assert (rows + 4 * halo) * dia_variants.LANES * 4 \
        > dia_variants.SMEM_BYTES
    for off in (16257, -16255, -16257, 30000):
        with pytest.raises(ValueError, match="shared memory"):
            dia_variants.plan_v2((-1, 0, 1, off))


def test_v2_wrapper_refuses_offsets_beyond_the_widest_window():
    A = dia_cases.with_diagonals(poisson((20001,), format="csr"),
                                 [(16257, 0.5)])
    D = _ours(A)
    x = torch.from_numpy(_x(A.shape[0], 4))
    for fn in (dia_variants.dia_matvec_v2, dia_variants.dia_matvec_v2_plain):
        with pytest.raises(ValueError, match="shared memory"):
            fn(D.diags, D.offsets, x)
    y = dia_variants.dia_matvec_v1(D.diags, D.offsets, x)
    y_ref = np.asarray(_jax_f32(A).matvec_xla(jnp.asarray(x.numpy())))
    assert np.abs(y.numpy() - y_ref).max() < 1e-5


@pytest.mark.parametrize("case", V1_CASES)
def test_v1_twin_matches_matvec_xla(case):
    A = dia_cases.ALL[case]()
    x = _x(A.shape[0], 1)
    y_ref = np.asarray(_jax_f32(A).matvec_xla(jnp.asarray(x)))
    D = _ours(A)
    y = dia_variants.dia_matvec_v1(D.diags, D.offsets, torch.from_numpy(x))
    assert y.dtype == torch.float32
    assert np.abs(y.numpy() - y_ref).max() < 1e-5


def test_v1_padded_copy_is_as_wide_as_the_farthest_offset():
    x = torch.arange(1.0, 6.0)
    xpad, halo = dia_variants._padded(x, (-3, 0, 2))
    assert halo == 3
    assert xpad.tolist() == [0, 0, 0, 1, 2, 3, 4, 5, 0, 0, 0]


@pytest.mark.parametrize("case", ["bench64", "pallas300x257"])
def test_bf16_diagonals_match_pallas_kernel_interpret(case):
    if case == "bench64":
        A = poisson((64, 64), format="csr") / 8.0
    else:
        A = dia_cases.ALL[case]()
    x = _x(A.shape[0], 6)
    J = JaxDIA.from_scipy(A).astype(jnp.bfloat16)
    y_ref = np.asarray(dia_matvec_pallas(J.diags, J.offsets, jnp.asarray(x),
                                         interpret=True))
    assert y_ref.dtype == np.float32
    D = _ours(A)
    Db = SparseDIA(D.diags.to(torch.bfloat16), D.offsets, D.shape)
    np.testing.assert_array_equal(Db.diags.float().numpy(),
                                  np.asarray(J.diags.astype(jnp.float32)))
    y = Db.matvec(torch.from_numpy(x))
    assert y.dtype == torch.float32
    assert np.abs(y.numpy() - y_ref).max() <= 1e-6 * np.abs(y_ref).max()


def test_cpu_tensors_never_load_the_variant_libraries():
    D = _ours(poisson((20, 20), format="csr"))
    x = torch.ones(D.shape[0])
    before = (dict(dia_variants._libs), dict(dia_variants.launches))
    y2 = dia_variants.dia_matvec_v2(D.diags, D.offsets, x)
    y1 = dia_variants.dia_matvec_v1(D.diags, D.offsets, x)
    assert (dict(dia_variants._libs), dict(dia_variants.launches)) == before
    y0 = D.matvec_plain(x)
    assert torch.equal(y1, y0) and torch.equal(y2, y0)


def _refusal(bad):
    D = _ours(poisson((12, 10), format="csr"))
    d, offs, x = D.diags, D.offsets, torch.ones(D.shape[0])
    return {
        "float64": ((d.double(), offs, x.double()), TypeError),
        "bfloat16": ((d.bfloat16(), offs, x), TypeError),
        "rectangular": ((d, offs, torch.ones(D.shape[0] + 1)), ValueError),
        "offset_count": ((d, offs[:-1], x), ValueError),
        "too_many_offsets": ((torch.ones(129, 5), tuple(range(129)),
                              torch.ones(5)), ValueError),
        "strided": ((d, offs, torch.ones(2 * D.shape[0])[::2]), ValueError),
        "meta_device": ((d.to("meta"), offs, x.to("meta")), ValueError),
    }[bad]


@pytest.mark.parametrize("bad", ["float64", "bfloat16", "rectangular",
                                 "offset_count", "too_many_offsets",
                                 "strided", "meta_device"])
@pytest.mark.parametrize("kernel", ["dia_matvec_v2", "dia_matvec_v1"])
def test_variant_wrappers_refuse_what_the_kernels_do_not_take(kernel, bad):
    args, err = _refusal(bad)
    with pytest.raises(err):
        getattr(dia_variants, kernel)(*args)


@pytest.mark.parametrize("pair", [(torch.bfloat16, torch.float64),
                                  (torch.float32, torch.bfloat16),
                                  (torch.bfloat16, torch.bfloat16),
                                  (torch.float64, torch.float32)])
def test_dia_matvec_admits_only_the_bf16_f32_mixed_pair(pair):
    D = _ours(poisson((8, 8), format="csr"))
    with pytest.raises(TypeError):
        dia_kernel.dia_matvec(D.diags.to(pair[0]), D.offsets_dev,
                              torch.ones(D.shape[1], dtype=pair[1]),
                              D.shape[1])


def test_bench_problem_and_byte_counts():
    p = dia_spmv_bench.problem(64, "cpu")
    n, k = 64 * 64, 5
    assert (p.n, p.k, p.D.offsets) == (n, k, (-64, -1, 0, 1, 64))
    assert p.nbytes == (k + 2) * n * 4 and p.nbytes_bf16 == (2 * k + 8) * n
    A = poisson((64, 64), format="csr")
    assert abs(p.D.to_scipy() - A / 8.0).max() == 0
    assert p.Db.diags.dtype == torch.bfloat16 and p.x.dtype == torch.float32
    np.testing.assert_array_equal(
        p.x.numpy(), np.random.default_rng(0).random(n, dtype=np.float32))
    assert p.csr.crow_indices().dtype == torch.int32
    assert p.csr.col_indices().dtype == torch.int32


def test_bench_rows_compute_one_function():
    p = dia_spmv_bench.problem(64, "cpu")
    table = dia_spmv_bench.rows(p)
    assert [kernel for _, kernel, *_ in table] == [
        None, "dia_matvec_v1", "dia_matvec_v2", "dia_matvec", "dia_matvec",
        None]
    y_ref = p.D.to_scipy() @ p.x.numpy().astype(np.float64)
    scale = np.abs(y_ref).max()
    for label, _, step, plain, nbytes in table:
        y = step(p.x)
        assert y.dtype == torch.float32 and y.shape == (p.n,), label
        assert torch.equal(y, plain(p.x)) or label.startswith("cuSPARSE")
        tol = 1e-2 if "bf16" in label else 1e-6           # bf16 diagonals
        assert np.abs(y.numpy() - y_ref).max() <= tol * scale, label
        assert nbytes == (p.nbytes_bf16 if "bf16" in label else p.nbytes)


def test_bench_run_needs_the_card():
    with pytest.raises(ValueError, match="CUDA"):
        dia_spmv_bench.run(64, device="cpu")


# the Pallas K1's cases: square, and few enough offsets for its VMEM plan
# (603 offsets have none)
WIDE_PALLAS = ["wide512x200", "wide219x111", "k1"]


@pytest.mark.parametrize("case", sorted(dia_cases.WIDE))
def test_wide_operators_match_the_jax_kernels(case):
    """dia_matvec's short, wide cases (the shapes of its wide route), in
    float32: the port's twin, which both routes of the CUDA kernel equal
    bit for bit, against the JAX package's plain ``matvec_xla`` bit for bit
    (each product rounded, then added in offset order, in both), and
    against its Pallas K1 in interpret mode where that kernel takes the
    operator (square, and its VMEM plan holds the offsets) to 1e-6
    relative (its halo tiles sum the same terms under XLA's fusion)."""
    A = dia_cases.WIDE[case]()
    x = np.random.default_rng(7).standard_normal(A.shape[1]) \
        .astype(np.float32)
    J = JaxDIA.from_scipy(A, max_offsets=1024).astype(jnp.float32)
    y_xla = np.asarray(J.matvec_xla(jnp.asarray(x)))
    D = SparseDIA.from_scipy(A, max_offsets=1024, dtype=np.float32,
                             device="cpu")
    assert D.offsets == J.offsets and D.shape == A.shape
    for route in ("auto", "tall", "wide"):
        y = dia_kernel._dia_matvec_route(D.diags, D.offsets_dev,
                                         torch.from_numpy(x), D.shape[1],
                                         route)
        assert y.dtype == torch.float32 and y.shape == (A.shape[0],)
        np.testing.assert_array_equal(y.numpy(), y_xla)
    if case in WIDE_PALLAS:
        y_ref = np.asarray(dia_matvec_pallas(J.diags, J.offsets,
                                             jnp.asarray(x), interpret=True))
        assert np.abs(y.numpy() - y_ref).max() <= \
            1e-6 * np.abs(y_ref).max()
    assert dia_kernel.route(A.shape[0], D.n_offsets) == \
        ("tall" if case == "k1" else "wide")


@pytest.mark.parametrize("n,k", [(256, 1), (219, 111), (4096, 179),
                                 (1000, 603)])
def test_route_sweep_operators(n, k):
    D, x = dia_route_sweep.operator(n, k, torch.float64, "cpu", seed=3)
    assert D.shape == (n, n) and x.shape == (n,) and 0 in D.offsets
    assert D.n_offsets == min(k, 2 * n - 1)
    assert len(set(D.offsets)) == D.n_offsets
    assert list(D.offsets) == sorted(D.offsets)
    assert max(abs(o) for o in D.offsets) < n
    C = dia_route_sweep.csr_of(D)
    assert C.crow_indices().dtype == torch.int32
    assert C.col_indices().dtype == torch.int32
    np.testing.assert_array_equal(C.to_dense().numpy(),
                                  D.to_scipy().toarray())


def test_route_sweep_needs_the_card():
    with pytest.raises(ValueError, match="CUDA"):
        dia_route_sweep.run(device="cpu")
