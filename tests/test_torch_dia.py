"""The port's SparseDIA and DIA SpMV against the JAX package's.

The same numpy inputs go through ``pyamg_tpu``'s ``matvec_xla`` and its
Pallas kernel (in interpret mode, float32 -- the only dtype that kernel
takes) and through ``pyamg_tpu_torch``'s plain path on the CPU.  The CUDA
kernel itself is held against its plain version in test_torch_kernel.py.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from pyamg_tpu.sparse import SparseDIA as JaxDIA
from pyamg_tpu.sparse.pallas_kernels import dia_matvec_pallas
from pyamg_tpu_torch.gallery import poisson
from pyamg_tpu_torch.sparse import SparseDIA, dia_kernel

torch.set_num_threads(1)

# relative to max|y|: float32 round-off over a handful of terms; float64
# agrees to round-off of the same sums taken in another order
TOL = {np.float32: 1e-5, np.float64: 1e-12}


def _square():
    """Poisson on (30, 27) plus three extra diagonals: the (300, 257)
    case of tests/test_pallas.py at a tenth of the size."""
    rng = np.random.default_rng(0)
    A = poisson((30, 27), format="csr")
    n = A.shape[0]
    return sp.csr_matrix(A
                         + 0.3 * sp.diags(rng.random(n - 28), 28)
                         + 0.2 * sp.diags(rng.random(n - 13), -13)
                         + 0.1 * sp.diags(rng.random(n - 5), 5))


def _rect(n, m, offsets, seed):
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for o in offsets:
        i = np.arange(n)
        ok = (i + o >= 0) & (i + o < m)
        rows.append(i[ok])
        cols.append(i[ok] + o)
    r, c = np.concatenate(rows), np.concatenate(cols)
    return sp.csr_matrix((rng.standard_normal(r.size), (r, c)),
                         shape=(n, m))


CASES = {
    "square": _square,
    "poisson2d": lambda: poisson((24, 24), format="csr"),
    "tall": lambda: _rect(200, 150, (-60, -1, 0, 3, 149), 1),
    "wide": lambda: _rect(150, 200, (-149, -2, 0, 1, 51, 199), 2),
}


def _x(m, dtype, seed=3):
    return np.random.default_rng(seed).standard_normal(m).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_matvec_matches_jax_matvec_xla(case, dtype):
    A = CASES[case]()
    x = _x(A.shape[1], dtype)
    y_ref = np.asarray(JaxDIA.from_scipy(A).astype(dtype)
                       .matvec_xla(jnp.asarray(x)))
    D = SparseDIA.from_scipy(A, dtype=dtype, device="cpu")
    y = D.matvec(torch.from_numpy(x)).numpy()
    assert y.dtype == dtype
    scale = np.abs(y_ref).max()
    assert np.abs(y - y_ref).max() <= TOL[dtype] * scale
    assert np.abs(D.matvec_plain(torch.from_numpy(x)).numpy()
                  - y_ref).max() <= TOL[dtype] * scale


def _complex(A, seed=7):
    """A with a seeded unit-modulus phase on every entry."""
    rng = np.random.default_rng(seed)
    A = A.tocsr().astype(np.complex128)
    A.data = A.data * np.exp(2j * np.pi * rng.random(A.nnz))
    return A


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("case", sorted(CASES))
def test_complex_matvec_matches_jax_matvec_xla(case, dtype):
    """The JAX package sends a complex DIA through ``matvec_xla``; the
    port's wrapper takes it too (its plain version on the CPU)."""
    A = _complex(CASES[case]())
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(A.shape[1])
         + 1j * rng.standard_normal(A.shape[1])).astype(dtype)
    y_ref = np.asarray(JaxDIA.from_scipy(A).astype(dtype)
                       .matvec_xla(jnp.asarray(x)))
    D = SparseDIA.from_scipy(A, dtype=dtype, device="cpu")
    assert D.dtype == {np.complex64: torch.complex64,
                       np.complex128: torch.complex128}[dtype]
    y = dia_kernel.dia_matvec(D.diags, D.offsets_dev, torch.from_numpy(x),
                              A.shape[1]).numpy()
    assert y.dtype == dtype
    tol = 1e-5 if dtype == np.complex64 else 1e-12
    assert np.abs(y - y_ref).max() <= tol * np.abs(y_ref).max()
    assert np.abs(y - (A @ x.astype(np.complex128))).max() \
        <= tol * np.abs(y_ref).max()


@pytest.mark.parametrize("case", ["square", "poisson2d"])
def test_matvec_matches_pallas_kernel_interpret(case):
    A = CASES[case]()
    x = _x(A.shape[1], np.float32)
    J = JaxDIA.from_scipy(A).astype(jnp.float32)
    y_ref = np.asarray(dia_matvec_pallas(J.diags, J.offsets, jnp.asarray(x),
                                         interpret=True))
    y = SparseDIA.from_scipy(A, dtype=np.float32, device="cpu").matvec(
        torch.from_numpy(x)).numpy()
    assert np.abs(y - y_ref).max() <= 1e-5 * np.abs(y_ref).max()


@pytest.mark.parametrize("dtype", [None, np.float32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_host_diags_and_transpose_equal_jax(case, dtype):
    A = CASES[case]()
    d, offs = SparseDIA.host_diags(A, dtype=dtype)
    d_ref, offs_ref = JaxDIA.host_diags(A, dtype=dtype)
    assert offs == offs_ref
    assert d.dtype == d_ref.dtype
    np.testing.assert_array_equal(d, d_ref)
    t, toffs = SparseDIA.host_transpose(d, offs, A.shape)
    t_ref, toffs_ref = JaxDIA.host_transpose(d_ref, offs_ref, A.shape)
    assert toffs == toffs_ref
    np.testing.assert_array_equal(t, t_ref)
    # and the transpose is A^T
    At = SparseDIA(torch.from_numpy(t), toffs, A.shape[::-1]).to_scipy()
    assert abs(At - A.T.tocsr().astype(d.dtype)).max() == 0


def test_to_scipy_diagonal_astype_roundtrip():
    A = CASES["square"]()
    D = SparseDIA.from_scipy(A, device="cpu")
    assert abs(D.to_scipy() - A).max() == 0
    np.testing.assert_array_equal(D.diagonal().numpy(), A.diagonal())
    D32 = D.astype(torch.float32)
    assert D32.dtype == torch.float32 and D32.offsets == D.offsets
    assert D32.offsets_dev is D.offsets_dev
    assert D.nnz == A.nnz


def test_wrapper_on_cpu_runs_plain_version_and_counts_no_launch():
    A = CASES["tall"]()
    D = SparseDIA.from_scipy(A, device="cpu")
    x = torch.from_numpy(_x(A.shape[1], np.float64))
    before = dia_kernel.launches
    y = dia_kernel.dia_matvec(D.diags, D.offsets_dev, x, A.shape[1])
    assert dia_kernel.launches == before
    assert torch.equal(y, dia_kernel.dia_matvec_plain(D.diags, D.offsets, x,
                                                      A.shape[1]))


@pytest.mark.parametrize("bad", ["mixed", "complex", "strided", "length",
                                 "offsets_dtype"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    A = CASES["square"]()
    D = SparseDIA.from_scipy(A, device="cpu")
    diags, offs, m = D.diags, D.offsets_dev, A.shape[1]
    x = torch.from_numpy(_x(m, np.float64))
    if bad == "mixed":
        args, err = (diags, offs, x.float(), m), TypeError
    elif bad == "complex":
        # complex diagonals take a complex x of the same width only
        args, err = (diags.to(torch.complex128), offs, x, m), TypeError
    elif bad == "strided":
        x2 = torch.zeros(2 * m, dtype=torch.float64)
        args, err = (diags, offs, x2[::2], m), ValueError
    elif bad == "length":
        args, err = (diags, offs, x[:-1], m), ValueError
    else:
        args, err = (diags, offs.long(), x, m), TypeError
    with pytest.raises(err):
        dia_kernel.dia_matvec(*args)
