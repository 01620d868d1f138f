"""The reference's operators against scipy, and the benchmark's device
builder and program inputs against the reference."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from amgbench import fields, operators
from amgbench.reference import operator
from amgbench.reference.checks import levels, relres
from amgbench.reference.diffusion_fv import diffusion
from amgbench.reference.matrices import Matrix, Product, host, to_bfloat16
from amgbench.reference.stencil import stencil


def poisson_2d(nx, ny):
    """gallery.poisson's 5-point matrix on a row-major (ny, nx) grid."""
    def t(n):
        return sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                        [-1, 0, 1])
    return (sp.kron(sp.eye(ny), t(nx)) + sp.kron(t(ny), sp.eye(nx))).tocsr()


def box27(n):
    """HPCG's operator: 26 on the diagonal, -1 on each of the 26
    neighbours within the n^3 grid."""
    b = sp.diags([np.ones(n - 1), np.ones(n), np.ones(n - 1)], [-1, 0, 1])
    return (27 * sp.eye(n ** 3) - sp.kron(sp.kron(b, b), b)).tocsr()


@pytest.mark.parametrize("n", [3, 5, 8])
def test_box27_nnz_and_values(n):
    op = stencil((n, n, n), "box", 26.0, -1.0)
    A = op.to_csr()
    assert A.nnz == (3 * n - 2) ** 3
    assert abs(A - box27(n)).max() == 0


@pytest.mark.parametrize("grid", [(7, 5), (16, 16)])
def test_diffusion_of_ones_is_poisson(grid):
    op = diffusion(grid, np.ones(grid))
    assert abs(op.to_csr() - poisson_2d(grid[1], grid[0])).max() == 0


def test_matvec_equals_csr():
    rng = np.random.default_rng(0)
    k = np.exp(rng.standard_normal((9, 11)))
    for op in (diffusion((9, 11), k, "float64"),
               stencil((4, 5, 6), "box", 26.0, -1.0),
               stencil((4, 5, 6), "cross", 6.0, -1.0)):
        x = rng.standard_normal(op.n)
        np.testing.assert_allclose(op.matvec(x), op.to_csr() @ x,
                                   rtol=1e-13, atol=1e-13)


def test_diffusion_is_symmetric_and_conservative():
    rng = np.random.default_rng(1)
    k = np.exp(rng.standard_normal((6, 7)))
    A = diffusion((6, 7), k, "float64").to_csr()
    assert abs(A - A.T).max() == 0
    # an interior row sums to zero, a boundary row to its boundary faces
    assert abs(A.sum(axis=1)).reshape(6, 7)[2:-2, 2:-2].max() < 1e-13


@pytest.mark.parametrize("spec_", [
    {"kind": "stencil", "grid": [5, 6, 7], "shape": "box", "center": 26.0,
     "neighbor": -1.0},
    {"kind": "diffusion_fv", "grid": [9, 8]}])
def test_device_builder_equals_reference(spec_):
    coeff = {"kind": "fourier_lognormal", "modes": 16, "contrast": 10.0}
    k = fields.draw(coeff, spec_["grid"], 11, fields.COEFFICIENTS, 2, "cpu") \
        if operators.takes_field(spec_) else None
    op = operators.build(spec_, torch.float32, "cpu", k)
    ref = operator(spec_, "float32", None if k is None else k.numpy())
    A = op.program_input("csr", torch.float32)
    assert A.dtype == np.float32
    assert abs(A.astype(np.float64) - ref.to_csr()).max() == 0
    assert A.has_sorted_indices
    x = torch.randn(op.n, dtype=torch.float64)
    np.testing.assert_allclose(op.matvec(x).numpy(), ref.matvec(x.numpy()),
                               rtol=1e-13, atol=1e-12)
    D = op.program_input("dia", torch.float32)
    assert D.offsets == tuple(sorted(D.offsets)) and D.dtype == torch.float32
    assert D.diags.data_ptr() != op.diags.data_ptr()   # the program's copy
    np.testing.assert_allclose(D.matvec(x.float()).double().numpy(),
                               A @ x.numpy(), rtol=1e-5, atol=1e-5)


def test_relres_and_levels_rule():
    op = stencil((6, 6), "cross", 4.0, -1.0)
    x = np.random.default_rng(2).standard_normal(op.n)
    assert relres.relres(op, x, x) == 0
    assert relres.relres(op, x, np.zeros_like(x)) == pytest.approx(1.0)
    assert levels.grid_block_sizes((4096, 4096), 3, 500, 10) == [
        16777216, 1865956, 207936, 23104, 2601, 289]
    assert levels.grid_block_sizes((48, 48), 3, 50, 10) == [2304, 256, 36]


def test_row_diagonals_equal_csr():
    """A matrix read back as row diagonals multiplies as its CSR form,
    both ways, rectangular too."""
    rng = np.random.default_rng(3)
    n, m, offsets = 9, 7, (-2, 0, 1, 3)
    diags = rng.standard_normal((len(offsets), n))
    dense = np.zeros((n, m))
    for k, off in enumerate(offsets):
        for i in range(n):
            if 0 <= i + off < m:
                dense[i, i + off] = diags[k, i]
    D = host(("rows", diags, offsets, (n, m)))
    C = host(("csr", sp.csr_matrix(dense)))
    x, y = rng.standard_normal(m), rng.standard_normal(n)
    for M in (D, C):
        np.testing.assert_allclose(M.matvec(x), dense @ x, rtol=1e-14)
        np.testing.assert_allclose(M.rmatvec(y), dense.T @ y, rtol=1e-14)
        np.testing.assert_allclose(M.map(np.abs).matvec(np.abs(x)),
                                   np.abs(dense) @ np.abs(x), rtol=1e-14)
    P = Product([C, Matrix((m, 4), csr=sp.csr_matrix(rng.random((m, 4))))])
    v = rng.standard_normal(4)
    np.testing.assert_allclose(P.matvec(v), dense @ (P.factors[1].csr @ v),
                               rtol=1e-13)


def test_bfloat16_rounding():
    a = np.array([1.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -9, -3.0e-5, 0.0])
    r = to_bfloat16(a)
    assert r[0] == 1.0 and r[4] == 0.0
    assert r[1] == 1.0                       # a tie goes to the even
    assert r[2] == 1.0 + 2 ** -7
    assert abs(r[3] / a[3] - 1) <= 2 ** -9
