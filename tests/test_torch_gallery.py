"""The port's gallery against the JAX package's: every generator gives the
same matrix entry for entry (and the same vectors, meshes and stencils),
from the same arguments and seeds."""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pyamg_tpu.gallery as jax_gallery
from pyamg_tpu.gallery.example import EXAMPLE_NAMES as JAX_EXAMPLE_NAMES
import pyamg_tpu_torch.gallery as gallery
from pyamg_tpu_torch.gallery.example import EXAMPLE_NAMES
from pyamg_tpu_torch.util.utils import coord2rbm
from pyamg_tpu.util.utils import coord2rbm as jax_coord2rbm

torch.set_num_threads(1)


def _same(a, b):
    if sp.issparse(a) or sp.issparse(b):
        assert sp.issparse(a) and sp.issparse(b) and a.format == b.format
        assert a.shape == b.shape and a.dtype == b.dtype
        a, b = a.tocsr(), b.tocsr()
        a.sort_indices()
        b.sort_indices()
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.data, b.data)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_exports_are_the_jax_packages():
    assert sorted(gallery.__all__) == sorted(jax_gallery.__all__)
    assert EXAMPLE_NAMES == JAX_EXAMPLE_NAMES


@pytest.mark.parametrize("kw", [dict(npts=12), dict(npts=9, beta=0.4, seed=3),
                                dict(npts=16, spacing=0.5, beta=0.1, seed=0)],
                         ids=["default", "beta", "spacing"])
def test_gauge_laplacian(kw):
    seeded = dict(kw, seed=kw.get("seed", 5))
    A = gallery.gauge_laplacian(**seeded)
    _same(A, jax_gallery.gauge_laplacian(**seeded))
    assert np.iscomplexobj(A.data) and abs(A - A.conj().T).max() == 0
    assert np.linalg.eigvalsh(A.toarray()).min() > 0


@pytest.mark.parametrize("type_", ["FD", "FE"])
@pytest.mark.parametrize("eps,theta", [(1.0, 0.0), (1e-3, np.pi / 6),
                                       (0.1, 1.1)])
def test_diffusion_stencil_2d(eps, theta, type_):
    _same(gallery.diffusion_stencil_2d(eps, theta, type_),
          jax_gallery.diffusion_stencil_2d(eps, theta, type_))


@pytest.mark.parametrize("type_", ["FD", "FE"])
def test_diffusion_stencil_3d(type_):
    args = (0.1, 0.01, 0.3, 0.4, 0.5)
    S = gallery.diffusion_stencil_3d(*args, type=type_)
    _same(S, jax_gallery.diffusion_stencil_3d(*args, type=type_))
    assert S.shape == (3, 3, 3) and abs(S.sum()) < 1e-12
    with pytest.raises(ValueError, match="discretization"):
        gallery.diffusion_stencil_3d(type="spectral")


@pytest.mark.parametrize("grid", [(5, 6), (9, 4)])
@pytest.mark.parametrize("format", [None, "csr"])
def test_linear_elasticity(grid, format):
    A, B = gallery.linear_elasticity(grid, format=format)
    JA, JB = jax_gallery.linear_elasticity(grid, format=format)
    _same(A, JA)
    _same(B, JB)
    assert B.shape == (2 * grid[0] * grid[1], 3)


def test_mesh_and_p1_elasticity():
    V, E = gallery.regular_triangle_mesh(5, 4)
    JV, JE = jax_gallery.regular_triangle_mesh(5, 4)
    _same(V, JV)
    _same(E, JE)
    A, B = gallery.linear_elasticity_p1(V, E, E=2e4, nu=0.25)
    JA, JB = jax_gallery.linear_elasticity_p1(JV, JE, E=2e4, nu=0.25)
    _same(A, JA)
    _same(B, JB)
    with pytest.raises(ValueError, match="minimum mesh"):
        gallery.regular_triangle_mesh(1, 4)


@pytest.mark.parametrize("d", [1, 2, 3])
def test_coord2rbm(d):
    X = np.random.default_rng(d).random((7, d))
    _same(coord2rbm(X), jax_coord2rbm(X))


@pytest.mark.parametrize("format", ["csr", "csc", "coo"])
def test_sprand(format):
    A = gallery.sprand(30, 40, 0.1, format=format, seed=7)
    _same(A, jax_gallery.sprand(30, 40, 0.1, format=format, seed=7))
    with pytest.raises(ValueError, match="density"):
        gallery.sprand(3, 3, 1.5)


@pytest.mark.parametrize("name", JAX_EXAMPLE_NAMES)
def test_generated_example(name):
    ours, ref = gallery.load_example(name), jax_gallery.load_example(name)
    assert sorted(ours) == sorted(ref) and "A" in ours
    for key in ref:
        _same(ours[key], ref[key])


def test_load_example_looks_for_mat_files_first(tmp_path):
    from scipy.io import savemat

    savemat(tmp_path / "bar.mat", {"A": sp.eye(3, format="csc"),
                                   "B": np.ones((3, 1))})
    data = gallery.load_example("bar", data_dir=str(tmp_path))
    assert data["A"].shape == (3, 3) and not any(k.startswith("__")
                                                 for k in data)
    assert gallery.load_example("bar")["A"].shape == (800, 800)
    with pytest.raises(ValueError, match="unknown example"):
        gallery.load_example("no_such_example")


def test_demo_drives_the_port():
    out = io.StringIO()
    with redirect_stdout(out):
        x = gallery.demo(24, device="cpu")
    assert isinstance(x, torch.Tensor) and x.shape == (576,)
    text = out.getvalue()
    assert "MultilevelSolver" in text and "residual norm" in text
    A = gallery.poisson((24, 24), format="csr")
    b = np.random.default_rng(0).standard_normal(576)
    assert np.linalg.norm(b - A @ x.numpy()) <= 1e-7 * np.linalg.norm(b)
