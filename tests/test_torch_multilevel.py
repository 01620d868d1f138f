"""The port's cycle and solves against the JAX package's.

A 128^2 Poisson hierarchy built by ``pyamg_tpu`` is exported with
``np.asarray`` and loaded into the port with
``util.convert.hierarchy_from_numpy``, so that the V-cycle and the solves
are compared with the setup factored out; the port's own setup is compared
too.  One V-cycle agrees to 1e-12 relative in float64; iteration counts are
pinned exactly and residuals loosely.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pyamg_tpu
from pyamg_tpu.gallery import poisson as jax_poisson
from pyamg_tpu.sparse import ComposedOp as JComposed
import pyamg_tpu_torch
from pyamg_tpu_torch.gallery import poisson
from pyamg_tpu_torch.util.convert import hierarchy_from_numpy

torch.set_num_threads(1)

N = 128
KW = dict(max_coarse=50, presmoother="chebyshev", postsmoother="chebyshev",
          improve_candidates=None)


def _dia(op):
    return {"diags": np.asarray(op.diags), "offsets": tuple(op.offsets),
            "shape": tuple(op.shape)}


def _smoother(sm):
    return {"kind": sm.kind, "iterations": sm.iterations, "omega": sm.omega,
            "dinv": None if sm.dinv is None else np.asarray(sm.dinv),
            "coefficients": tuple(sm.coefficients)}


def export_jax(ml):
    """The arrays of a JAX structured SA hierarchy, as
    ``hierarchy_from_numpy`` takes them."""
    coarse = np.asarray(ml._dev()["coarse"][0])
    levels = []
    for lvl in ml.levels:
        spec = {"A": _dia(lvl.A)}
        if getattr(lvl, "P", None) is not None:
            meta = lvl.struct_meta
            P, R = lvl.P, lvl.R
            assert isinstance(P, JComposed) and len(P.ops) == 2
            spec["transfer"] = {
                "wmap": np.asarray(P.ops[1].wmap),
                "fine_grid": tuple(meta["grid"]),
                "block": tuple(meta["block"]),
                "S": _dia(P.ops[0]), "SH": _dia(R.ops[1]),
                "degree": meta["degree"]}
            spec["presmoother"] = _smoother(lvl.presmoother)
            spec["postsmoother"] = _smoother(lvl.postsmoother)
        levels.append(spec)
    return levels, coarse


@pytest.fixture(scope="module")
def problem():
    A = poisson((N, N), format="csr")
    b = A @ np.random.default_rng(0).random(A.shape[0])
    return A, b


@pytest.fixture(scope="module")
def jax_ml():
    return pyamg_tpu.smoothed_aggregation_solver(
        jax_poisson((N, N), format="csr"), **KW)


@pytest.fixture(scope="module")
def ports(jax_ml):
    """The port's hierarchy both ways: loaded from the JAX arrays, and
    built by its own setup."""
    levels, coarse = export_jax(jax_ml)
    loaded = hierarchy_from_numpy(levels, coarse, "cpu", torch.float64)
    own = pyamg_tpu_torch.smoothed_aggregation_solver(
        poisson((N, N), format="csr"), device="cpu", **KW)
    return {"loaded": loaded, "own": own}


def _relres(A, b, x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.linalg.norm(b - A @ x) / np.linalg.norm(b)


@pytest.mark.parametrize("how", ["loaded", "own"])
def test_one_vcycle_matches_jax(jax_ml, ports, problem, how):
    _, b = problem
    rng = np.random.default_rng(1)
    x0 = rng.standard_normal(b.shape[0])
    ref = np.asarray(jax_ml.cycle_fn("V")(jnp.asarray(x0), jnp.asarray(b)))
    ml = ports[how]
    assert len(ml.levels) == len(jax_ml.levels) == 4
    y = ml.cycle_fn("V")(torch.from_numpy(x0), torch.from_numpy(b)).numpy()
    assert np.abs(y - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("how", ["loaded", "own"])
def test_pcg_iteration_count_matches_jax(jax_ml, ports, problem, how):
    A, b = problem
    ref_res = []
    jax_ml.solve(b, tol=1e-8, accel="cg", residuals=ref_res)
    res = []
    x, info = ports[how].solve(b, tol=1e-8, accel="cg", residuals=res,
                               return_info=True)
    assert info == 0
    assert len(res) == len(ref_res)
    np.testing.assert_allclose(res, ref_res, rtol=1e-6)
    assert _relres(A, b, x) <= 1e-8


def test_standalone_cycling_matches_jax(jax_ml, ports, problem):
    A, b = problem
    ref_res = []
    jax_ml.solve(b, tol=1e-8, residuals=ref_res)
    res = []
    x = ports["own"].solve(b, tol=1e-8, residuals=res)
    assert len(res) == len(ref_res)
    assert _relres(A, b, x) <= 1e-8


@pytest.fixture(scope="module")
def f32_pair():
    ref = pyamg_tpu.smoothed_aggregation_solver(
        jax_poisson((N, N), format="csr"), op_dtype=jnp.float32, **KW)
    ours = pyamg_tpu_torch.smoothed_aggregation_solver(
        poisson((N, N), format="csr"), device="cpu", op_dtype=torch.float32,
        **KW)
    return ours, ref


@pytest.mark.parametrize("method", ["defect", "pcg"])
def test_solve_mp_matches_jax(f32_pair, problem, method):
    A, b = problem
    ours, ref = f32_pair
    kw = dict(tol=1e-10, method=method, inner_maxiter=40, max_rounds=4,
              inner_tol_factor=1e-6, return_info=True)
    x_ref, info_ref = ref.solve_mp(b, **kw)
    x, info = ours.solve_mp(b, **kw)
    assert x.dtype == torch.float64
    assert _relres(A, b, x) <= 5e-10
    assert abs(info["inner_iterations"] - info_ref["inner_iterations"]) <= 1
    if method == "defect":
        assert info["rounds"] == info_ref["rounds"]
