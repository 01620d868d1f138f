"""The port's grid transfer operators against the JAX package's.

``GridRepeatOp`` (tentative prolongation), ``GridPoolOp`` (its transpose),
``ComposedOp`` and ``DenseOp``, in the 1-D ``wmap`` form and the K-channel
form, on grids that the blocks divide and on grids they do not.  Same numpy
inputs to both packages; float64 agreement to 1e-13 relative (the ops are
copies, products and short sums).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyamg_tpu.sparse import (ComposedOp as JComposed, DenseOp as JDense,
                              GridPoolOp as JPool, GridRepeatOp as JRepeat,
                              SparseDIA as JaxDIA)
from pyamg_tpu_torch.gallery import poisson
from pyamg_tpu_torch.sparse import (ComposedOp, DenseOp, GridPoolOp,
                                    GridRepeatOp, SparseDIA)

torch.set_num_threads(1)

TOL = 1e-13

GRIDS = [((10, 7), (3, 3)), ((9, 9), (3, 3)), ((8, 5), (2, 3)),
         ((7, 4, 5), (3, 2, 3))]


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= TOL * max(np.abs(b).max(), 1.0)


def _ops(grid, block, K, q, seed=0):
    rng = np.random.default_rng(seed)
    n_nodes = int(np.prod(grid))
    n_c = int(np.prod([-(-g // b) for g, b in zip(grid, block)]))
    n_f = n_nodes * q
    wmap = rng.standard_normal(n_f if K is None else (n_f, K))
    n_cd = n_c * (1 if K is None else K)
    ours = (GridRepeatOp(torch.from_numpy(wmap), grid, block, (n_f, n_cd),
                         node_dofs=q),
            GridPoolOp(torch.from_numpy(wmap), grid, block, (n_cd, n_f),
                       node_dofs=q, conj=False))
    ref = (JRepeat(jnp.asarray(wmap), grid, block, (n_f, n_cd), node_dofs=q),
           JPool(jnp.asarray(wmap), grid, block, (n_cd, n_f), node_dofs=q,
                 conj=False))
    return ours, ref, rng


@pytest.mark.parametrize("form", ["scalar", "K2", "K2q2"])
@pytest.mark.parametrize("grid,block", GRIDS)
def test_repeat_and_pool_match_jax(grid, block, form):
    K, q = {"scalar": (None, 1), "K2": (2, 1), "K2q2": (2, 2)}[form]
    (rep, pool), (jrep, jpool), rng = _ops(grid, block, K, q)
    xc = rng.standard_normal(rep.shape[1])
    xf = rng.standard_normal(rep.shape[0])
    _close(rep.matvec(torch.from_numpy(xc)).numpy(),
           jrep.matvec(jnp.asarray(xc)))
    _close(pool.matvec(torch.from_numpy(xf)).numpy(),
           jpool.matvec(jnp.asarray(xf)))
    # the pool is the repeat's transpose
    assert abs(pool.to_scipy() - rep.to_scipy().T).max() <= TOL
    assert abs(rep.to_scipy() - jrep.to_scipy()).max() == 0


def test_composed_op_matches_jax_and_astype():
    grid, block = (10, 7), (3, 3)
    A = poisson(grid, format="csr")
    (rep, pool), (jrep, jpool), rng = _ops(grid, block, None, 1)
    S, JS = SparseDIA.from_scipy(A, device="cpu"), JaxDIA.from_scipy(A)
    P = ComposedOp([S, rep], rep.shape)
    R = ComposedOp([pool, S], pool.shape)
    JP = JComposed((JS, jrep), jrep.shape)
    JR = JComposed((jpool, JS), jpool.shape)
    xc = rng.standard_normal(P.shape[1])
    xf = rng.standard_normal(P.shape[0])
    _close(P.matvec(torch.from_numpy(xc)).numpy(), JP.matvec(jnp.asarray(xc)))
    _close(R.matvec(torch.from_numpy(xf)).numpy(), JR.matvec(jnp.asarray(xf)))
    assert abs(P.to_scipy() - JP.to_scipy()).max() <= TOL
    P32 = P.astype(torch.float32)
    assert P32.dtype == torch.float32
    assert all(op.dtype == torch.float32 for op in P32.ops)
    assert P32.matvec(torch.from_numpy(xc).float()).dtype == torch.float32


def test_dense_op_matches_jax():
    rng = np.random.default_rng(1)
    M = rng.standard_normal((13, 9))
    x = rng.standard_normal(9)
    D, JD = DenseOp(torch.from_numpy(M), M.shape), JDense(jnp.asarray(M),
                                                          M.shape)
    _close(D.matvec(torch.from_numpy(x)).numpy(), JD.matvec(jnp.asarray(x)))
    assert D.astype(np.float32).dtype == torch.float32
    assert abs(D.to_scipy() - JD.to_scipy()).max() == 0
