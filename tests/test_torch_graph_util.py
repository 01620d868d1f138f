"""The rest of ``graph``, ``util``, ``sparse.ops`` and ``vis``, and the
profiling tools: the port against the JAX package on the same inputs.

* ``breadth_first_search``, ``connected_components``,
  ``pseudo_peripheral_node``, ``symmetric_rcm`` and largest-degree-first
  coloring: equal arrays.
* The reference-named helpers of ``util.utils``: equal values,
  ``print_table`` as the identical string.
* ``count_diagonals``; ``spgemm``, ``rap`` and ``transpose`` from scipy
  and from the port's ELL containers, by their scipy forms.
* ``vis``: the ``.vtu`` files byte for byte.
* ``profile_cycles``, ``solve_timings``, ``profile_solver`` and
  ``hierarchy_spectrum`` on the CPU (the spectra against the JAX
  package's), and ``trace``'s Chrome trace.
"""

import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pyamg_tpu.amg_core as jax_core
from pyamg_tpu import graph as jax_graph
from pyamg_tpu import vis as jax_vis
from pyamg_tpu.aggregation import rootnode_nii as jax_nii
from pyamg_tpu.sparse import device_op as jax_device_op
from pyamg_tpu.sparse import ops as jax_ops
from pyamg_tpu.util import profiling as jax_profiling
from pyamg_tpu.util import utils as jax_utils
import pyamg_tpu_torch
from pyamg_tpu_torch import graph, sparse, vis
from pyamg_tpu_torch.aggregation import newideal_solver
from pyamg_tpu_torch.gallery import poisson
from pyamg_tpu_torch.util import profiling, utils

torch.set_num_threads(1)


def _graphs():
    rng = np.random.default_rng(0)
    R = sp.random(150, 150, density=0.015, random_state=1, format="csr")
    R = (R + R.T).tocsr()
    two = sp.block_diag([poisson((6, 7), format="csr"),
                         poisson((30,), format="csr")]).tocsr()
    W = sp.csr_matrix(poisson((12, 9), format="csr").tocoo())
    W.data = rng.random(W.nnz) + 0.5
    return {"poisson13x17": sp.csr_matrix(poisson((13, 17), format="csr")),
            "random150": R, "two_components": two, "weighted12x9": W}


GRAPHS = _graphs()


@pytest.mark.parametrize("name", list(GRAPHS))
def test_graph_orderings_match_jax(name):
    G = GRAPHS[name]
    for seed in (0, 5, G.shape[0] - 1):
        order, level = graph.breadth_first_search(G, seed)
        order_ref, level_ref = jax_graph.breadth_first_search(G, seed)
        assert np.array_equal(order, order_ref)
        assert np.array_equal(level, level_ref)
    labels = graph.connected_components(G)
    assert np.array_equal(labels, jax_graph.connected_components(G))
    if name == "two_components":
        assert labels.max() == 1
    node, order, level = graph.pseudo_peripheral_node(G)
    node_ref, order_ref, level_ref = jax_graph.pseudo_peripheral_node(G)
    assert node == node_ref
    assert np.array_equal(order, order_ref)
    assert np.array_equal(level, level_ref)
    B, perm = graph.symmetric_rcm(G)
    B_ref, perm_ref = jax_graph.symmetric_rcm(G)
    assert np.array_equal(perm, perm_ref)
    assert abs(B - B_ref).nnz == 0


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("seed", [0, 3])
def test_ldf_coloring_matches_jax(name, seed):
    G = GRAPHS[name]
    colors = graph.vertex_coloring(G, "LDF", seed=seed)
    assert np.array_equal(colors, jax_graph.vertex_coloring(G, "LDF",
                                                            seed=seed))
    rows = np.repeat(np.arange(G.shape[0]), np.diff(G.indptr))
    off = rows != G.indices
    assert not (colors[rows[off]] == colors[G.indices[off]]).any()


TABLES = [([["a", "bb", None], [1, 2.5, "long cell"], [3]], {}),
          ([["x", "y"], ["1", "22"]],
           dict(title="T", delim="#", centering="left", col_padding=1,
                header=False)),
          ([["h1", "h2"], ["v", "w"]],
           dict(centering="right", headerchar="=")),
          ([], {})]


@pytest.mark.parametrize("table,kw", TABLES,
                         ids=["default", "titled-left", "right", "empty"])
def test_print_table_is_the_same_string(table, kw):
    assert utils.print_table(table, **kw) == jax_utils.print_table(table,
                                                                   **kw)


def test_util_helpers_match_jax():
    A = sp.csr_matrix(poisson((6, 5), format="csr"))
    assert np.array_equal(utils.diag_sparse(A), jax_utils.diag_sparse(A))
    v = np.arange(1.0, 5.0)
    assert abs(utils.diag_sparse(v) - jax_utils.diag_sparse(v)).nnz == 0
    B = np.random.default_rng(1).random((A.shape[0], 2))
    ours = utils.symmetric_rescaling_sa(A * 3.0, B, B[:, :1])
    ref = jax_utils.symmetric_rescaling_sa(A * 3.0, B, B[:, :1])
    assert abs(ours[0] - ref[0]).max() == 0
    assert np.array_equal(ours[1], ref[1]) and np.array_equal(ours[2], ref[2])
    assert utils.symmetric_rescaling_sa(A, B)[2] is None
    for fn, jfn in ((utils.to_type, jax_utils.to_type),
                    (utils.type_prep, jax_utils.type_prep)):
        got = fn(np.complex128, [1.5, np.ones(2), A, None])
        want = jfn(np.complex128, [1.5, np.ones(2), A, None])
        assert [type(g) for g in got] == [type(w) for w in want]
        assert np.array_equal(np.ravel(got[0]), np.ravel(want[0]))
        assert got[1].dtype == want[1].dtype == np.complex128
        assert got[2].dtype == np.complex128 and got[3] is None
    x, y, z = np.random.default_rng(2).random((3, 7))
    for pdes in (1, 3, 6):
        assert np.array_equal(utils.Coord2RBM(7, pdes, x, y, z),
                              jax_utils.Coord2RBM(7, pdes, x, y, z))
    with pytest.raises(ValueError):
        utils.Coord2RBM(7, 2, x, y, z)
    assert abs(utils.UnAmal(A, 2, 3) - jax_utils.UnAmal(A, 2, 3)).nnz == 0
    assert utils.hierarchy_spectrum is profiling.hierarchy_spectrum


def _ops_inputs():
    rng = np.random.default_rng(4)
    A = sp.random(40, 30, density=0.1, random_state=3, format="csr")
    B = sp.random(30, 25, density=0.15, random_state=4, format="csr")
    K = sp.csr_matrix(poisson((7, 6), format="csr"))
    P = sp.random(42, 10, density=0.3, random_state=5, format="csr")
    P.data = rng.random(P.nnz)
    return A, B, K, P


def test_count_diagonals_matches_jax():
    A, B, K, P = _ops_inputs()
    for M in (A, B, K, P, sp.eye(5, format="csr")):
        assert sparse.count_diagonals(M) == jax_device_op.count_diagonals(M)
    assert sparse.count_diagonals(K) == 5


@pytest.mark.parametrize("container", ["scipy", "ell", "block_ell"])
def test_sparse_ops_match_jax(container):
    A, B, K, P = _ops_inputs()

    def wrap(M):
        if container == "ell":
            return pyamg_tpu_torch.SparseELL.from_scipy(M, device="cpu")
        if container == "block_ell" and M.shape[0] % 2 == 0 \
                and M.shape[1] % 2 == 0:
            return pyamg_tpu_torch.BlockELL.from_scipy(M, blocksize=2,
                                                       device="cpu")
        return M

    C = sparse.spgemm(wrap(A), wrap(B), device="cpu")
    C_ref = jax_ops.spgemm(A, B)
    assert isinstance(C, pyamg_tpu_torch.SparseELL) and C.width == C_ref.width
    assert abs(C.to_scipy() - C_ref.to_scipy()).max() <= 1e-15
    W = sparse.spgemm(A, B, width=C.width + 3, device="cpu")
    assert W.width == jax_ops.spgemm(A, B, width=C.width + 3).width
    with pytest.raises(ValueError):
        sparse.spgemm(A, B, width=1, device="cpu")
    Ac = sparse.rap(wrap(P.T.tocsr()), wrap(K), wrap(P), device="cpu")
    Ac_ref = jax_ops.rap(P.T.tocsr(), K, P)
    assert abs(Ac.to_scipy() - Ac_ref.to_scipy()).max() <= \
        1e-14 * abs(Ac_ref.to_scipy()).max()
    f32 = sparse.rap(P.T, K, P, dtype=np.float32, device="cpu")
    assert f32.dtype == torch.float32
    T = sparse.transpose(wrap(A), device="cpu")
    assert abs(T.to_scipy() - jax_ops.transpose(A).to_scipy()).nnz == 0


def _mesh():
    V = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0],
                  [2.0, 0.5]])
    E2V = np.array([[0, 1, 2], [1, 3, 2], [1, 4, 3]])
    return V, E2V


VTU_CASES = ["write_vtu", "tri_pdata", "quad_cdata", "vertices",
             "aggregates", "splitting"]


@pytest.mark.parametrize("case", VTU_CASES)
def test_vtu_files_are_byte_identical(case, tmp_path):
    V, E2V = _mesh()
    AggOp = sp.csr_matrix((np.ones(5), ([0, 1, 2, 3, 4], [0, 0, 1, 1, 0])),
                          shape=(5, 2))
    calls = {
        "write_vtu": ("write_vtu", (np.column_stack([V, V[:, 0]]),
                                    {5: E2V, 3: np.array([[0, 4]])}),
                      dict(pdata=np.arange(10.0).reshape(5, 2),
                           pvdata=np.arange(15.0).reshape(5, 3),
                           cdata=np.array([[1.0, 2.0, 3.0, 4.0]]))),
        "tri_pdata": ("write_basic_mesh", (V, E2V),
                      dict(mesh_type="tri", pdata=np.linspace(0, 1, 5))),
        "quad_cdata": ("write_basic_mesh",
                       (V[:4], np.array([[0, 1, 3, 2]])),
                       dict(mesh_type="quad", cdata=np.array([[7.5]]))),
        "vertices": ("write_basic_mesh", (V,), {}),
        "aggregates": ("vis_aggregate_groups", (V, E2V, AggOp), {}),
        "splitting": ("vis_splitting", (V, np.array([1, 0, 0, 1, 0, 1, 1,
                                                     0, 0, 1])), {}),
    }
    fn, args, kw = calls[case]
    ours, ref = tmp_path / "ours.vtu", tmp_path / "ref.vtu"
    getattr(vis, fn)(*args, fname=str(ours), **kw)
    getattr(jax_vis, fn)(*args, fname=str(ref), **kw)
    assert ours.read_bytes() == ref.read_bytes()
    assert ours.stat().st_size > 200


@pytest.fixture(scope="module")
def hierarchy():
    A = sp.csr_matrix(poisson((40, 40), format="csr").tocoo())
    ml = newideal_solver(A, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_core, "have_native", lambda: True)
        ref = jax_nii.newideal_solver(A)
    return A, ml, ref


def test_profile_cycles_and_solve_timings(hierarchy):
    A, ml, _ = hierarchy
    out = profiling.profile_cycles(ml, n_cycles=3, warmup=1)
    assert set(out) == {"cycle", "seconds_per_cycle", "dofs_per_second",
                        "nnz_throughput"}
    assert out["cycle"] == "V" and out["seconds_per_cycle"] > 0
    assert out["dofs_per_second"] == pytest.approx(
        A.shape[0] / out["seconds_per_cycle"])
    out = profiling.profile_cycles(ml, n_cycles=2, cycle="W", warmup=0,
                                   dtype=np.float64)
    assert out["cycle"] == "W" and out["nnz_throughput"] > 0
    b = A @ np.random.default_rng(0).random(A.shape[0])
    x, info = profiling.solve_timings(ml, b, tol=1e-8, maxiter=200)
    assert set(info) == {"total_seconds", "iterations",
                         "seconds_per_iteration", "residuals"}
    assert info["residuals"].shape == (info["iterations"] + 1,)
    assert info["residuals"][-1] <= 1e-8 * info["residuals"][0]
    assert x.shape == (A.shape[0],)
    res = utils.profile_solver(ml, accel="cg", tol=1e-8, maxiter=200)
    assert isinstance(res, np.ndarray) and res.ndim == 1
    assert res.size == info["iterations"] + 1
    cyc = pyamg_tpu_torch.util.profile_solver(ml, maxiter=3)
    assert cyc.shape == (4,) and cyc[-1] < cyc[0]


def test_hierarchy_spectrum_matches_jax(hierarchy):
    _, ml, ref = hierarchy
    ours = profiling.hierarchy_spectrum(ml)
    want = jax_profiling.hierarchy_spectrum(ref)
    assert [s["n"] for s in ours] == [s["n"] for s in want] \
        == [lvl.A_csr.shape[0] for lvl in ml.levels]
    for got, exp in zip(ours, want):
        for key in ("min", "max"):
            assert (got[key] is None) == (exp[key] is None)
            if exp[key] is not None:
                assert abs(got[key] - exp[key]) <= 1e-8 * abs(exp[key])
    assert ours[0]["min"] is None and ours[-1]["min"] is not None


def test_trace_writes_a_chrome_trace(hierarchy, tmp_path):
    A, ml, _ = hierarchy
    b = np.ones(A.shape[0])
    with profiling.trace(tmp_path / "tr"):
        ml.solve(b, tol=1e-6, maxiter=5, accel="cg")
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = {e.get("name", "") for e in events["traceEvents"]}
    assert len(events["traceEvents"]) > 10
    assert any(n.startswith("aten::") for n in names)
