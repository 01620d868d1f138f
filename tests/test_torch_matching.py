"""Graph routines, matchings and the Lloyd and pairwise aggregations: the
port against the JAX package.

The same numpy inputs, made from a seed, go through ``pyamg_tpu`` and the
port:

* ``maximal_independent_set`` (serial, Luby rounds, distance 2), exactly;
* ``bellman_ford`` through the compiled library and through its Python
  form, exactly, and the port's bindings ``bellman_ford_native``,
  ``bfs_levels_native`` and ``drake_matching_native`` against those of
  ``pyamg_tpu.amg_core``; a disconnected graph leaves its unreached nodes
  at distance inf, nearest seed -1 and no aggregate;
* ``lloyd_cluster`` at 32^2 (distances, clusters and seeds exactly), and
  the vectorized recentering against a literal copy of the JAX package's
  loop, on data with constructed ties;
* the Drake, Preis and Notay partner arrays, ``_pairs_to_labels``, and
  the ``lloyd_aggregation`` and ``pairwise_aggregation`` operators,
  exactly;
* smoothed aggregation with ``aggregate="lloyd"`` and with pairwise
  aggregation at 40^2, level by level, with the JAX package's CG
  iterations, the port's compiled library on and off.

The JAX package's compiled library is on (``have_native`` patched to True)
unless a case turns both off.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.csgraph  # noqa: F401  (binds sp.csgraph)
import torch

import pyamg_tpu
import pyamg_tpu.aggregation.aggregate as jaggregate
import pyamg_tpu.aggregation.matching as jmatching
import pyamg_tpu.amg_core as jax_core
import pyamg_tpu.graph as jgraph
import pyamg_tpu_torch
from pyamg_tpu_torch import amg_core, graph
from pyamg_tpu_torch.aggregation import aggregate, matching
from pyamg_tpu_torch.gallery import poisson

from sa_cases import unstructured

torch.set_num_threads(1)


@pytest.fixture(params=["library", "python"])
def native(request, monkeypatch):
    """Both packages with their compiled libraries, or both without."""
    if request.param == "python":
        monkeypatch.setattr(amg_core, "_lib", False)
        monkeypatch.setattr(jax_core, "_lib", False)
    else:
        assert amg_core.have_native()
        monkeypatch.setattr(jax_core, "have_native", lambda: True)
        if not jax_core._load():
            pytest.fail("the JAX package's native library did not load")
    return request.param


def _reachable(G, seeds):
    """Whether a seed lies in each node's connected component."""
    _, comp = sp.csgraph.connected_components(G, directed=False)
    return np.isin(comp, comp[seeds])


def _disconnected():
    """Two 8^2 Poisson blocks with no edge between them."""
    P = poisson((8, 8), format="csr")
    return sp.block_diag([P, P], format="csr")


GRAPHS = {
    "poisson-16": lambda: poisson((16, 16), format="csr"),
    "unstructured": lambda: unstructured(300, seed=2),
    "disconnected": _disconnected,
}


@pytest.mark.parametrize("graph_name", sorted(GRAPHS))
@pytest.mark.parametrize("algo,k", [("serial", None), ("parallel", None),
                                    ("parallel", 2), ("serial", 3)])
def test_maximal_independent_set_matches_jax(graph_name, algo, k):
    G = GRAPHS[graph_name]()
    ours = graph.maximal_independent_set(G, algo, k)
    np.testing.assert_array_equal(ours,
                                  jgraph.maximal_independent_set(G, algo, k))
    assert ours.dtype == np.int32 and 0 < ours.sum() < G.shape[0]


@pytest.mark.parametrize("graph_name", sorted(GRAPHS))
def test_bellman_ford_matches_jax(graph_name, native):
    G = GRAPHS[graph_name]()
    seeds = np.random.default_rng(1).choice(G.shape[0] // 2, 7,
                                            replace=False)
    dist, nearest = graph.bellman_ford(G, seeds)
    jdist, jnearest = jgraph.bellman_ford(G, seeds)
    np.testing.assert_array_equal(dist, jdist)
    np.testing.assert_array_equal(nearest, jnearest)
    reached = nearest >= 0
    assert np.isfinite(dist[reached]).all() and np.isinf(dist[~reached]).all()
    np.testing.assert_array_equal(reached, _reachable(G, seeds))
    assert reached.all() == (graph_name == "poisson-16")
    if native == "library":
        for ours, ref in ((amg_core.bellman_ford_native(G, seeds),
                           jax_core.bellman_ford_native(G, seeds)),
                          (amg_core.bfs_levels_native(G, 3),
                           jax_core.bfs_levels_native(G, 3)),
                          (amg_core.drake_matching_native(G),
                           jax_core.drake_matching_native(G))):
            for a, b in zip(ours, ref):
                np.testing.assert_array_equal(a, b)
    else:
        assert amg_core.bellman_ford_native(G, seeds) is None
        assert amg_core.bfs_levels_native(G, 3) is None
        assert amg_core.drake_matching_native(G) is None


def test_lloyd_cluster_matches_jax(native):
    G = poisson((32, 32), format="csr")
    G.data = np.ones_like(G.data)
    for seeds in (np.random.default_rng(0).choice(1024, 31, replace=False),
                  12):
        ours = graph.lloyd_cluster(G, seeds)
        ref = jgraph.lloyd_cluster(G, seeds)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
    D = _disconnected()
    ours = graph.lloyd_cluster(D, np.array([3, 17]))
    ref = jgraph.lloyd_cluster(D, np.array([3, 17]))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    assert (ours[1][64:] == -1).all()


def _recenter_loop(dist, clusters, seeds):
    """The JAX package's recentering, word for word
    (``pyamg_tpu/graph.py:233-246``)."""
    new_seeds = seeds.copy()
    for ci, s in enumerate(seeds):
        members = np.flatnonzero(clusters == ci)
        if members.size == 0:
            continue
        far = members[int(np.argmax(dist[members]))]
        new_seeds[ci] = far
    return new_seeds


@pytest.mark.parametrize("seed", range(4))
def test_vectorized_recentering_equals_the_jax_loop(seed):
    rng = np.random.default_rng(seed)
    n, k = 400, 12
    # few distinct distances: many ties for the farthest member; clusters
    # 3 and 7 empty; unreached nodes (-1)
    dist = rng.integers(0, 4, n).astype(float)
    clusters = rng.choice([c for c in range(k) if c not in (3, 7)] + [-1],
                          n)
    dist[clusters < 0] = np.inf
    seeds = rng.choice(n, k, replace=False)
    np.testing.assert_array_equal(graph._recenter(dist, clusters, seeds),
                                  _recenter_loop(dist, clusters, seeds))


@pytest.mark.parametrize("graph_name", sorted(GRAPHS))
def test_matchings_and_labels_match_jax(graph_name, native):
    G = GRAPHS[graph_name]()
    for name in ("drake_matching", "preis_matching", "notay_matching",
                 "preis_matching_1999", "notay_matching_2010"):
        ours = getattr(matching, name)(G)
        np.testing.assert_array_equal(ours, getattr(jmatching, name)(G),
                                      err_msg=name)
        m = ours >= 0
        assert m.any() and (ours[ours[m]] == np.flatnonzero(m)).all()
        np.testing.assert_array_equal(
            aggregate._pairs_to_labels(ours, G.shape[0]),
            jaggregate._pairs_to_labels(ours, G.shape[0]))
    w = np.random.default_rng(4).random(G.nnz)
    np.testing.assert_array_equal(matching.drake_matching(G, weights=w),
                                  jmatching.drake_matching(G, weights=w))
    np.testing.assert_array_equal(matching.notay_matching(G, beta=0.5),
                                  jmatching.notay_matching(G, beta=0.5))
    # a partner array that is no involution: the same sequential labels
    pairs = np.random.default_rng(5).integers(-1, 50, 50)
    np.testing.assert_array_equal(aggregate._pairs_to_labels(pairs, 50),
                                  jaggregate._pairs_to_labels(pairs, 50))


def _same_operator(ours, ref):
    assert ours.shape == ref.shape
    assert abs(ours - ref).max() == 0 if ref.nnz else ours.nnz == 0


@pytest.mark.parametrize("graph_name", sorted(GRAPHS))
def test_lloyd_and_pairwise_aggregation_match_jax(graph_name, native):
    G = GRAPHS[graph_name]()
    for kw in (dict(), dict(ratio=0.1, distance="abs", seed=2),
               dict(distance="inv"), dict(distance="same"),
               dict(distance="sub", maxiter=3)):
        (agg, seeds), (jagg, jseeds) = (
            aggregate.lloyd_aggregation(G, **kw),
            jaggregate.lloyd_aggregation(G, **kw))
        _same_operator(agg, jagg)
        np.testing.assert_array_equal(seeds, jseeds)
    # a node that no seed reaches lies in no aggregate: a zero row
    agg, seeds = aggregate.lloyd_aggregation(G, ratio=0.01)
    reached = _reachable(G, seeds)
    np.testing.assert_array_equal(np.diff(agg.indptr) > 0, reached)
    assert reached.all() == (graph_name == "poisson-16")
    for kw in (dict(), dict(matchings=1, algorithm="preis"),
               dict(matchings=3, algorithm="notay")):
        (agg, none), (jagg, _) = (aggregate.pairwise_aggregation(G, **kw),
                                  jaggregate.pairwise_aggregation(G, **kw))
        _same_operator(agg, jagg)
        assert none is None
    with pytest.raises(ValueError, match="ratio"):
        aggregate.lloyd_aggregation(G, ratio=0.0)
    with pytest.raises(ValueError, match="distance"):
        aggregate.lloyd_aggregation(G, distance="far")
    with pytest.raises(ValueError, match="matching"):
        aggregate.pairwise_aggregation(G, algorithm="greedy")


@pytest.mark.parametrize("kw", [
    dict(aggregate="lloyd"),
    dict(aggregate=("pairwise", {"matchings": 2})),
], ids=["lloyd", "pairwise"])
def test_sa_with_lloyd_and_pairwise_takes_the_jax_cg_iterations(kw, native):
    A = sp.csr_matrix(poisson((40, 40), format="csr").tocoo())
    ours = pyamg_tpu_torch.smoothed_aggregation_solver(
        A, max_coarse=40, device="cpu", **kw)
    ref = pyamg_tpu.smoothed_aggregation_solver(A.copy(), max_coarse=40,
                                                **kw)
    assert len(ours.levels) == len(ref.levels) >= 3
    for lo, lr in zip(ours.levels, ref.levels):
        assert lo.A_csr.shape == lr.A_csr.shape
        assert abs(lo.A_csr - lr.A_csr).max() <= 1e-10 * abs(lr.A_csr).max()
    for lo, lr in zip(ours.levels[:-1], ref.levels[:-1]):
        assert abs(lo.P_csr - lr.P_csr).max() <= 1e-10 * abs(lr.P_csr).max()
    b = A @ np.random.default_rng(0).random(A.shape[0])
    res, jres = [], []
    x = ours.solve(b, tol=1e-8, accel="cg", residuals=res)
    ref.solve(b, tol=1e-8, accel="cg", residuals=jres)
    assert len(res) == len(jres) > 3
    np.testing.assert_allclose(res, jres, rtol=1e-8)
    assert np.linalg.norm(b - A @ x.numpy()) <= 1e-8 * np.linalg.norm(b)
