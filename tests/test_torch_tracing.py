"""The port's own spans and counters (``pyamg_tpu_torch.util.profiling``).

* a fine span with no profiler running records nothing and never enters
  ``record_function``;
* under a CPU ``torch.profiler`` the fine spans are recorded with their
  parents and sit in the exported Chrome trace as ``pyamg_tpu_torch.*``
  events;
* both timed constructors carry a set-up log that names every stage,
  with host stages that never overlap;
* ``solve_mp(method="defect")`` reads the device 1 + rounds + inner
  iterations times, every read through ``profiling.read_back``, and its x
  is bitwise the x of a solve whose reads are plain ``.item()`` calls;
* the solve log keeps within its cap, the set-up records kept;
* every masked product of a general set-up is one ``spgemm`` span with
  its route and widths, under ``smooth_p`` or ``galerkin``; on the CPU it
  carries no device time, and the products of HPCG's 27-point operator
  wider than 64 slots count in ``spgemm_wide``; the set-up reads nothing
  back through ``read_back`` and the solve's reads stay as they were;
* on the card (marked ``cuda``), torch's sync debug mode finds exactly
  ``info["host_syncs"]`` synchronizing calls in a warm solve, each one in
  ``read_back``; the set-up's products carry their device times.
"""

import collections
import json
import warnings

import numpy as np
import pytest
import torch

from pyamg_tpu_torch.aggregation.device_setup import structured_sa_setup
from pyamg_tpu_torch.gallery import poisson, stencil_grid
from pyamg_tpu_torch.parallel.setup import general_sa_setup_sharded
from pyamg_tpu_torch.util import profiling

GRID = (40, 40)
CONSTRUCTORS = {"structured": "structured_sa_setup",
                "general": "general_sa_setup_sharded"}
FINE = {"cycle", "smooth", "coarse_solve", "sync"}
STAGES = {
    "structured": ({"rho", "smoothing", "tentative", "rap"},
                   {"probe_tables", "masks", "coarsest_csr"}),
    "general": ({"upload", "rho", "smooth_p", "galerkin"},
                {"strength", "aggregate", "fit_candidates", "patterns",
                 "coloring"}),
}


def build(kind, grid=GRID, device="cpu"):
    """The hierarchy whose ``solve_mp`` a caller runs, and its rows."""
    A = poisson(grid, format="csr")
    if kind == "structured":
        return structured_sa_setup(A, grid=grid, max_coarse=20,
                                   device=device), A.shape[0]
    return general_sa_setup_sharded(A, max_coarse=20,
                                    device=device).inner, A.shape[0]


def rhs(ml, seed=0):
    n = ml.levels[0].A.shape[0]
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(n),
                           device=ml.device)


def by_id(records):
    return {r[0]: r for r in records}


def test_fine_span_off_records_nothing(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.fine("cycle", level=0) is profiling.fine("sync")
    ml, _ = build("structured")
    ml.solve_mp(rhs(ml), tol=1e-10, method="defect")
    names = collections.Counter(r[2] for r in ml.span_log.solves)
    assert names == {"solve_mp": 1}
    with profiling.fine("cycle", level=0) as sp:
        assert sp is None


def test_enable_records_fine_spans_without_a_profiler():
    ml, _ = build("structured")
    was = profiling.enable()
    try:
        _x, info = ml.solve_mp(rhs(ml), tol=1e-10, method="defect",
                               return_info=True)
    finally:
        profiling.enable(was)
    names = collections.Counter(r[2] for r in ml.span_log.solves)
    assert names["sync"] == info["host_syncs"] and names["cycle"] > 0


def test_fine_spans_under_a_profiler(tmp_path):
    ml, _ = build("structured")
    nlev = len(ml.levels)
    b = rhs(ml)
    ml.solve_mp(b, tol=1e-10, method="defect")      # the one-off builds
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _x, info = ml.solve_mp(b, tol=1e-10, method="defect",
                               return_info=True)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))

    recs = [r for r in ml.span_log.solves]
    ids = by_id(recs)
    top = [r for r in recs if r[2] == "solve_mp"][-1]
    traced = [r for r in recs if r[0] > top[0] or r is top]
    counts = collections.Counter(r[2] for r in traced)
    # a V-cycle: a span a level above the coarsest, two smoothings each,
    # one coarse solve; one cycle a Krylov iteration
    cycles = info["inner_iterations"]
    assert counts["cycle"] == cycles * (nlev - 1)
    assert counts["smooth"] == 2 * cycles * (nlev - 1)
    assert counts["coarse_solve"] == cycles
    assert counts["sync"] == info["host_syncs"]
    for r in traced:
        if r is top:
            continue
        parent = ids[r[1]]
        assert parent[3] <= r[3] and r[4] <= parent[4]
        if r[2] == "sync" or (r[2] == "cycle" and r[5]["level"] == 0):
            assert parent is top
        elif r[2] == "cycle":
            assert parent[2] == "cycle"
            assert parent[5]["level"] == r[5]["level"] - 1
        elif r[2] == "smooth":
            assert parent[2] == "cycle"
            assert parent[5]["level"] == r[5]["level"]
            assert r[5]["side"] in ("pre", "post")
        elif r[2] == "coarse_solve":
            assert parent[2] == "cycle"
            assert parent[5]["level"] == nlev - 2
    assert top[5] == info

    events = json.loads(path.read_text())["traceEvents"]
    names = collections.Counter(
        e["name"][len(profiling.PREFIX):] for e in events
        if e.get("ph") == "X" and e.get("cat") == "user_annotation"
        and e.get("name", "").startswith(profiling.PREFIX))
    for name in FINE | {"solve_mp"}:
        assert names[name] == counts[name], name


@pytest.mark.parametrize("kind", ["structured", "general"])
def test_setup_log_names_every_stage(kind):
    ml, n = build(kind)
    recs = ml.span_log.setup
    ids = by_id(recs)
    (setup,) = [r for r in recs if r[2] == "setup"]
    assert setup[5] == {"constructor": CONSTRUCTORS[kind], "rows": n}
    levels = [r for r in recs if r[2] == "setup.level"]
    assert [r[5]["level"] for r in levels] == list(range(len(ml.levels) - 1))
    assert [r[5]["rows"] for r in levels] == \
        [lvl.host_A().shape[0] for lvl in ml.levels[:-1]]
    device, host = STAGES[kind]
    stages = [r for r in recs if "host" in r[5]]
    assert {r[2] for r in stages if r[5]["host"] is False} == device
    assert {r[2] for r in stages if r[5]["host"] is True} == host

    def inside(r, name):
        while r[1] is not None and r[1] in ids:
            r = ids[r[1]]
            if r[2] == name:
                return True
        return False

    for r in stages:
        assert inside(r, "setup")
        assert r[2] == "coarsest_csr" or inside(r, "setup.level")
    hosts = sorted((r[3], r[4]) for r in stages if r[5]["host"] is True)
    for (_s0, e0), (s1, _e1) in zip(hosts, hosts[1:]):
        assert e0 <= s1


@pytest.mark.parametrize("kind", ["structured", "general"])
def test_host_syncs_and_the_answer(kind, monkeypatch):
    ml, _ = build(kind)
    b = rhs(ml, 1)
    x, info = ml.solve_mp(b, tol=1e-10, method="defect", return_info=True)
    assert info["host_syncs"] == 1 + info["rounds"] + \
        info["inner_iterations"]
    assert [r for r in ml.span_log.setup
            if r[2] == "solve_mp.operator64"]

    # the reads as they were before they went through read_back: each
    # caller looks it up through the module, so this sees every read
    reads = []

    def plain(t, site):
        reads.append(site)
        return t.item() if t.dim() == 0 else t.cpu().numpy()

    monkeypatch.setattr(profiling, "read_back", plain)
    x_plain, info_plain = ml.solve_mp(b, tol=1e-10, method="defect",
                                      return_info=True)
    assert len(reads) == info["host_syncs"]
    assert info_plain["host_syncs"] == 0
    assert torch.equal(x, x_plain)
    monkeypatch.undo()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        x_traced = ml.solve_mp(b, tol=1e-10, method="defect")
    assert torch.equal(x, x_traced)


def hpcg27(N):
    """HPCG's 27-point operator (26 on the diagonal, -1 off it) on N^3."""
    S = -np.ones((3, 3, 3))
    S[1, 1, 1] = 26.0
    return stencil_grid(S, (N, N, N), format="csr")


@pytest.mark.parametrize("operator", ["poisson", "hpcg27"])
def test_general_setup_records_each_product(operator):
    if operator == "poisson":
        A, kw = poisson(GRID, format="csr"), {}
    else:
        A, kw = hpcg27(12), {"max_coarse": 20}
    wide = profiling.counters.get("spgemm_wide", 0)
    syncs = profiling.counters["host_syncs"]
    ml = general_sa_setup_sharded(A, device="cpu", **kw).inner
    assert profiling.counters["host_syncs"] == syncs
    recs = ml.span_log.setup
    ids = by_id(recs)
    prods = [r for r in recs if r[2] == "spgemm"]
    # S T under smooth_p, then A P and R (A P) under galerkin, a level
    # above the coarsest
    levels = ml.levels[:-1]
    assert [ids[r[1]][2] for r in prods] == \
        ["smooth_p", "galerkin", "galerkin"] * len(levels)
    for lvl, (st, ap, rap) in zip(levels, zip(*[iter(prods)] * 3)):
        n, nc = lvl.A.shape[0], lvl.R.shape[0]
        for r in (st, ap, rap):
            a = r[5]
            assert set(a) == {"route", "n", "nb", "w_a", "w_b", "w_out",
                              "dtype"}
            assert a["route"] == "plain"          # no kernel on the CPU
            assert a["dtype"] == "float32"
        assert (st[5]["n"], st[5]["nb"], st[5]["w_a"], st[5]["w_b"],
                st[5]["w_out"]) == (n, n, lvl.A.width, 1, lvl.P.width)
        assert (ap[5]["n"], ap[5]["nb"], ap[5]["w_a"], ap[5]["w_b"]) == \
            (n, n, lvl.A.width, lvl.P.width)
        assert (rap[5]["n"], rap[5]["nb"], rap[5]["w_a"], rap[5]["w_b"]) \
            == (nc, n, lvl.R.width, ap[5]["w_out"])
    n_wide = sum(max(r[5]["w_a"], r[5]["w_b"], r[5]["w_out"]) > 64
                 for r in prods)
    assert profiling.counters.get("spgemm_wide", 0) - wide == n_wide
    if operator == "hpcg27":
        assert prods[2][5]["w_a"] >= 125 and n_wide >= 1
    else:
        assert n_wide == 0
    b = rhs(ml)
    _x, info = ml.solve_mp(b, tol=1e-10, method="defect", return_info=True)
    assert info["host_syncs"] == 1 + info["rounds"] + \
        info["inner_iterations"]


def test_device_events_make_no_event_on_the_cpu(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a CUDA event made off the card")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    log = profiling.SpanLog()
    with profiling.span("setup", into=log.setup):
        with profiling.span("spgemm"):
            with profiling.device_events(torch.device("cpu")) as ev:
                assert ev is None
    with profiling.span("spgemm"):               # records nowhere
        with profiling.device_events("cuda") as ev:
            assert ev is None
    with profiling.device_events("cuda") as ev:  # no span open
        assert ev is None
    assert profiling._pending_events == []
    profiling.resolve_device_times()
    assert "device_us" not in log.setup[0][5]


def test_solve_log_keeps_its_cap(monkeypatch):
    monkeypatch.setattr(profiling.SpanLog, "CAP", 200)
    ml, _ = build("structured")
    b = rhs(ml)
    ml.solve_mp(b, tol=1e-10, method="defect")
    setup = list(ml.span_log.setup)      # with the first solve's builds
    was = profiling.enable()
    try:
        for _ in range(4):
            ml.solve_mp(b, tol=1e-10, method="defect")
    finally:
        profiling.enable(was)
    assert len(ml.span_log.solves) == 200
    assert ml.span_log.setup == setup
    assert ml.span_log.records()[:len(setup)] == setup
    assert ml.span_log.solves[-1][2] == "solve_mp"


def test_counters():
    before = profiling.counters.get("test_counter", 0)
    profiling.count("test_counter")
    profiling.count("test_counter", 4)
    assert profiling.counters["test_counter"] == before + 5
    n = profiling.counters["host_syncs"]
    assert profiling.read_back(torch.tensor(2.5), "test") == 2.5
    v = torch.arange(3.0)
    out = profiling.read_back(v, "test")
    assert isinstance(out, np.ndarray) and out.tolist() == [0.0, 1.0, 2.0]
    out[0] = 7.0                       # a copy: the tensor keeps its value
    assert v[0] == 0.0
    assert profiling.counters["host_syncs"] == n + 2


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["structured", "general"])
def test_every_sync_of_a_solve_is_a_read_back_on_the_card(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ml, _ = build(kind, grid=(256, 256), device="cuda")
    b = rhs(ml)
    ml.solve_mp(b, tol=1e-10, method="defect")      # the one-off builds
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _x, info = ml.solve_mp(b, tol=1e-10, method="defect",
                                   return_info=True)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # the mode may flag its own switch, in torch.cuda
    sites = [w.filename for w in caught if "synchroniz" in str(w.message)
             and w.filename != torch.cuda.__file__]
    assert sites == [profiling.__file__] * info["host_syncs"]
    assert info["host_syncs"] == 1 + info["rounds"] + \
        info["inner_iterations"]


@pytest.mark.cuda
def test_setup_products_carry_device_times_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ml = general_sa_setup_sharded(hpcg27(15), max_coarse=20,
                                  device="cuda").inner
    prods = [r[5] for r in ml.span_log.setup if r[2] == "spgemm"]
    assert prods and all(p["device_us"] > 0 for p in prods)
    assert profiling._pending_events == []
    # S T, A P and R (A P) a level: A P on the banded kernel; level 0's R
    # (125 wide) has as many offsets as rows, so the gather kernel
    assert len(prods) == 3 * (len(ml.levels) - 1)
    assert all(p["route"] == "banded" for p in prods[1::3])
    assert prods[2]["route"] == "gather" and prods[2]["w_a"] >= 125
