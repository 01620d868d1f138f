"""The readers of the program's own spans (``program_spans.py`` and its five
metrics) on logs and traces made by hand, and the clock alignment under a
real profiler on the CPU."""

import collections
import gc
import json
import types

import numpy as np
import pytest
import torch

from amgbench import program_spans, spec
from amgbench.harness import Record
from amgbench.trace import Trace

METRICS = ("setup_host_s", "operator64_s", "host_syncs_per_solve",
           "sync_idle_pct", "coarse_idle_pct")
US = 1000          # program records are in nanoseconds


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def rec(i, parent, name, start_us, end_us, **attrs):
    return (i, parent, name, start_us * US, end_us * US, attrs)


def solve_records(base, first_id):
    """One traced solve at program time ``base`` us: a read-back, a V-cycle
    of two levels above the coarsest, with a read-back in the coarse
    solve."""
    i = first_id
    return [
        rec(i + 1, i, "sync", base + 10, base + 20, site="cg.res"),
        rec(i + 3, i + 2, "smooth", base + 20, base + 30, level=0,
            side="pre"),
        rec(i + 5, i + 4, "smooth", base + 40, base + 50, level=1,
            side="pre"),
        rec(i + 7, i + 6, "sync", base + 52, base + 58, site="coarse.host"),
        rec(i + 6, i + 4, "coarse_solve", base + 50, base + 60),
        rec(i + 4, i + 2, "cycle", base + 40, base + 70, level=1),
        rec(i + 2, i, "cycle", base + 20, base + 90, level=0),
        rec(i, None, "solve_mp", base, base + 100, rounds=1,
            inner_iterations=2, host_syncs=2),
    ]


def made_log():
    """A set-up of 1 s of host stages (0.25 + 0.75; a device stage and a
    read-back beside them), a float64 operator of 2.5 s, an untraced solve
    and one traced solve at program time 500-600 us."""
    setup = [
        rec(3, 2, "strength", 0, 250_000, host=True),
        rec(4, 2, "upload", 250_000, 300_000, host=False),
        rec(5, 2, "readback", 300_000, 400_000, host=None),
        rec(6, 2, "coloring", 400_000, 1_150_000, host=True),
        rec(2, 1, "setup.level", 0, 1_200_000, level=0, rows=100),
        rec(1, None, "setup", 0, 1_300_000, constructor="c", rows=100),
        rec(8, 7, "solve_mp.operator64", 1_400_000, 3_900_000),
    ]
    solves = [rec(7, None, "solve_mp", 1_400_000, 4_000_000, rounds=1,
                  inner_iterations=2, host_syncs=2)]
    solves += solve_records(500 + 4_000_000, 100)
    return types.SimpleNamespace(setup=setup, solves=solves)


OFFSET = 1000.0     # trace time minus program time, us


def made_trace(base=4_000_500):
    """The traced solve on the trace's clock, its ``solve`` span opened
    with the program's ``solve_mp``; device busy but for gaps that open
    in the first read-back (6 us), in level 0's smoothing (2), in level
    1's smoothing (2), in the coarse solve's read-back (4) and after the
    cycle (10)."""
    t = base + OFFSET
    busy = [(t - 20, t + 15), (t + 21, t + 25), (t + 27, t + 45),
            (t + 47, t + 55), (t + 59, t + 95), (t + 105, t + 400)]
    return Trace([ev("user_annotation", "amgbench.stretch", t - 20, 420),
                  ev("user_annotation", "amgbench.solve", t, 100)]
                 + [ev("kernel", "k", s, e - s) for s, e in busy])


def made_record(log=None, trace=True):
    r = Record()
    log = made_log() if log is None else log
    r.calls = {"program": [log, log, None]}     # two metrics' hooks
    r.trace = made_trace() if trace else None
    r.stretch_infos = [{"rounds": 2, "inner_iterations": 16,
                        "host_syncs": 19},
                       {"rounds": 2, "inner_iterations": 17,
                        "host_syncs": 20}]
    return r


def test_a_known_offset_is_recovered():
    sol = [rec(i, None, "solve_mp", s, s + 50) for i, s in
           enumerate((0, 200, 400))]
    # the trace's spans on another clock; one opens late by 40 us
    trace = [(s + 12_345.0, s + 12_400.0) for s in (0, 200, 400)]
    trace[1] = (trace[1][0] + 40, trace[1][1])
    assert program_spans.offset_us(sol, trace) == pytest.approx(12_345.0)
    assert program_spans.offset_us(sol, trace[:2]) is None
    assert program_spans.offset_us([], []) is None


def test_the_traced_solves_and_their_clock():
    r = made_record()
    assert program_spans.logs(r) == [r.calls["program"][0]]
    spans = program_spans.align(r)
    assert spans.offset == pytest.approx(OFFSET)
    # the untraced solve holds no fine span: it is left out
    assert {x[0] for x in spans.recs} == set(range(100, 108))
    t = 4_000_500 + OFFSET
    assert [x[2] for x in spans.holder(t + 55)] == [
        "sync", "coarse_solve", "cycle", "cycle", "solve_mp"]
    assert [x[2] for x in spans.holder(t + 95)] == ["solve_mp"]
    assert spans.holder(t - 5) == []
    assert spans.holder(t + 101) == []


def test_gaps_split_three_ways():
    shares = program_spans.idle_shares(made_record())
    # 24 us idle: 10 in read-backs, 2 on level 1, 12 elsewhere
    assert shares["sync"] == pytest.approx(100 * 10 / 24)
    assert shares["coarse"] == pytest.approx(100 * 2 / 24)
    assert shares["rest"] == pytest.approx(100 * 12 / 24)
    assert sum(shares.values()) == pytest.approx(100.0)


def test_readers():
    r = made_record()
    got = {m: spec.metric_reader(m).read(r) for m in METRICS}
    assert got["setup_host_s"] == pytest.approx(1.0)
    assert got["operator64_s"] == pytest.approx(2.5)
    assert got["host_syncs_per_solve"] == 19.5
    assert got["sync_idle_pct"] == pytest.approx(100 * 10 / 24)
    assert got["coarse_idle_pct"] == pytest.approx(100 * 2 / 24)
    for m in METRICS:
        if m != "host_syncs_per_solve":
            assert spec.metric_reader(m).HOOKS == program_spans.HOOKS


def test_readers_find_nothing():
    # no trace, as on the CPU: the idle shares give nothing
    r = made_record(trace=False)
    assert spec.metric_reader("sync_idle_pct").read(r) is None
    assert spec.metric_reader("coarse_idle_pct").read(r) is None
    # a trace with no device work
    r = made_record()
    r.trace = Trace([ev("user_annotation", "amgbench.stretch", 0, 100),
                     ev("user_annotation", "amgbench.solve", 10, 50)])
    assert spec.metric_reader("sync_idle_pct").read(r) is None
    # a program without spans: the hook finds no log, solve_mp no count
    r = made_record()
    r.calls = {"program": [None, None]}
    r.stretch_infos = [{"rounds": 2, "inner_iterations": 16}]
    for m in METRICS:
        assert spec.metric_reader(m).read(r) is None, m
    # a log with no traced solve: nothing to align
    log = made_log()
    log.solves = log.solves[:1]
    assert spec.metric_reader("sync_idle_pct").read(
        made_record(log)) is None
    assert spec.metric_reader("setup_host_s").read(
        made_record(log)) == pytest.approx(1.0)
    # no set-up span: a hierarchy no timed constructor built
    log = made_log()
    log.setup = [x for x in log.setup if x[2] == "solve_mp.operator64"]
    assert spec.metric_reader("operator64_s").read(made_record(log)) is None
    for m in METRICS:
        assert spec.metric_reader(m).read(Record()) is None, m


def test_alignment_under_a_real_profiler(tmp_path):
    """Each traced program span, put on the trace's clock by the
    ``solve`` spans alone, lies within 50 us of the profiler's own
    ``pyamg_tpu_torch.*`` event of it: every span of a solve, by its median
    over the stretch's like solves (the host's scheduler may stall one of
    them inside a span's opening or closing)."""
    from amgbench.harness import hooked, span
    from pyamg_tpu_torch.aggregation.device_setup import structured_sa_setup
    from pyamg_tpu_torch.gallery import poisson

    A = poisson((30, 30), format="csr")
    ml, warm = (structured_sa_setup(A, grid=(30, 30), max_coarse=20,
                                    device="cpu") for _ in range(2))
    b = torch.as_tensor(np.random.default_rng(0).standard_normal(900))
    ml.solve_mp(b, tol=1e-10, method="defect")
    r = Record()
    solves = 5
    gc.collect()
    gc.disable()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            # the profiler's first events of each name cost more: another
            # solver's solve meets them, outside the stretch
            warm.solve_mp(b, tol=1e-10, method="defect")
            with hooked(program_spans.HOOKS, r.calls), span("stretch"):
                for _ in range(solves):
                    with span("generate"):
                        torch.ones(4).sum()
                    with span("solve"):
                        ml.solve_mp(b, tol=1e-10, method="defect")
    finally:
        gc.enable()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    r.trace = Trace.load(path)
    spans = program_spans.align(r)
    assert spans is not None

    events = collections.defaultdict(list)
    for e in json.loads(path.read_text())["traceEvents"]:
        name = e.get("name", "")
        if e.get("ph") == "X" and name.startswith("pyamg_tpu_torch."):
            events[name[len("pyamg_tpu_torch."):]].append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    mine = collections.defaultdict(list)
    for x in spans.recs:
        mine[x[2]].append(spans.span_us(x))
    assert set(mine) == set(program_spans.FINE) | {"solve_mp"}
    for name, ivs in mine.items():
        theirs = sorted(events[name])[-len(ivs):]
        assert len(theirs) == len(ivs) and len(ivs) % solves == 0
        err = np.abs(np.array(sorted(ivs)) - np.array(theirs)).max(axis=1)
        by_span = np.median(err.reshape(solves, -1), axis=0)
        assert by_span.max() <= 50.0, (name, by_span.max())
