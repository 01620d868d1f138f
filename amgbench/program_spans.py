"""The program's own spans, read beside the profiler's trace.

``pyamg_tpu_torch`` keeps its spans in memory on the hierarchy
(``util/profiling.py``): each record is ``(id, parent, name, start_ns,
end_ns, attrs)`` on ``time.perf_counter_ns()``, in the solver's
``span_log``, whose ``setup`` part holds the constructor's stages and
the first solve's one-off builds and whose ``solves`` part the solves'
spans.  The fine spans (``cycle``, ``smooth``, ``coarse_solve``,
``sync``) are there only for solves run under a profiler: the traced
stretch's.

``HOOKS`` keeps, for each ``solve_mp`` call of the stretch, a reference
to the log of the solver it is called on (never the solver); the readers
take each log once, however many metrics installed the hook.

The trace runs on the profiler's clock.  The stretch's ``solve_mp``
spans that hold fine spans pair in order with the trace's ``solve``
spans; the median difference of their starts is the offset between the
two clocks.  A device-idle gap of the trace then belongs to the
innermost program span that holds its start.

A program without these spans gives no log and no ``host_syncs``: the
readers then return None.
"""

from __future__ import annotations

import bisect
import statistics

FINE = ("cycle", "smooth", "coarse_solve", "sync")


def _log_of(solver, *args, **kwargs):
    return getattr(solver, "span_log", None)


HOOKS = [{"name": "program",
          "target": "pyamg_tpu_torch.multilevel:MultilevelSolver.solve_mp",
          "record": _log_of}]


def logs(record):
    """The distinct span logs the hook saw, in the order first seen."""
    seen, out = set(), []
    for log in record.calls.get("program", []):
        if log is not None and id(log) not in seen:
            seen.add(id(log))
            out.append(log)
    return out


def served_log(record):
    """The log of the last solver the stretch solved on, or None."""
    found = logs(record)
    return found[-1] if found else None


def setup_seconds(record, keep):
    """Seconds of the served solver's set-up records ``keep`` selects,
    summed; None without a set-up log."""
    log = served_log(record)
    if log is None or not any(r[2] == "setup" for r in log.setup):
        return None
    return sum(r[4] - r[3] for r in log.setup if keep(r)) * 1e-9


def traced_solves(log):
    """The program's records of the traced solves: the ``solve_mp``
    records that hold fine spans, and those fine spans."""
    recs = [r for r in log.solves if r[2] in FINE]
    holders = {r[1] for r in recs}
    return [r for r in log.solves if r[2] == "solve_mp" and r[0] in holders]\
        + recs


def offset_us(program_solves, trace_solves):
    """Trace time minus program time in microseconds: the median
    difference of the starts of the pairs, in order; None when the counts
    differ."""
    if not program_solves or len(program_solves) != len(trace_solves):
        return None
    return statistics.median(t[0] - p[3] * 1e-3 for p, t in
                             zip(sorted(program_solves, key=lambda r: r[3]),
                                 sorted(trace_solves)))


class Aligned:
    """Program spans on the trace's clock: ``holder(t)``, the chain of
    spans that hold trace time ``t``, innermost first."""

    def __init__(self, records, offset):
        self.offset = offset
        self.recs = sorted(records, key=lambda r: r[3])
        self.starts = [r[3] * 1e-3 + offset for r in self.recs]
        self.by_id = {r[0]: r for r in self.recs}

    def span_us(self, r):
        return r[3] * 1e-3 + self.offset, r[4] * 1e-3 + self.offset

    def holder(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        if i < 0:
            return []
        r = self.recs[i]
        # spans nest: the last to start before t, or one of its parents,
        # is the innermost that holds t
        while r is not None and self.span_us(r)[1] < t:
            r = self.by_id.get(r[1])
        chain = []
        while r is not None:
            chain.append(r)
            r = self.by_id.get(r[1])
        return chain


def align(record):
    """The served log's traced solves on the trace's clock, or None."""
    tr, log = record.trace, served_log(record)
    if tr is None or log is None:
        return None
    recs = traced_solves(log)
    mine = [r for r in recs if r[2] == "solve_mp"]
    off = offset_us(mine, tr.in_stretch(tr.spans.get("solve", [])))
    return None if off is None else Aligned(recs, off)


def kind_of(chain):
    """``sync`` for a gap that opens in a read-back; ``coarse`` in a
    cycle of level 1 or below and no read-back; else ``rest``."""
    if chain and chain[0][2] == "sync":
        return "sync"
    for r in chain:
        if r[2] == "cycle":
            return "coarse" if r[5].get("level", 0) >= 1 else "rest"
    return "rest"


def idle_shares(record):
    """Percent of the stretch's device-idle time in gaps that open in a
    read-back (``sync``), on a coarse level (``coarse``) and elsewhere
    (``rest``); None without device work, a log or an alignment."""
    tr = record.trace
    if tr is None or tr.busy_us() <= 0:
        return None
    spans = align(record)
    if spans is None:
        return None
    out = {"sync": 0.0, "coarse": 0.0, "rest": 0.0}
    for s, e in tr.idle_gaps():
        out[kind_of(spans.holder(s))] += e - s
    total = sum(out.values())
    if total <= 0:
        return None
    return {k: 100.0 * v / total for k, v in out.items()}
