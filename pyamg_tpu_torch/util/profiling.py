"""Profiling: the program's own spans and counters, a device trace, the
time of one cycle, a timed solve, and the extremal eigenvalues of each
level.

Port of ``pyamg_tpu/util/profiling.py``.  ``trace`` records with
``torch.profiler`` (CPU activity, and CUDA activity where a card is
present) and writes a Chrome trace; ``profile_cycles`` times the eager
cycle, synchronizing the card before each clock read.

Spans and counters (the JAX package compiles a solve into one program and
has none).  ``span(name, **attrs)`` times a block on
``time.perf_counter_ns()``; its record is ``(id, parent, name, start_ns,
end_ns, attrs)``, the parent the innermost span open on this thread.  A
record goes into the container its span names (``into``), else into that
of the innermost open span with one, else nowhere.  Two tiers:

* ``span``: coarse spans, always timed -- a constructor's set-up and its
  stages, ``solve_mp`` (one a call) and its one-off builds; a few dozen a
  constructor, one a solve, a few microseconds each.
* ``fine``: fine spans, timed only while a ``torch.profiler`` records or
  after ``enable()`` -- the cycle's levels, smoothing, the coarse solve
  and every read-back; otherwise one boolean test that returns a shared
  null context.

While a profiler records, every span also enters
``torch.profiler.record_function("pyamg_tpu_torch.<name>")``, so that it
sits in the profiler's trace beside the device work it launched.  A
hierarchy keeps its records in its :class:`SpanLog` (``span_log``); a
constructor wrapped by :func:`setup_spans` puts its set-up's there.

``count(name, n)`` adds to ``counters``.  ``read_back(t, site)`` is the
one place the solve path reads the device: it counts ``host_syncs`` and
records a fine ``sync`` span.

``device_events(device)`` gives a pair of CUDA events for the innermost
open span, which a kernel's launcher records around its kernel; the events
are read by :func:`resolve_device_times`, which a set-up calls where it
already waits on the device, and give that span's attribute
``device_us``.  No event is made on the CPU or for a span that records
nowhere.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import threading
import time

import numpy as np
import torch

__all__ = ["profile_cycles", "trace", "hierarchy_spectrum", "solve_timings",
           "span", "fine", "enable", "count", "counters", "read_back",
           "SpanLog", "setup_spans", "device_events", "resolve_device_times"]

PREFIX = "pyamg_tpu_torch."

counters = {"host_syncs": 0}

_fine_on = False
_ids = itertools.count(1)
# (attrs, start, end) of the device-timed spans whose events are not read
_pending_events = []
_local = threading.local()
_profiler_enabled = torch.autograd._profiler_enabled


class _Null:
    """The context of a fine span that is not timed: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _open_spans():
    """The spans open on this thread, innermost last."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class SpanLog:
    """The span records of one hierarchy: ``setup``, those of its
    constructor and its one-off builds (the first solve's float64
    operator, the coarse solver), kept whole; ``solves``, those of its
    solves, the last ``CAP``."""

    CAP = 16384

    def __init__(self):
        self.setup = []
        self.solves = collections.deque(maxlen=self.CAP)

    def records(self):
        """Every record: the set-up's, then the solves'; each part in the
        order its spans ended."""
        return list(self.setup) + list(self.solves)


class _Span:
    """One open span; ``attrs`` may be added to until it ends."""

    __slots__ = ("name", "into", "attrs", "id", "parent", "start", "_rf")

    def __init__(self, name, into, attrs):
        self.name, self.into, self.attrs = name, into, attrs
        self._rf = None

    def __enter__(self):
        stack = _open_spans()
        self.parent = None
        if stack:
            self.parent = stack[-1].id
            if self.into is None:
                self.into = stack[-1].into
        self.id = next(_ids)
        stack.append(self)
        # under a profiler, the span runs from the end of its event's
        # opening to the end of its closing: both sides of the event's
        # own cost alike, so a shift of the clock lines the two up
        if _profiler_enabled():
            self._rf = torch.profiler.record_function(PREFIX + self.name)
            self._rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
        end = time.perf_counter_ns()
        _open_spans().pop()
        if self.into is not None:
            self.into.append((self.id, self.parent, self.name, self.start,
                              end, self.attrs))
        return False


def setup_spans(constructor):
    """``constructor(A, ...)`` timed as the span ``setup`` (attributes its
    name and A's rows); the records of that span and of those inside it
    go into a new :class:`SpanLog` that the hierarchy it returns keeps as
    ``span_log`` (a ``ShardedSolver``'s ``inner`` solver, whose solves
    its callers run)."""
    @functools.wraps(constructor)
    def timed(A, *args, **kwargs):
        log = SpanLog()
        with span("setup", into=log.setup, constructor=constructor.__name__,
                  rows=int(A.shape[0])):
            built = constructor(A, *args, **kwargs)
        # events still running are dropped: waiting for them would add a
        # synchronization to the set-up
        resolve_device_times()
        _pending_events.clear()
        getattr(built, "inner", built).span_log = log
        return built
    return timed


def span(name, into=None, **attrs):
    """A coarse span: always timed.  ``into``: the container of its
    record (a list, or a :class:`SpanLog`'s part), by default that of the
    innermost open span."""
    return _Span(name, into, attrs)


def fine(name, **attrs):
    """A fine span: a :func:`span` while a ``torch.profiler`` records or
    after :func:`enable`, else a shared null context."""
    if _fine_on or _profiler_enabled():
        return _Span(name, None, attrs)
    return _NULL


def enable(on=True):
    """Time the fine spans also with no profiler recording (``on``), or
    only under one again; returns the previous setting."""
    global _fine_on
    was, _fine_on = _fine_on, bool(on)
    return was


def count(name, n=1):
    """Add ``n`` to the counter ``name``."""
    counters[name] = counters.get(name, 0) + n


@contextlib.contextmanager
def device_events(device):
    """A pair of CUDA events on ``device`` for the innermost open span,
    where it records somewhere and ``device`` is a card, else None: the
    block records them around its launch (a kernel's own launcher records
    them around the kernel alone), and :func:`resolve_device_times` puts
    the microseconds between them into the span's ``attrs["device_us"]``.
    Each is recorded here once on the current stream so that it exists; a
    block that does not record them again times itself, host time
    included."""
    stack = _open_spans()
    s = stack[-1] if stack else None
    if s is None or s.into is None or torch.device(device).type != "cuda":
        yield None
        return
    stream = torch.cuda.current_stream(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    end.record(stream)
    yield start, end
    _pending_events.append((s.attrs, start, end))


def resolve_device_times():
    """Read the events of :func:`device_events` whose work has finished
    (``query`` only: this never waits) into their spans' ``device_us``;
    the others stay pending."""
    left = []
    for attrs, start, end in _pending_events:
        if end.query():
            attrs["device_us"] = start.elapsed_time(end) * 1e3
        else:
            left.append((attrs, start, end))
    _pending_events[:] = left


def read_back(t, site):
    """``t`` on the host: a Python number for a 0-d tensor, else a numpy
    copy.  Counts ``host_syncs`` and records a fine ``sync`` span whose
    ``site`` names the caller."""
    count("host_syncs")
    with fine("sync", site=site):
        if t.dim() == 0:
            return t.item()
        if t.device.type == "cpu":
            return t.detach().numpy().copy()
        return t.detach().cpu().numpy()


@contextlib.contextmanager
def trace(logdir):
    """Record what runs inside the block with ``torch.profiler`` and write
    it as a Chrome trace, ``logdir/trace.json`` (``logdir`` is created)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(str(logdir), "trace.json"))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_cycles(ml, n_cycles=20, cycle="V", warmup=2, dtype=None):
    """Seconds of one cycle, the mean over ``n_cycles`` after ``warmup``
    (on ``default_rng(0)``'s normal right-hand side), with the dofs and
    the nonzeros of the hierarchy handled a second."""
    from .utils import torch_dtype

    A = ml.levels[0].A
    n = A.shape[0]
    device = ml.device
    b = torch.as_tensor(np.random.default_rng(0).standard_normal(n),
                        dtype=torch_dtype(dtype) or A.dtype, device=device)
    x = torch.zeros_like(b)
    fn = ml.cycle_fn(cycle)
    for _ in range(warmup):
        x = fn(x, b)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(n_cycles):
        x = fn(x, b)
    _sync(device)
    per_cycle = (time.perf_counter() - t0) / n_cycles
    nnz = sum(lvl.nnz for lvl in ml.levels)
    return {"cycle": cycle, "seconds_per_cycle": per_cycle,
            "dofs_per_second": n / per_cycle,
            "nnz_throughput": nnz / per_cycle}


def solve_timings(ml, b, tol=1e-8, maxiter=100, accel="cg"):
    """One timed ``ml.solve``: ``(x, {"total_seconds", "iterations",
    "seconds_per_iteration", "residuals"})``."""
    t0 = time.perf_counter()
    res = []
    x = ml.solve(np.asarray(b), tol=tol, maxiter=maxiter, accel=accel,
                 residuals=res)
    _sync(ml.device)
    total = time.perf_counter() - t0
    iters = max(len(res) - 1, 1)
    return x, {"total_seconds": total, "iterations": iters,
               "seconds_per_iteration": total / iters,
               "residuals": np.asarray(res)}


def hierarchy_spectrum(ml, k=6):
    """Per level ``{"min", "max", "n"}``: the eigenvalues of least and
    largest magnitude of a level of at most 200 rows (dense); above that,
    ARPACK's largest-magnitude one (``min`` None; both None if ARPACK
    fails)."""
    import scipy.sparse.linalg as spla

    out = []
    for lvl in ml.levels:
        A = lvl.host_A()
        n = A.shape[0]
        if n <= 200:
            evals = np.linalg.eigvals(A.toarray())
            out.append({"min": complex(evals[np.argmin(np.abs(evals))]),
                        "max": complex(evals[np.argmax(np.abs(evals))]),
                        "n": n})
        else:
            try:
                lmax = spla.eigs(A, k=1, which="LM",
                                 return_eigenvectors=False, maxiter=200)
                out.append({"min": None, "max": complex(lmax[0]), "n": n})
            except Exception:
                out.append({"min": None, "max": None, "n": n})
    return out
