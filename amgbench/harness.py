"""One run of one cell: set-up, the measured window, the check, the result.

A cell names a configuration (the operator, how the program takes it,
its constructor and solve) and a traffic mix (how requests are made and
offered); this module knows neither in particular, and finds each piece
by its name: the operator's kind in ``operators/``, the mix's fields in
``fields/``, its loop in ``loops/``, the metrics in ``metrics/`` and the
checks in ``reference/checks/``.  A run

1. builds the operator from the seed on the device and hands the
   program its own copy through the configuration's constructor, then
   serves one warm request: that is the set-up, timed from the start of
   the process;
2. serves requests for ``seconds`` as the mix's loop offers them, each
   generated (``generate``), solved (``solve``, timed from the call, or
   from its arrival where the loop says so, to a synchronized x) and
   offered to a seeded reservoir of requests kept for the check
   (``sample``: x copied to the host); with ``trace`` the requests of
   the window's first half run as usual and the next ``traced_requests``
   under ``torch.profiler`` with the hooks of the cell's per-layer
   metrics (the profiler slows the host's launches, also after it stops,
   so the host time of a request is read before it starts);
3. reads the peak device memory, reads back the hierarchy where a check
   asks for it, frees the program's state, draws the kept requests' x*
   again and compares them with the plain reference (``reference/``);
4. returns the result: end-to-end metrics, or per-layer ones with
   ``trace``, and the numbers compared with their limits.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import importlib
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from . import fields, operators, spec
from .reference import checks, operator as reference_operator
from .trace import PREFIX, Trace

FORBIDDEN = ("jax", "jaxlib", "flax", "pyamg_tpu")


def log(*parts):
    print("[amgbench]", *parts, file=sys.stderr, flush=True)


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def span(name):
    return torch.profiler.record_function(PREFIX + name)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _resolve(target):
    """``module:attr.attr`` -> (owner, attribute name)."""
    mod, attr = target.split(":")
    owner = importlib.import_module(mod)
    *path, name = attr.split(".")
    for p in path:
        owner = getattr(owner, p)
    return owner, name


@contextlib.contextmanager
def hooked(hook_specs, calls):
    """Wrap each hook's target: its ``record(*args)`` is appended to
    ``calls[name]`` and, where it names a ``span``, the call runs inside
    that span.  The targets are restored on exit."""
    installed = []
    try:
        for h in hook_specs:
            owner, name = _resolve(h["target"])
            orig = getattr(owner, name)
            out = calls.setdefault(h["name"], [])

            def wrapper(*a, _orig=orig, _rec=h.get("record"),
                        _span=h.get("span"), _out=out, **kw):
                if _rec is not None:
                    _out.append(_rec(*a, **kw))
                if _span is None:
                    return _orig(*a, **kw)
                with span(_span):
                    return _orig(*a, **kw)

            setattr(owner, name, wrapper)
            installed.append((owner, name, orig))
        yield
    finally:
        for owner, name, orig in reversed(installed):
            setattr(owner, name, orig)


DTYPES = {"float32": torch.float32, "float64": torch.float64}


def build_solver(config, op, device):
    """``(solver, seconds)``: the configuration's constructor on the
    program's form of ``op``; ``solver`` is the object whose solve method
    the configuration names."""
    c = config["constructor"]
    fn = getattr(importlib.import_module(c["module"]), c["function"])
    kwargs = dict(c["kwargs"], device=device)
    if c.get("grid_keyword"):
        kwargs[c["grid_keyword"]] = op.grid
    A = op.program_input(config["input"], DTYPES[config["dtype"]])
    _sync(device)
    t0 = time.perf_counter()
    built = fn(A, **kwargs)
    _sync(device)
    seconds = time.perf_counter() - t0
    attr = config.get("solver_attribute")
    return (getattr(built, attr) if attr else built), seconds


def call_solve(solver, entry, b):
    """``(x, info)`` of the configuration's ``solve`` or ``control``
    entry."""
    return getattr(solver, entry["method"])(b, return_info=True,
                                            **entry["kwargs"])


class Requests:
    """The traffic mix's requests of one run, drawn from the seed: request
    ``i`` has x* of ``(seed, i)`` (the mix's ``solution`` field) and
    b = A x*; where the mix brings a new operator every
    ``new_operator_every`` requests, request i's operator has the
    coefficients of ``(seed, i)`` (its ``coefficients`` field)."""

    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = int(seed), device
        self.dtype = DTYPES[config["dtype"]]
        self.every = int(traffic.get("new_operator_every", 0))
        self.op_index = 0
        self.op = self.operator(0)

    def field(self, index):
        """The coefficient grid of operator ``index``, or None."""
        spec_ = self.traffic.get("coefficients")
        if spec_ is None or not operators.takes_field(self.config["operator"]):
            return None
        return fields.draw(spec_, self.config["operator"]["grid"], self.seed,
                           fields.COEFFICIENTS, index, self.device)

    def operator(self, index):
        return operators.build(self.config["operator"], self.dtype,
                               self.device, self.field(index))

    def solution(self, i):
        return fields.draw(self.traffic["solution"], (self.op.n,), self.seed,
                           fields.SOLUTION, i, self.device)

    def new_operator(self, i) -> bool:
        return self.every > 0 and i > 0 and i % self.every == 0

    def make(self, i):
        """b of request i, after its operator where it brings one."""
        if self.new_operator(i):
            self.op, self.op_index = None, i
            self.op = self.operator(i)
        return self.op.matvec(self.solution(i))


class Reservoir:
    """A uniform sample of ``size`` requests from a stream of unknown
    length, drawn from the seed (algorithm R)."""

    def __init__(self, size, seed):
        self.size, self.kept, self.seen = int(size), [], 0
        self.rng = np.random.default_rng(fields.stream_seed(seed,
                                                            fields.SAMPLE))

    def offer(self, item):
        """The slot ``item`` is kept in, or None."""
        slot = None
        if len(self.kept) < self.size:
            slot = len(self.kept)
            self.kept.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                slot = j
                self.kept[j] = item
        self.seen += 1
        return slot


class Record:
    """What the metric readers read: the window's request times (s),
    answers, length and set-up; with ``trace`` the profiler's trace, the
    hooks' calls, ``solve_mp``'s counts in the traced stretch, the
    requests traced, and the host seconds and count of the requests
    before the stretch, which no profiler slowed."""

    def __init__(self):
        self.times, self.answers, self.failed = [], 0, 0
        self.window_s = self.setup_s = self.amg_setup_s = None
        self.trace = None
        self.calls = {}
        self.stretch_infos = []
        self.traced = 0
        self.untraced_s, self.untraced = 0.0, 0


def power_limit():
    """The card's power limit in watts as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def read_matrix(op):
    """A program matrix as a host item of ``reference.matrices``: the
    diagonals of a one-device DIA as they are, else its ``to_scipy()``."""
    if hasattr(op, "diags") and hasattr(op, "offsets") and \
            isinstance(op.diags, torch.Tensor):
        return ("rows", op.diags.double().cpu().numpy(), tuple(op.offsets),
                tuple(op.shape))
    return ("csr", op.to_scipy())


def read_hierarchy(solver):
    """Each level's ``A``, and ``P`` and ``R`` as lists of factors (a
    composed operator's parts), read back from the program."""
    out = []
    for lvl in solver.levels:
        item = {"A": read_matrix(lvl.A)}
        for key in ("P", "R"):
            op = getattr(lvl, key, None)
            if op is not None:
                item[key] = [read_matrix(f) for f in getattr(op, "ops", (op,))]
        out.append(item)
    return out


class Window:
    """The measured window of one run: serves request i for the loop
    (``request``) and says when it is over (``over``)."""

    def __init__(self, run, seconds, start_trace, trace_stack):
        self.run, self.rec = run, run.rec
        self.start_trace, self.trace_stack = start_trace, trace_stack
        self.t_open = time.perf_counter()
        self.t_close = self.t_open + float(seconds)
        self.t_last = self.t_open
        self.attempted = 0
        self.infos, self.first_error = [], None
        # with a trace: the first request past the window's middle (and
        # past request 1) and the n after it are traced
        self.t_trace = self.t_open + float(seconds) / 2
        self.traced = range(0)
        self.trace_closed = not run.n_traced

    def over(self, i) -> bool:
        return self.trace_closed and time.perf_counter() >= self.t_close

    def request(self, i, since=None):
        run, rec, dev = self.run, self.rec, self.run.device
        self.attempted += 1
        if not self.trace_closed and not self.traced and i > 1 and \
                time.perf_counter() >= self.t_trace:
            _sync(dev)
            rec.untraced_s, rec.untraced = self.t_last - self.t_open, i - 1
            self.traced = range(i, i + run.n_traced)
            self.start_trace()
        with span("generate"):
            b = run.reqs.make(i)
            _sync(dev)
        with span("solve"):
            t0 = time.perf_counter()
            try:
                if run.reqs.new_operator(i):
                    run.solver = None
                    run.solver, _ = build_solver(run.config, run.reqs.op, dev)
                x, info = call_solve(run.solver, run.entry, b)
                _sync(dev)
            except Exception:          # an answer that never comes
                rec.failed += 1
                x = info = None
                self.first_error = self.first_error or traceback.format_exc()
            self.t_last = time.perf_counter()
            rec.times.append(self.t_last - (t0 if since is None else since))
        with span("sample"):
            if x is not None:
                rec.answers += 1
                slot = run.reservoir.offer((i, run.reqs.op_index))
                if slot is not None:
                    run.kept_x[slot].copy_(x)
            if isinstance(info, dict):      # solve_mp's counts
                self.infos.append(info)
                if i in self.traced:
                    rec.stretch_infos.append(info)
        del b, x
        if self.traced and i == self.traced[-1]:
            _sync(dev)
            self.trace_stack.close()
            self.trace_closed = True


class Run:
    """The state of one run that the window and the check share."""

    def __init__(self, cell, seed, device, solve_entry):
        self.config, self.traffic = cell.config, cell.traffic
        self.seed, self.device = int(seed), device
        self.entry = solve_entry or self.config["solve"]
        self.rec = Record()
        self.n_traced = 0


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device="cuda", solve_entry=None) -> dict:
    """One run of ``cell``; returns the result (the line the run prints).
    ``solve_entry``: the configuration's entry to serve the window with
    (default its ``solve``)."""
    run = Run(cell, seed, device, solve_entry)
    config, traffic, rec = run.config, run.traffic, run.rec
    dev_type = torch.device(device).type
    loop = importlib.import_module(f"amgbench.loops.{traffic['loop']}")

    # ---- set-up: inputs, constructor, one warm request, the host
    # buffers of the kept answers -------------------------------------------
    run.reqs = Requests(config, traffic, seed, device)
    run.solver, rec.amg_setup_s = build_solver(config, run.reqs.op, device)
    level_sizes = [int(lvl.A.shape[0]) for lvl in run.solver.levels]
    log(f"{cell.name}: constructor {rec.amg_setup_s:.3f} s, levels "
        f"{level_sizes}")
    x, _info = call_solve(run.solver, run.entry, run.reqs.make(0))
    _sync(device)
    del x
    run.reservoir = Reservoir(traffic.get("checked_requests", 8), seed)
    run.kept_x = torch.empty((run.reservoir.size, run.reqs.op.n),
                             dtype=torch.float64,
                             pin_memory=dev_type == "cuda")

    hook_specs = []
    if trace:
        for m in cell.per_layer:
            hook_specs += getattr(spec.metric_reader(m["name"]), "HOOKS", [])
    run.n_traced = rec.traced = \
        int(traffic.get("traced_requests", 8)) if trace else 0
    prof = None

    with contextlib.ExitStack() as traced:
        def start_trace():
            nonlocal prof
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev_type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = traced.enter_context(torch.profiler.profile(
                activities=acts, record_shapes=False, with_stack=False))
            traced.enter_context(hooked(hook_specs, rec.calls))
            traced.enter_context(span("stretch"))

        window = Window(run, seconds, start_trace, traced)
        rec.setup_s = window.t_open - t_start
        loop.serve(window, traffic)
    rec.window_s = window.t_last - window.t_open
    if window.first_error:
        log(f"{rec.failed} request(s) raised; the first:\n"
            f"{window.first_error}")

    # ---- after the window: the run's peak memory, the hierarchy where a
    # check reads it, then the program's state freed before the reference
    # runs ------------------------------------------------------------------
    _sync(device)
    memory_peak = (int(torch.cuda.max_memory_allocated(device))
                   if dev_type == "cuda" else 0)
    t_check = time.perf_counter()
    evidence = checks.Evidence(config, level_sizes=level_sizes,
                               failed=rec.failed,
                               probe_seed=fields.stream_seed(seed,
                                                             fields.PROBES))
    if checks.wants_hierarchy(config):
        evidence.hierarchy = read_hierarchy(run.solver)
    run.solver = None
    gc.collect()
    if dev_type == "cuda":
        torch.cuda.empty_cache()
    reference_ops = {}
    for slot, (i, op_index) in enumerate(run.reservoir.kept):
        if op_index not in reference_ops:
            k = run.reqs.field(op_index)
            reference_ops[op_index] = reference_operator(
                config["operator"], config["dtype"],
                None if k is None else k.cpu().numpy())
            del k
        evidence.samples.append((reference_ops[op_index],
                                 run.reqs.solution(i).cpu().numpy(),
                                 run.kept_x[slot].numpy()))
    run.reqs = None
    correct, numbers = checks.compare(evidence)
    correct = bool(correct and window.attempted > 0)
    log(f"{cell.name}: the check took {time.perf_counter() - t_check:.3f} s")

    metrics = {}
    if trace and prof is not None:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            rec.trace = Trace.load(path)
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.metric_reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    result = {"correct": correct, "attempted": window.attempted,
              "failed": rec.failed, "metrics": metrics}
    result["device"] = {
        "platform": "gpu" if dev_type == "cuda" else dev_type,
        "kind": (torch.cuda.get_device_name(device) if dev_type == "cuda"
                 else "cpu"),
        "count": 1,
        "memory_peak_bytes": memory_peak,
        "power_limit_w": power_limit() if dev_type == "cuda" else None,
    }
    if trace and rec.trace is not None:
        st = rec.trace.stretch()
        result["device"]["busy_s"] = rec.trace.busy_us() * 1e-6
        result["device"]["window_s"] = (st[1] - st[0]) * 1e-6 if st else 0.0
        result["breakdown"] = rec.trace.breakdown()
    result["checks"] = numbers
    times = rec.times
    log(f"{cell.name}: {window.attempted} requests in {rec.window_s:.3f} s; "
        f"request ms min/median/p95/max "
        f"{' / '.join(f'{v * 1e3:.2f}' for v in np.percentile(times, [0, 50, 95, 100]))}"
        if times else f"{cell.name}: no request in the window")
    log(f"{cell.name}: (rounds, inner iterations) of the window's solves: "
        f"{sorted(collections.Counter((i['rounds'], i['inner_iterations']) for i in window.infos).items())}")
    return result
