"""Profiling: a device trace, the time of one cycle, a timed solve, and the
extremal eigenvalues of each level.

Port of ``pyamg_tpu/util/profiling.py``.  ``trace`` records with
``torch.profiler`` (CPU activity, and CUDA activity where a card is
present) and writes a Chrome trace; ``profile_cycles`` times the eager
cycle, synchronizing the card before each clock read.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

__all__ = ["profile_cycles", "trace", "hierarchy_spectrum", "solve_timings"]


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
