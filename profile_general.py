"""Where the general path spends its time: the setup stage by stage, then
the solve's device kernels.

Runs ``pyamg_tpu_torch.parallel.general_sa_setup_sharded`` on the 5-point
Poisson problem of the given grid twice in one process (the first run also
pays for building and loading the kernel library and for first-use CUDA
work) and prints, for each run, the seconds of every stage below and the
rest.  Each stage is timed on the host clock around its calls, with the
device synchronized on both sides, so a stage's device work counts in that
stage; nested stages count only in the outer one.  Then it times one warm
``solve(b, tol=1e-8, accel="cg")`` and, on a GPU, runs one more under
``torch.profiler`` and prints the device kernels' time and launches.  The
first line says whether the compiled host library (``amg_core``) loaded:
with it the aggregation and coloring stages run compiled, without it their
Python forms.

    python3 profile_general.py                 # 1024^2 on the GPU
    python3 profile_general.py --grid 64 --device cpu
"""

import argparse
import contextlib
import functools
import time

import numpy as np
import torch

import pyamg_tpu_torch.aggregation.aggregate as aggregate
import pyamg_tpu_torch.aggregation.tentative as tentative
import pyamg_tpu_torch.parallel.setup as setup
import pyamg_tpu_torch.relaxation.smoothing as smoothing
import pyamg_tpu_torch.strength as strength
from pyamg_tpu_torch import amg_core
from pyamg_tpu_torch.gallery import poisson

# (label, owner, attribute): the stages, each a callable the setup reaches
# through ``owner.attribute`` at call time
STAGES = [
    ("symmetric strength (host)", strength,
     "symmetric_strength_of_connection"),
    ("standard aggregation (host)", aggregate,
     "standard_aggregation"),
    ("fit_candidates (host)", tentative, "fit_candidates"),
    ("coloring and color masks (host)", smoothing,
     "_color_masks"),
    ("symbolic Galerkin patterns (host, scipy products)", setup,
     "_galerkin_patterns"),
    ("row slabs from scipy (host slabs, copy to device)", setup,
     "upload_rows"),
    ("power rho (device)", setup, "_ell_power_rho"),
    ("Jacobi smoothing values (device)", setup, "_jacobi_smoothing_vals"),
    ("masked products: plans + kernels (device)", setup,
     "masked_spgemm_auto"),
    ("R = P^T onto its pattern (device)", setup, "transpose_onto_mesh"),
    ("coarse values back to the host", setup, "host_values"),
    ("stored diagonals (host)", setup, "_ensure_stored_diagonal"),
]


def report_native():
    """Say which route the host stages take."""
    print(f"native host library (amg_core) loaded: "
          f"{amg_core.have_native()}")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def stage_timer(device, seconds, calls, stages=None):
    """Wrap every stage of ``stages`` (default ``STAGES``) so that its
    calls add to ``seconds[label]`` and ``calls[label]``; restore them on
    exit."""
    depth = [0]
    saved = []

    def timed(label, fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if depth[0]:
                return fn(*args, **kwargs)
            depth[0] += 1
            _sync(device)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                _sync(device)
                seconds[label] += time.perf_counter() - t0
                calls[label] += 1
                depth[0] -= 1
        return run

    for label, owner, attr in (STAGES if stages is None else stages):
        raw = owner.__dict__[attr]
        saved.append((owner, attr, raw))
        if isinstance(raw, classmethod):
            wrapped = staticmethod(timed(label, getattr(owner, attr)))
        else:
            wrapped = timed(label, raw)
        setattr(owner, attr, wrapped)
    try:
        yield
    finally:
        for owner, attr, raw in saved:
            setattr(owner, attr, raw)


def profile(A, device):
    """One timed setup: ``(solver, total_s, {label: s}, {label: calls})``."""
    seconds = dict.fromkeys([s[0] for s in STAGES], 0.0)
    calls = dict.fromkeys(seconds, 0)
    with stage_timer(device, seconds, calls):
        _sync(device)
        t0 = time.perf_counter()
        sol = setup.general_sa_setup_sharded(A, dtype=np.float32,
                                             device=device)
        _sync(device)
        total = time.perf_counter() - t0
    print(f"{len(sol.levels)} levels, rows "
          f"{[lvl.A_csr.shape[0] for lvl in sol.levels]}")
    return sol, total, seconds, calls


def profile_solve(sol, A, device, **solve_kw):
    """A warm solve's wall time, then a profiled one's device kernels;
    ``solve_kw`` replaces the solve's ``accel="cg", maxiter=200``."""
    b = A @ np.random.default_rng(0).random(A.shape[0])
    solve_kw = solve_kw or dict(accel="cg", maxiter=200)

    def solve(res=None):
        _sync(device)
        t0 = time.perf_counter()
        sol.solve(b, tol=1e-8, residuals=res, **solve_kw)
        _sync(device)
        return time.perf_counter() - t0

    solve()
    res = []
    wall = solve(res)
    print(f"== solve({solve_kw}): {len(res) - 1} iterations, {wall:.4f} s")
    if device.type != "cuda":
        return
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        wall = solve()
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in ops) / 1e3
    print(f"profiled solve: wall {wall * 1e3:.1f} ms, device ops "
          f"{busy_ms:.1f} ms ({100 * busy_ms / (wall * 1e3):.1f}% busy), "
          f"{sum(e.count for e in ops)} launches")
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"KERNEL {e.key[:72]:72s} {e.self_device_time_total / 1e3:8.3f}"
              f" ms  count {e.count}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--grid", type=int, default=1024)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_general: no CUDA device")
    report_native()
    A = poisson((args.grid, args.grid), format="csr")
    for run in ("first", "second"):
        sol, total, seconds, calls = profile(A, device)
        print(f"== {run} setup, {args.grid}^2, {device}: {total:.3f} s")
        rest = total - sum(seconds.values())
        rows = sorted(seconds.items(), key=lambda kv: -kv[1])
        for label, s in rows + [("rest (level loop, Python glue)", rest)]:
            print(f"STAGE {label:52s} {s:8.3f} s {100 * s / total:5.1f}%  "
                  f"calls {calls.get(label, '-')}")
    profile_solve(sol, A, device)


if __name__ == "__main__":
    main()
