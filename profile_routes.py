"""The DIA kernel's routes end to end: two solves whose hierarchies hold
short, wide DIA operators, timed with every ``dia_matvec`` launch forced
onto the kernel's tall route (a thread a row: the kernel's only route
before the wide one, the same body and launch) and with the launcher's
own choice, in turns on one card (tall, auto, auto, tall).

* ``default_csr``: ``smoothed_aggregation_solver(A)`` with its defaults
  but ``op_dtype=float32`` on the 1024^2 Poisson problem as plain CSR
  (its levels 3 and 4: 2,154 rows x 285 offsets, 219 x 111), then
  ``solve(b, tol=1e-8, accel="cg")``;
* ``poisson3d``: ``benchmarks/suite.py``'s ``poisson3d_64_sa_chebyshev``
  (chip_smoke phase 24), then ``solve_mp(b, tol=1e-10)``.

For each it prints the solve's iterations, its seconds (host clock,
synchronized, best of 3 warm solves), then one solve under
``torch.profiler``: its wall time, the device time of every kernel and
its share of the wall time (device-busy), the launches, and the DIA
kernel's device time by route.  The last line is every record as JSON.

    python3 profile_routes.py                        # on the GPU
    python3 profile_routes.py --device cpu --grid 64 --grid3d 16
"""

import argparse
import json
import time

import numpy as np
import scipy.sparse as sp
import torch

import pyamg_tpu_torch
from profile_general import _sync
from pyamg_tpu_torch.gallery import poisson
from pyamg_tpu_torch.sparse import dia_kernel

ROUNDS = ("tall", "auto", "auto", "tall")


def cells(grid, grid3d, device):
    """``{name: (hierarchy, A, solve)}``: ``solve(b, residuals)`` runs the
    cell's solve and returns its iteration count."""
    A = sp.csr_matrix(poisson((grid, grid), format="csr").tocoo())
    ml = pyamg_tpu_torch.smoothed_aggregation_solver(
        A, op_dtype=torch.float32, device=device)
    A3 = poisson((grid3d,) * 3, format="csr")
    ml3 = pyamg_tpu_torch.smoothed_aggregation_solver(
        A3, presmoother="chebyshev", postsmoother="chebyshev",
        improve_candidates=None, op_dtype=torch.float32,
        aggregate=("grid", {"block": (2, 2, 2)}), device=device)

    def cg(b):
        res = []
        ml.solve(b, tol=1e-8, accel="cg", residuals=res)
        return len(res) - 1

    def mp(b):
        _, info = ml3.solve_mp(b, tol=1e-10, return_info=True)
        return info["inner_iterations"]

    return {"default_csr": (ml, A, cg), "poisson3d": (ml3, A3, mp)}


def forced(route):
    """``dia_kernel.dia_matvec`` on ``route`` ("tall", or "auto": the
    launcher's choice), both through the same extra call, so that the two
    rounds pay the same host cost a launch."""
    return lambda d, o, x, m: dia_kernel._dia_matvec_route(d, o, x, m, route)


def measure(name, A, solve, device):
    b = A @ np.random.default_rng(0).random(A.shape[0])
    iters = solve(b)
    runs = []
    for _ in range(3):
        _sync(device)
        t0 = time.perf_counter()
        solve(b)
        _sync(device)
        runs.append(time.perf_counter() - t0)
    rec = dict(cell=name, iterations=iters, solve_s=min(runs),
               runs=[round(r, 5) for r in runs])
    if device.type != "cuda":
        return rec
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _sync(device)
        t0 = time.perf_counter()
        solve(b)
        _sync(device)
        wall = time.perf_counter() - t0
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in ops) / 1e3
    dia = {"tall": [0.0, 0], "wide": [0.0, 0]}
    for e in ops:
        if "dia_matvec_wide_kernel" in e.key:
            dia["wide"][0] += e.self_device_time_total / 1e3
            dia["wide"][1] += e.count
        elif "dia_matvec_kernel" in e.key:
            dia["tall"][0] += e.self_device_time_total / 1e3
            dia["tall"][1] += e.count
    rec.update(profiled_wall_ms=wall * 1e3, device_ms=busy_ms,
               busy=busy_ms / (wall * 1e3), launches=sum(e.count for e in ops),
               dia_ms={r: v[0] for r, v in dia.items()},
               dia_launches={r: v[1] for r, v in dia.items()})
    return rec


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--grid", type=int, default=1024)
    parser.add_argument("--grid3d", type=int, default=64)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_routes: no CUDA device")
    built = cells(args.grid, args.grid3d, device)
    real = dia_kernel.dia_matvec
    records = []
    try:
        for rnd, route in enumerate(ROUNDS):
            dia_kernel.dia_matvec = forced(route)
            for name, (_, A, solve) in built.items():
                rec = dict(round=rnd, route=route,
                           **measure(name, A, solve, device))
                records.append(rec)
                print(" ".join(f"{k}={v:.4g}" if isinstance(v, float)
                               else f"{k}={v}" for k, v in rec.items()),
                      flush=True)
    finally:
        dia_kernel.dia_matvec = real
    for name in built:
        for route in ("tall", "auto"):
            mine = [r for r in records
                    if r["cell"] == name and r["route"] == route]
            line = (f"{name} {route}: solve_s best "
                    f"{min(r['solve_s'] for r in mine):.4f}")
            if "busy" in mine[0]:
                line += (f", device-busy "
                         f"{[round(100 * r['busy'], 1) for r in mine]} %, "
                         f"dia_matvec device ms "
                         f"{[round(sum(r['dia_ms'].values()), 3)
                              for r in mine]}")
            print(line)
    print(json.dumps({"profile_routes": records}))


if __name__ == "__main__":
    main()
