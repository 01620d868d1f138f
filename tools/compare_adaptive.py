"""The device adaptive SA setup on the card against its CPU twin.

``parallel.adaptive_sa_setup_sharded`` at its defaults (one candidate, 8
Jacobi sweeps, float32) on N x N Poisson, built once with ``device="cpu"``
(every masked product on the kernels' plain twin) and once with
``device="cuda"`` (K4'/K5'): the relaxed candidates against each other,
every level's rows and A against each other, and both CG solves to 1e-8
(iterations, tracked and true float64 relres).  Prints one JSON line.

    PYTHONPATH=. python3 tools/compare_adaptive.py --grid 1024   # on the card
    PYTHONPATH=. python3 tools/compare_adaptive.py --grid 64 --devices cpu
"""

import argparse
import json
import time

import numpy as np


def build(A, device):
    """``(solver, relaxed candidates, setup seconds)`` on ``device``."""
    import pyamg_tpu_torch.parallel.setup as setups

    seen = []
    real = setups.general_sa_setup_sharded

    def keep(A, B=None, **kw):
        seen.append(np.asarray(B))
        return real(A, B=B, **kw)

    setups.general_sa_setup_sharded = keep
    try:
        t0 = time.perf_counter()
        sol = setups.adaptive_sa_setup_sharded(A, dtype=np.float32,
                                               device=device)
        return sol, seen[0], time.perf_counter() - t0
    finally:
        setups.general_sa_setup_sharded = real


def cg(sol, A, b, maxiter):
    res = []
    t0 = time.perf_counter()
    x = sol.solve(b, tol=1e-8, accel="cg", maxiter=maxiter, residuals=res)
    seconds = time.perf_counter() - t0
    x = x.double().cpu().numpy()
    return dict(iterations=len(res) - 1, tracked=float(res[-1] / res[0]),
                relres=float(np.linalg.norm(b - A @ x) / np.linalg.norm(b)),
                solve_s=seconds)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grid", type=int, default=1024)
    ap.add_argument("--devices", default="cpu,cuda")
    ap.add_argument("--maxiter", type=int, default=2000)
    args = ap.parse_args()

    from pyamg_tpu_torch.gallery import poisson

    A = poisson((args.grid, args.grid), format="csr")
    b = A @ np.random.default_rng(0).random(A.shape[0])
    runs = {}
    for device in args.devices.split(","):
        sol, cand, setup_s = build(A, device)
        runs[device] = dict(cand=cand, sol=sol, setup_s=setup_s,
                            cg=cg(sol, A, b, args.maxiter))
    out = {"grid": args.grid}
    for device, run in runs.items():
        out[device] = dict(setup_s=run["setup_s"], **run["cg"],
                           rows=[lvl.A_csr.shape[0]
                                 for lvl in run["sol"].levels])
    if len(runs) == 2:
        (_, r0), (_, r1) = runs.items()
        c0, c1 = r0["cand"], r1["cand"]
        out["candidate_max_rel"] = float(np.abs(c0 - c1).max()
                                         / np.abs(c0).max())
        out["level_A_max_rel"] = [
            float(abs(l0.A_csr - l1.A_csr).max() / abs(l0.A_csr).max())
            for l0, l1 in zip(r0["sol"].levels, r1["sol"].levels)]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
