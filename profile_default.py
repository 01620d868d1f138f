"""Where ``smoothed_aggregation_solver(A)`` with its default arguments
spends its time: the setup stage by stage, then the solve's device kernels.

Builds the hierarchy of the 5-point Poisson problem of the given grid with
every argument at its default but ``op_dtype`` (float32), twice in one
process for each input (the first run also pays for building and loading
the kernel library and for first-use CUDA work):

* ``structured``: the gallery matrix, which carries its grid;
* ``unstructured``: the same matrix as plain CSR without grid metadata.

For each run it prints the seconds of every stage below and the rest
(timed as in ``profile_general.py``: host clock, device synchronized on
both sides, nested stages counted in the outer one).  Then it times one
warm ``solve(b, tol=1e-8, accel="cg")`` and, on a GPU, runs one more under
``torch.profiler`` and prints the device kernels' time and launches.

    python3 profile_default.py                 # 1024^2 on the GPU
    python3 profile_default.py --grid 64 --device cpu
"""

import argparse
import time

import scipy.sparse as sp
import torch

import pyamg_tpu_torch.aggregation.aggregation as sa
import pyamg_tpu_torch.relaxation.relaxation as rel
import pyamg_tpu_torch.relaxation.smoothing as smoothing
from profile_general import _sync, profile_solve, stage_timer
from pyamg_tpu_torch.gallery import poisson

# (label, owner, attribute): each a callable the setup reaches through
# ``owner.attribute`` at call time
STAGES = [
    ("improve_candidates: host Gauss-Seidel (triangular solves)", rel,
     "gauss_seidel"),
    ("symmetric strength (host)", sa, "symmetric_strength_of_connection"),
    ("standard aggregation (host, Python passes)", sa,
     "standard_aggregation"),
    ("grid aggregation (host)", sa, "grid_aggregation"),
    ("fit_candidates (host)", sa, "fit_candidates"),
    ("Jacobi prolongation smoother incl. rho (host, scipy)", sa,
     "jacobi_prolongation_smoother"),
    ("structured S = I - c D^-1 A incl. rho (host)", sa,
     "structured_smoother_S"),
    ("Galerkin product R A P (host, scipy)", sa, "galerkin_product"),
    ("device operators: DIA/ELL/embedded arrays, copies", sa,
     "_finalize_device_operators"),
    ("coloring (host; first-fit is a Python loop)", smoothing, "_coloring"),
    ("color masks (host)", smoothing, "_color_masks"),
    ("gather arrays (host)", smoothing, "_color_gather_arrays"),
    ("rho(D^-1 A) outside the smoothers above (host)", smoothing,
     "rho_D_inv_A"),
]


def profile(A, device):
    """One timed setup: ``(solver, total_s, {label: s}, {label: calls})``."""
    seconds = dict.fromkeys([s[0] for s in STAGES], 0.0)
    calls = dict.fromkeys(seconds, 0)
    with stage_timer(device, seconds, calls, STAGES):
        _sync(device)
        t0 = time.perf_counter()
        ml = sa.smoothed_aggregation_solver(A, op_dtype=torch.float32,
                                            device=device)
        _sync(device)
        total = time.perf_counter() - t0
    print(f"{len(ml.levels)} levels, rows "
          f"{[lvl.A.shape[0] for lvl in ml.levels]}, operators "
          f"{[type(lvl.A).__name__ for lvl in ml.levels]}")
    return ml, total, seconds, calls


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--grid", type=int, default=1024)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_default: no CUDA device")
    for which in ("structured", "unstructured"):
        for run in ("first", "second"):
            # a fresh matrix each run: a used one carries its cached rho
            A = poisson((args.grid, args.grid), format="csr")
            if which == "unstructured":
                A = sp.csr_matrix(A.tocoo())
            ml, total, seconds, calls = profile(A, device)
            print(f"== {which}, {run} setup, {args.grid}^2, {device}: "
                  f"{total:.3f} s")
            rest = total - sum(seconds.values())
            rows = sorted(seconds.items(), key=lambda kv: -kv[1])
            for label, s in rows + [("rest (level loop, Python glue)",
                                     rest)]:
                if s or label.startswith("rest"):
                    print(f"STAGE {label:58s} {s:8.3f} s "
                          f"{100 * s / total:5.1f}%  calls "
                          f"{calls.get(label, '-')}")
        profile_solve(ml, A, device, accel="cg")
        profile_solve(ml, A, device, maxiter=20)


if __name__ == "__main__":
    main()
