"""Smoke run of pyamg_tpu_torch on one NVIDIA GPU.

Builds the port's CUDA kernel from the sources in this checkout, holds it
against its plain PyTorch version, drives the main path -- structured
smoothed aggregation on the 1024^2 5-point Poisson problem (1,048,576
unknowns), solved to a float64 relative residual of 1e-10 by float32
V-cycle-preconditioned CG inside float64 defect correction -- and times the
kernel beside its plain version.

    python3 chip_smoke.py          # from the repository root, one GPU

Without a CUDA device it exits non-zero and prints no result.  Every phase
raises on failure.  The line before the last is the kernels' record; the
last line is ``{"ok": true, "device": {...}}``.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np

GRID = (1024, 1024)
TOL = 1e-10
REL_TOL = {"float32": 1e-5, "float64": 1e-12}   # kernel vs plain, max rel
KERNEL = {"name": "dia_matvec", "route": "cuda",
          "source": "pyamg_tpu_torch/csrc/dia_matvec.cu",
          "replaces": "pyamg_tpu/sparse/pallas_kernels.py:182"}
SETUP_KW = dict(max_coarse=500, presmoother="chebyshev",
                postsmoother="chebyshev", improve_candidates=None)


def phase(name):
    print(f"== {name}", flush=True)


def find_card(torch):
    phase("1. card")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False -- "
                 "this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"{torch.cuda.get_device_name(0)}, "
          f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")


def build_kernel():
    phase("2. build")
    from pyamg_tpu_torch import _build
    from pyamg_tpu_torch.sparse import dia_kernel

    t0 = time.perf_counter()
    dia_kernel.load()
    print(f"dia_matvec built and loaded in {time.perf_counter() - t0:.2f} s")
    lib = _build.build("dia_matvec")
    print(lib.with_name(lib.name + ".log").read_text().strip())


def check_kernel(torch, rng):
    """Kernel vs plain version on the card; returns the largest absolute
    difference seen."""
    phase("3. kernel vs plain")
    import pyamg_tpu_torch
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.sparse import SparseDIA

    def random_dia(offsets, shape):
        return SparseDIA(torch.as_tensor(
            rng.standard_normal((len(offsets), shape[0]))), offsets, shape)

    cases = [
        ("n=2^20, 5-point", random_dia((-1024, -1, 0, 1, 1024),
                                       (1 << 20, 1 << 20))),
        ("rectangular 3000x2000", random_dia((-2999, -7, 0, 5, 1999),
                                             (3000, 2000))),
        ("rectangular 2000x3000", random_dia((-1999, -1, 0, 64, 2999),
                                             (2000, 3000))),
        ("tiny n=169, 9-point", random_dia(
            (-14, -13, -12, -1, 0, 1, 12, 13, 14), (169, 169))),
    ]
    t0 = time.perf_counter()
    probe = pyamg_tpu_torch.smoothed_aggregation_solver(
        poisson(GRID, format="csr"), device="cuda", **SETUP_KW)
    print(f"float64 probe hierarchy of {GRID}: {len(probe.levels)} levels "
          f"in {time.perf_counter() - t0:.1f} s")
    for i, lvl in enumerate(probe.levels):
        cases.append((f"level {i} A {lvl.A.shape} offsets "
                      f"{len(lvl.A.offsets)}", lvl.A))
        if getattr(lvl, "P", None) is not None:
            cases.append((f"level {i} S {lvl.P.ops[0].shape}", lvl.P.ops[0]))
            cases.append((f"level {i} S^H {lvl.R.ops[-1].shape}",
                          lvl.R.ops[-1]))
    worst = 0.0
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]
        for label, op in cases:
            op = SparseDIA(op.diags.to("cuda", dtype), op.offsets, op.shape)
            x = torch.as_tensor(rng.standard_normal(op.shape[1]),
                                device="cuda", dtype=dtype)
            y = op.matvec(x)
            y_ref = op.matvec_plain(x)
            torch.cuda.synchronize()
            err = float((y - y_ref).abs().max())
            rel = err / max(float(y_ref.abs().max()), 1e-300)
            if not (bool(torch.isfinite(y).all()) and rel <= REL_TOL[name]):
                raise AssertionError(f"dia_matvec {name} {label}: max rel "
                                     f"error {rel:.3e} > {REL_TOL[name]}")
            worst = max(worst, err)
            print(f"{name:8s} {label:42s} max abs {err:.3e} rel {rel:.3e}")
    return worst


def main_path(torch):
    """The 1024^2 solve through the package's entry points; returns the
    kernel's launch count over it."""
    phase("4. main path")
    import pyamg_tpu_torch
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.sparse import dia_kernel

    A = poisson(GRID, format="csr")
    n = A.shape[0]
    b = A @ np.random.default_rng(0).random(n)
    normb = np.linalg.norm(b)

    dia_kernel.launches = 0
    t0 = time.perf_counter()
    ml = pyamg_tpu_torch.smoothed_aggregation_solver(
        A, op_dtype=torch.float32, device="cuda", **SETUP_KW)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    opc = ml.operator_complexity()
    print(ml)
    print(f"setup_s {setup_s:.3f}  levels {len(ml.levels)}  "
          f"operator_complexity {opc:.6f}")

    def solve():
        return ml.solve_mp(b, tol=TOL, method="defect", inner_maxiter=40,
                           max_rounds=4, inner_tol_factor=1e-6,
                           return_info=True)

    x, info = solve()
    torch.cuda.synchronize()
    launches_first = dia_kernel.launches
    x_np = x.cpu().numpy()
    relres = np.linalg.norm(b - A @ x_np) / normb
    # the JAX bench counts the inner CG iterations of each round; solve_mp's
    # count adds one per round (the residual of the round's start)
    cg_iters = info["inner_iterations"] - info["rounds"]
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    print(f"solve_mp(defect): rounds {info['rounds']}  inner CG iterations "
          f"{cg_iters} (solve_mp count {info['inner_iterations']})  "
          f"true f64 relres {relres:.3e}  finite "
          f"{bool(np.isfinite(x_np).all())}")
    print(f"solve_s best of 3 {min(runs):.4f}  runs "
          f"{[round(r, 4) for r in runs]} (after the first solve, which "
          f"also builds the float64 operator)  dia_matvec launches in the "
          f"first solve {launches_first}")

    res = []
    x_cg, it_info = ml.solve(b, tol=1e-8, accel="cg", residuals=res,
                             return_info=True)
    torch.cuda.synchronize()
    relres_cg = (np.linalg.norm(b - A @ x_cg.double().cpu().numpy())
                 / normb)
    print(f"solve(accel='cg', tol=1e-8) float32: iterations {len(res) - 1}  "
          f"info {it_info}  true f64 relres {relres_cg:.3e}")

    if len(ml.levels) != 5:
        raise AssertionError(f"expected 5 levels, got {len(ml.levels)}")
    if round(opc, 3) != 1.225:
        raise AssertionError(f"expected operator complexity 1.225, got {opc}")
    if not (np.isfinite(x_np).all() and relres <= 5 * TOL):
        raise AssertionError(f"relres {relres} > {5 * TOL}")
    if abs(cg_iters - 18) > 1:
        raise AssertionError(f"inner CG iterations {cg_iters}, expected 18±1")
    if launches_first <= 0:
        raise AssertionError("the solve launched no dia_matvec kernel")
    if not np.isfinite(relres_cg):
        raise AssertionError("float32 PCG returned a non-finite solution")
    launches = dia_kernel.launches

    # the same path at a size a direct solver checks: 64^2 against spsolve
    from scipy.sparse.linalg import spsolve

    As = poisson((64, 64), format="csr")
    bs = np.random.default_rng(1).random(As.shape[0])
    mls = pyamg_tpu_torch.smoothed_aggregation_solver(
        As, op_dtype=torch.float32, device="cuda",
        **dict(SETUP_KW, max_coarse=50))
    xs = mls.solve_mp(bs, tol=TOL, method="defect").cpu().numpy()
    x_ref = spsolve(As.tocsc(), bs)
    diff = np.linalg.norm(xs - x_ref) / np.linalg.norm(x_ref)
    print(f"64^2 check against scipy spsolve: relative difference "
          f"{diff:.3e}")
    if not diff <= 1e-8:
        raise AssertionError(f"64^2 solution differs from spsolve: {diff}")
    return ml, launches


def time_kernel(torch, ml):
    """Median of 20 CUDA-event samples (10 launches each) of the kernel and
    its plain version at the level-0 shape, in float32 and float64.

    Each sample first parks the stream in a ~10 ms sleep kernel, so that
    the host has queued all 10 launches before the first one starts: the
    events then bracket device time alone, not the host's launch pace.
    The host's own cost per call is printed beside it."""
    phase("5. kernel time")
    from pyamg_tpu_torch.sparse import SparseDIA

    def sample(fn, inner=10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / inner

    def host_us(fn, calls=200):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e6

    A0 = ml.levels[0].A
    out = {}
    for dtype in (torch.float32, torch.float64):
        op = SparseDIA(A0.diags.to(dtype), A0.offsets, A0.shape)
        x = torch.rand(op.shape[1], device="cuda", dtype=dtype)
        kernel, plain = (lambda: op.matvec(x)), (lambda: op.matvec_plain(x))
        for _ in range(3):
            kernel()
            plain()
        ks, ps = [], []
        for i in range(20):        # alternate: plain, kernel, kernel, plain
            order = (plain, kernel) if i % 2 == 0 else (kernel, plain)
            for fn in order:
                (ps if fn is plain else ks).append(sample(fn))
        name = str(dtype).split(".")[-1]
        k_ms, p_ms = statistics.median(ks), statistics.median(ps)
        nbytes = (op.n_offsets + 2) * op.shape[0] * x.element_size()
        print(f"{name}: level-0 {op.shape} {op.n_offsets} offsets  kernel "
              f"{k_ms * 1e3:.1f} us device ({nbytes / k_ms / 1e6:.0f} GB/s "
              f"of (k+2)n bytes), {host_us(kernel):.1f} us per call on the "
              f"host clock;  plain {p_ms * 1e3:.1f} us device, "
              f"{host_us(plain):.1f} us per call;  plain/kernel "
              f"{p_ms / k_ms:.2f}")
        out[name] = (k_ms, p_ms)
    return out


def main():
    import torch

    find_card(torch)
    build_kernel()
    rng = np.random.default_rng(0)
    worst = check_kernel(torch, rng)
    ml, launches = main_path(torch)
    times = time_kernel(torch, ml)
    print(json.dumps({"kernels": [dict(
        KERNEL, launches=launches, max_abs_err=worst,
        ms=times["float32"][0], plain_ms=times["float32"][1])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
