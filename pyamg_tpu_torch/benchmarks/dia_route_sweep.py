"""Both routes of the DIA SpMV kernel on a grid of shapes, on one NVIDIA GPU.

``csrc/dia_matvec.cu`` has a tall route (a thread a row) and a wide route
(threads over (row, offset) pairs, a block's products staged in shared
memory and summed in offset order), and its launcher chooses one from the
operator's rows n and offsets k.  This sweep times both routes at each
``(n, k)`` of a grid, in float32 and float64, beside cuSPARSE's CSR SpMV
(``torch.mv`` of the same operator with int32 indices) and the bound (the
diagonals, offsets and x read once and y written once, over 3.35 TB/s),
holds both routes bitwise against the plain twin, and reports for each
shape which route is faster and which one the launcher takes.  Its table
set the launcher's two limits (``choose_route``).

Operators: random diagonals from ``--seed`` with k distinct offsets drawn
from the band of a cube grid of n points (``offsets``), the shape of a
3-D coarse level; x random.  Timing: CUDA events around ``CALLS`` calls
queued behind a ~10 ms sleep kernel (so that the host has queued them all
before the first starts), median of ``SAMPLES`` samples taken in turns.

    python3 -m pyamg_tpu_torch.benchmarks.dia_route_sweep [--json out.json]

Needs a CUDA device; :func:`operator` and :func:`csr_of` also build the
operators on the CPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import warnings

import numpy as np
import torch

from ..sparse import SparseDIA, dia_kernel
from .dia_spmv_bench import HBM_BYTES_PER_S, card

__all__ = ["ROWS", "OFFSETS", "offsets", "operator", "csr_of", "run",
           "report", "main"]

ROWS = (256, 1024, 2154, 4096, 8192, 16384, 32768, 65536, 131072, 262144,
        524288)
OFFSETS = (1, 2, 4, 5, 7, 9, 12, 16, 21, 27, 38, 64, 111, 179, 285, 603)
CALLS = 20
SAMPLES = 9


def offsets(n: int, k: int, rng) -> tuple:
    """k distinct sorted offsets within the band of a cube grid of n
    points (``|offset| <= 2 s^2 + 2 s + 2``, ``s = n^(1/3)``), widened to
    hold k of them and cut to ``(-n, n)``; 0 is always one of them."""
    s = max(1, round(n ** (1 / 3)))
    reach = max(2 * s * s + 2 * s + 2, k)
    reach = min(reach, n - 1)
    others = np.setdiff1d(np.arange(-reach, reach + 1), [0])
    pick = rng.choice(others, size=min(k - 1, others.size), replace=False)
    return tuple(int(o) for o in np.sort(np.append(pick, 0)))


def operator(n: int, k: int, dtype, device, seed: int = 0):
    """``(D, x)``: a square random ``SparseDIA`` of n rows and k offsets
    in ``dtype`` on ``device``, and a random x."""
    rng = np.random.default_rng(seed)
    offs = offsets(n, k, rng)
    diags = torch.as_tensor(rng.standard_normal((len(offs), n)),
                            dtype=dtype, device=device)
    x = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=device)
    return SparseDIA(diags, offs, (n, n)), x


def csr_of(D: SparseDIA) -> torch.Tensor:
    """``D`` as a CSR tensor with int32 indices on its own device, built
    there (every in-range entry stored, zeros included)."""
    n, m = D.shape
    offs = torch.as_tensor(D.offsets, device=D.device)
    cols = torch.arange(n, device=D.device)[:, None] + offs[None, :]
    valid = (cols >= 0) & (cols < m)
    counts = valid.sum(dim=1)
    crow = torch.zeros(n + 1, dtype=torch.int32, device=D.device)
    crow[1:] = torch.cumsum(counts, 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)    # "beta state"
        return torch.sparse_csr_tensor(
            crow, cols[valid].to(torch.int32), D.diags.T[valid], (n, m),
            check_invariants=False)


def _nbytes(D: SparseDIA, x: torch.Tensor) -> int:
    return (D.diags.numel() * D.diags.element_size() + 4 * D.n_offsets
            + 2 * x.numel() * x.element_size())


def _medians(*fns):
    """Median device ms per call of each of ``fns``, sampled in turns."""
    for fn in fns:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = [[] for _ in fns]
    for i in range(SAMPLES):
        for j in (range(len(fns)) if i % 2 else reversed(range(len(fns)))):
            torch.cuda._sleep(20_000_000)
            start.record()
            for _ in range(CALLS):
                fns[j]()
            end.record()
            end.synchronize()
            times[j].append(start.elapsed_time(end) / CALLS)
    return [statistics.median(t) for t in times]


def run(rows=ROWS, ks=OFFSETS, dtypes=(torch.float32, torch.float64),
        device="cuda", max_entries=1 << 26, seed=0):
    """One record per ``(dtype, n, k)`` with ``n * k <= max_entries``:
    the two routes', the library's and the twin-checked times."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"dia_route_sweep times kernels on a CUDA device, "
                         f"not {device}")
    records = []
    for dtype in dtypes:
        for n in rows:
            for k in ks:
                if n * k > max_entries or k > 2 * n - 1:
                    continue
                D, x = operator(n, k, dtype, device, seed)
                y_ref = D.matvec_plain(x)
                run_route = {
                    r: (lambda r=r: dia_kernel._dia_matvec_route(
                        D.diags, D.offsets_dev, x, n, r))
                    for r in ("tall", "wide")}
                equal = {r: bool(torch.equal(fn(), y_ref))
                         for r, fn in run_route.items()}
                csr = csr_of(D)
                tall, wide, lib = _medians(run_route["tall"],
                                           run_route["wide"],
                                           lambda: torch.mv(csr, x))
                nbytes = _nbytes(D, x)
                chosen = dia_kernel.route(n, D.n_offsets)
                records.append(dict(
                    dtype=str(dtype).split(".")[-1], n=n, k=D.n_offsets,
                    tall_us=tall * 1e3, wide_us=wide * 1e3,
                    library_us=lib * 1e3,
                    bound_us=nbytes / HBM_BYTES_PER_S * 1e6,
                    faster="wide" if wide < tall else "tall", chosen=chosen,
                    bitwise_equal=equal))
                del D, x, csr, y_ref
    return records


def report(records) -> str:
    """The records as a table, and the shapes where the launcher's route
    is the slower one."""
    lines = [f"{'dtype':8s} {'n':>7s} {'k':>4s} {'tall us':>9s} "
             f"{'wide us':>9s} {'cuSPARSE':>9s} {'bound':>8s} {'faster':>6s}"
             f" {'chosen':>6s} {'bitwise tall/wide':>17s}"]
    for r in records:
        eq = "/".join(str(r["bitwise_equal"][x]) for x in ("tall", "wide"))
        lines.append(f"{r['dtype']:8s} {r['n']:7d} {r['k']:4d} "
                     f"{r['tall_us']:9.2f} {r['wide_us']:9.2f} "
                     f"{r['library_us']:9.2f} {r['bound_us']:8.2f} "
                     f"{r['faster']:>6s} {r['chosen']:>6s} {eq:>17s}")
    wrong = [r for r in records if r["faster"] != r["chosen"]]
    lines.append(f"the launcher takes the slower route at {len(wrong)} of "
                 f"{len(records)} shapes" + "".join(
                     f"\n  {r['dtype']} n={r['n']} k={r['k']}: chosen "
                     f"{r['chosen']} {r[r['chosen'] + '_us']:.2f} us, other "
                     f"{min(r['tall_us'], r['wide_us']):.2f} us"
                     for r in wrong))
    slow = [r for r in records
            if r[r["chosen"] + "_us"] > r["library_us"]]
    lines.append(f"the chosen route is slower than cuSPARSE at {len(slow)} "
                 f"shapes" + "".join(
                     f"\n  {r['dtype']} n={r['n']} k={r['k']}: {r['chosen']}"
                     f" {r[r['chosen'] + '_us']:.2f} us, cuSPARSE "
                     f"{r['library_us']:.2f} us" for r in slow))
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="write the records to this file")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dia_route_sweep needs a CUDA device")
    print(card())
    records = run(seed=args.seed)
    print(report(records))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card(), "records": records}, f, indent=1)
    bad = [r for r in records if not all(r["bitwise_equal"].values())]
    if bad:
        raise SystemExit(f"a route differs from the twin at {len(bad)} "
                         f"shapes: {bad[:3]}")


if __name__ == "__main__":
    main()
