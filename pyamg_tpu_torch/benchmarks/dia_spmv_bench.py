"""DIA SpMV microbenchmark on one NVIDIA GPU: every DIA kernel of the port
on one problem, beside the plain shift-multiply-add and the library's CSR
SpMV.

The port's counterpart of ``benchmarks/dia_spmv_bench.py``: the 5-point
Poisson operator of a G x G grid (G = 2048: 4,194,304 rows, 5 diagonals)
in float32, its diagonals divided by 8 so that chained matvecs stay finite,
and x from ``np.random.default_rng(0)``.  Rows:

* plain shift-multiply-add (``dia_matvec_plain``, the kernels' twin; the
  reference row, as XLA's form is in the JAX benchmark);
* ``dia_matvec_v1`` (1-D tiles over a padded copy of x, the copy included);
* ``dia_matvec_v2`` (the (rows, 128) window of x);
* ``dia_matvec`` float32 (the kernel of the solve's hot path);
* ``dia_matvec`` with bfloat16 diagonals and a float32 x;
* the library: one ``torch.mv`` of the same operator as a CSR tensor with
  int32 indices (cuSPARSE SpMV), float32.

Each row reports device microseconds per matvec, GB/s of the ideal traffic
(each input read once, the output written once: ``(k+2)*n*4`` bytes, and
``(2k+8)*n`` for bfloat16 diagonals), its share of the H100's 3.35 TB/s,
its largest error against the plain twin of its own arithmetic on the
same x, and for a kernel's row the twin's own time.  Timing: CUDA events
around ``CALLS`` chained matvecs ``v <- D v`` queued behind a sleep kernel
(so that the events bracket device time, not the host's launch pace),
median of ``SAMPLES``, after a warm-up.  At
G = 2048 the working set (117 MB) exceeds the card's 50 MB L2 and streams
from HBM; at G = 1024 (29 MB) it stays in L2, and the row says so.

    python3 -m pyamg_tpu_torch.benchmarks.dia_spmv_bench [--grid 2048 1024]

Needs a CUDA device; :func:`problem` and :func:`rows` also build the
problem and its rows on the CPU, where the kernels' wrappers run their
twins.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from ..gallery import poisson
from ..sparse import SparseDIA, dia_kernel, dia_variants

__all__ = ["Problem", "problem", "csr_tensor", "rows", "run", "card",
           "report", "main", "HBM_BYTES_PER_S", "L2_BYTES"]

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA's data sheet
L2_BYTES = 50 * 1024 * 1024     # H100 L2
CALLS = 10
SAMPLES = 20


@dataclass
class Problem:
    """The benchmark's operator, in the forms the rows take."""
    G: int
    D: SparseDIA                 # float32 diagonals, divided by 8
    Db: SparseDIA                # the same diagonals in bfloat16
    csr: torch.Tensor            # the same operator, CSR with int32 indices
    x: torch.Tensor              # float32
    nbytes: int                  # (k+2)*n*4
    nbytes_bf16: int             # (2k+8)*n

    @property
    def n(self) -> int:
        return self.D.shape[0]

    @property
    def k(self) -> int:
        return self.D.n_offsets


def problem(G: int, device) -> Problem:
    """The G x G Poisson problem of the benchmark on ``device``."""
    A = poisson((G, G), format="csr")
    D = SparseDIA.from_scipy(A, dtype=np.float32, device=device)
    D = SparseDIA(D.diags / 8.0, D.offsets, D.shape,
                  offsets_dev=D.offsets_dev)
    Db = SparseDIA(D.diags.to(torch.bfloat16), D.offsets, D.shape,
                   offsets_dev=D.offsets_dev)
    n, k = D.shape[0], D.n_offsets
    x = torch.as_tensor(np.random.default_rng(0).random(n, dtype=np.float32),
                        device=device)
    return Problem(G, D, Db, csr_tensor(D.to_scipy(), device), x,
                   (k + 2) * n * 4, (2 * k + 8) * n)


def csr_tensor(M, device, dtype=None) -> torch.Tensor:
    """The scipy matrix ``M`` as a CSR tensor with int32 indices on
    ``device``, its values in ``dtype`` (default: ``M``'s)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)    # "beta state"
        return torch.sparse_csr_tensor(
            torch.as_tensor(M.indptr.astype(np.int32), device=device),
            torch.as_tensor(M.indices.astype(np.int32), device=device),
            torch.as_tensor(M.data, device=device, dtype=dtype), M.shape,
            check_invariants=False)


def rows(p: Problem):
    """``(label, kernel, step, plain, nbytes)`` per row: ``step(v)`` is one
    matvec, ``plain(v)`` the twin of its arithmetic, ``kernel`` the name of
    the port's kernel the step launches (None for the plain and library
    rows)."""
    D, Db, n = p.D, p.Db, p.n
    d, offs = D.diags, D.offsets

    def plain(v):
        return dia_kernel.dia_matvec_plain(d, offs, v, n)

    return [
        ("plain shift-mult-add (twin)", None, plain, plain, p.nbytes),
        ("dia_matvec_v1 (1-D tiles)", "dia_matvec_v1",
         lambda v: dia_variants.dia_matvec_v1(d, offs, v),
         lambda v: dia_variants.dia_matvec_v1_plain(d, offs, v), p.nbytes),
        ("dia_matvec_v2 (2-D window)", "dia_matvec_v2",
         lambda v: dia_variants.dia_matvec_v2(d, offs, v),
         lambda v: dia_variants.dia_matvec_v2_plain(d, offs, v), p.nbytes),
        ("dia_matvec f32 (hot path)", "dia_matvec", D.matvec, plain,
         p.nbytes),
        ("dia_matvec bf16 diags", "dia_matvec", Db.matvec, Db.matvec_plain,
         p.nbytes_bf16),
        ("cuSPARSE CSR SpMV (library)", None,
         lambda v: torch.mv(p.csr, v), plain, p.nbytes),
    ]


def _chain_ms(step, x, calls=CALLS, samples=SAMPLES):
    """Median device ms per call of ``calls`` chained ``v <- step(v)``,
    after ``3 * calls`` of them as a warm-up."""
    v = x
    for _ in range(3 * calls):
        v = step(v)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(samples):
        torch.cuda._sleep(20_000_000)
        start.record()
        v = x
        for _ in range(calls):
            v = step(v)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def run(G: int = 2048, device="cuda", p: Problem | None = None):
    """Time every row at G x G on the card; returns one record per row.
    ``p``: the problem at G, where the caller has built it already.  A
    kernel's record also holds its twin's time (``plain_us``)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"dia_spmv_bench times kernels on a CUDA device, "
                         f"not {device}")
    p = problem(G, device) if p is None else p
    resident = p.nbytes <= L2_BYTES
    records = []
    for label, kernel, step, plain, nbytes in rows(p):
        y, y_ref = step(p.x), plain(p.x)
        torch.cuda.synchronize()
        err = float((y - y_ref).abs().max())
        scale = max(float(y_ref.abs().max()), 1e-30)
        ms = _chain_ms(step, p.x)
        plain_ms = _chain_ms(plain, p.x) if kernel else None
        records.append(dict(
            G=p.G, n=p.n, k=p.k, row=label, kernel=kernel,
            us=ms * 1e3, gbs=nbytes / ms / 1e6,
            share=nbytes / (ms * 1e-3) / HBM_BYTES_PER_S, bytes=nbytes,
            plain_us=None if plain_ms is None else plain_ms * 1e3,
            l2_resident=resident, max_abs_err=err, max_rel_err=err / scale,
            finite=bool(torch.isfinite(y).all())))
    return records


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def report(records) -> str:
    """The records as a table."""
    r0 = records[0]
    where = ("L2-resident" if r0["l2_resident"]
             else "streams from HBM") + f", {r0['bytes'] / 1e6:.1f} MB ideal"
    lines = [f"DIA SpMV {r0['G']}x{r0['G']}: n={r0['n']} k={r0['k']} "
             f"({where}); chained matvecs, median device time",
             f"{'row':30s} {'us/matvec':>10s} {'GB/s':>8s} {'of 3.35TB/s':>11s}"
             f" {'max rel err':>11s} {'twin us':>9s}"]
    for r in records:
        twin = "" if r["plain_us"] is None else f"{r['plain_us']:9.2f}"
        lines.append(f"{r['row']:30s} {r['us']:10.2f} {r['gbs']:8.1f} "
                     f"{r['share']:11.1%} {r['max_rel_err']:11.2e} {twin}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, nargs="+", default=[2048, 1024])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dia_spmv_bench needs a CUDA device")
    print(card())
    for G in args.grid:
        print(report(run(G)))


if __name__ == "__main__":
    main()
