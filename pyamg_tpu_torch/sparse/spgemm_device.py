"""Device-side numeric SpGEMM over a host-symbolic pattern (padded ELL).

The Galerkin products of the device setup split in two: the symbolic phase
(integer pattern construction) stays on the host in scipy, and the numeric
phase runs on the device over fixed-width slabs:

    out[i, o] = sum_a sum_b  A.data[i, a] * B.data[A.cols[i, a], b]
                             * [B.cols[A.cols[i, a], b] == out_cols[i, o]]

:func:`masked_spgemm_ell` is the plain PyTorch form of that product (the
JAX package's XLA gather formulation) and the twin of both hand-written
kernels.  :func:`masked_spgemm_auto` is what the setup calls: on a CUDA
tensor it runs the banded kernel when A has at most 64 distinct offsets
and the gather kernel otherwise, at every size and at every width whose
tile fits a block's shared memory; on a CPU tensor it runs the plain
form.  It never sends a CUDA tensor to the plain form.  Each call is a
span ``spgemm`` (``util/profiling.py``) with its route and shapes, and
on a card, inside a set-up's log, the device time of its launch.

Port of ``pyamg_tpu/sparse/spgemm_device.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..util import profiling
from .ell import SparseELL
from .spgemm_kernel import masked_matmul_vals_plain, masked_spgemm_gather

__all__ = ["masked_spgemm_ell", "masked_spgemm_auto", "spgemm_plan",
           "pattern_spgemm", "rap_pattern", "sentinel_cols",
           "ell_transpose_onto", "WIDE"]

# a product with a slab wider than this counts in ``spgemm_wide``
WIDE = 64


def sentinel_cols(pattern: SparseELL) -> torch.Tensor:
    """Pattern column slab with padding slots replaced by -1 (match-never),
    contiguous."""
    return torch.where(pattern.valid_mask(), pattern.cols, -1).contiguous()


def masked_spgemm_ell(A: SparseELL, B: SparseELL,
                      pattern: SparseELL) -> SparseELL:
    """C = (A @ B) restricted to ``pattern``'s slots, by the plain form.

    ``pattern`` supplies the output structure (its data is ignored).
    Entries of the true product outside the pattern are dropped: the
    caller guarantees containment (Galerkin patterns come from the same
    symbolic chain)."""
    vals = masked_matmul_vals_plain(A.data, A.cols, B.data, B.cols,
                                    sentinel_cols(pattern))
    return SparseELL(vals, pattern.cols, pattern.row_nnz, pattern.shape)


def _host_pattern(X):
    import scipy.sparse as sp

    if isinstance(X, SparseELL):
        X = X.to_scipy()
    X = sp.csr_matrix(X).copy()
    X.data = np.ones_like(X.data, dtype=np.float64)
    return X


def pattern_spgemm(A, B, dtype=None, device="cuda") -> SparseELL:
    """Host-symbolic product pattern of A @ B as a structure-only ELL."""
    import scipy.sparse as sp

    C = sp.csr_matrix(_host_pattern(A) @ _host_pattern(B))
    C.sort_indices()
    return SparseELL.from_scipy(C, dtype=dtype or np.float32, device=device)


def rap_pattern(R, A, P, dtype=None, device="cuda"):
    """Host-symbolic patterns ``(pat_AP, pat_RAP)`` of the Galerkin
    product."""
    import scipy.sparse as sp

    pA, pP, pR = _host_pattern(A), _host_pattern(P), _host_pattern(R)
    pAP = sp.csr_matrix(pA @ pP)
    pAP.sort_indices()
    pRAP = sp.csr_matrix(pR @ pAP)
    pRAP.sort_indices()
    dt = dtype or np.float32
    return (SparseELL.from_scipy(pAP, dtype=dt, device=device),
            SparseELL.from_scipy(pRAP, dtype=dt, device=device))


def ell_transpose_onto(A: SparseELL, pattern: SparseELL,
                       row0: int = 0) -> SparseELL:
    """A^T with values computed on A's device onto a host-symbolic pattern.

    Transpose entry (j, i) equals A[i, j]: gather source row i per slot
    (-1 at the pattern's padding) and pick out column j by compare -- the
    gather-and-match shape of the masked product, no scatters.  The
    pattern's rows may be rows ``row0 ..`` of the transpose (a row slab
    whose columns index A's rows as given)."""
    tc = sentinel_cols(pattern)
    rows_t = torch.arange(row0, row0 + tc.shape[0], dtype=A.cols.dtype,
                          device=tc.device)
    src = torch.where(tc >= 0, tc, 0)                      # (n_t, w_t)
    hit = A.cols[src] == rows_t[:, None, None]             # (n_t, w_t, w_a)
    vals = torch.where(hit, A.data[src], 0).sum(dim=2)
    vals = torch.where(tc >= 0, vals, 0).to(A.dtype)
    return SparseELL(vals, pattern.cols, pattern.row_nnz, pattern.shape)


def spgemm_plan(A: SparseELL, B: SparseELL, pattern: SparseELL):
    """The route of :func:`masked_spgemm_auto` for A, B's widths and
    ``pattern``, decided once for products that repeat with new values of
    B (the energy CG's ``A D``): None on a CPU device, else a
    ``BandedSpgemmPlan`` (infeasible: the gather kernel).  Deciding reads
    A's offsets back to the host."""
    if A.data.device.type == "cpu":
        return None
    from .spgemm_dia import BandedSpgemmPlan

    return BandedSpgemmPlan(A, B, pattern)


def masked_spgemm_auto(A: SparseELL, B: SparseELL,
                       pattern: SparseELL, plan=None) -> SparseELL:
    """``masked_spgemm_ell``'s product, routed to a hand-written kernel.

    CUDA: the banded kernel when A has at most 64 distinct ``col - row``
    offsets and its tile fits, else the gather kernel; slabs whose tile
    does not fit a block's shared memory at one row raise.  ``plan``: the
    route from :func:`spgemm_plan` for these A, B widths and pattern, when
    the caller has it; by default it is decided here.  The JAX router's
    size floors (2^17 rows for the banded kernel, 2^19 for the gather
    kernel) were the TPU's dispatch floor and are not ported: every
    product goes to a kernel.  The JAX package's ``MaskedSpgemmPlan``
    (``spgemm_pallas.py``) is not ported either: its tiles, chunks and
    one-hot column tables feed the TPU's matrix unit, and the gather
    kernel follows A's column slab directly.  CPU: the plain form.

    The call runs in the span ``spgemm``: ``route`` (``banded`` or
    ``gather``, the kernel it takes; ``plain`` on the CPU), ``n`` and
    ``nb`` (A's and B's rows), ``w_a``, ``w_b``, ``w_out`` and ``dtype``;
    on a card, inside a set-up's log, the kernel's launcher records CUDA
    events around the kernel (``device_us``, once the set-up reads them).
    A product with a slab wider than :data:`WIDE` counts in
    ``spgemm_wide``."""
    cpu = A.data.device.type == "cpu"
    if plan is None and not cpu:
        plan = spgemm_plan(A, B, pattern)
    widths = (A.width, B.width, pattern.width)
    if max(widths) > WIDE:
        profiling.count("spgemm_wide")
    route = "plain" if cpu else "banded" if plan.feasible else "gather"
    with profiling.span("spgemm", route=route, n=int(A.shape[0]),
                        nb=int(B.shape[0]), w_a=widths[0], w_b=widths[1],
                        w_out=widths[2],
                        dtype=str(A.data.dtype).replace("torch.", "")):
        if cpu:
            return masked_spgemm_ell(A, B, pattern)
        if plan.feasible:
            return plan(A, B)
        vals = masked_spgemm_gather(A.data, A.cols, B.data, B.cols,
                                    sentinel_cols(pattern))
    return SparseELL(vals, pattern.cols, pattern.row_nnz, pattern.shape)
