"""Masked SpGEMM with a banded left operand, on the banded kernel.

In the setup's product chains the left operand is usually square and
banded: ``S @ T`` and ``A @ P`` on PDE levels have a handful of distinct
``col - row`` offsets.  For those the product reads

    C[i, o] = sum_delta A[i, i+delta] * sum_b Bd[i+delta, b]
                                      * [Bc[i+delta, b] == pat[i, o]]

and ``masked_spgemm_banded`` (``csrc/masked_spgemm.cu``) walks the
offsets, so that neighbouring threads read neighbouring B rows.

Port of ``BandedSpgemmPlan`` (``pyamg_tpu/sparse/spgemm_dia.py``): the
offsets and the ``max_k = 64`` feasibility rule with its 4096-row sample
probe are kept; the TPU's VMEM, halo and width caps are not (the kernel
takes any widths whose tile fits a block's shared memory).  The kernel
computes in the input dtype; the TPU kernel's cast to float32 is not
ported.
"""

from __future__ import annotations

import torch

from .ell import SparseELL
from .spgemm_device import sentinel_cols
from .spgemm_kernel import MAX_OFFSETS, masked_spgemm_banded, tile_geometry

__all__ = ["BandedSpgemmPlan"]


def _distinct_offsets(A: SparseELL, rows=None) -> torch.Tensor:
    """Sorted distinct ``col - row`` of A's valid slots (of ``rows`` only,
    when given), on A's device."""
    cols, valid = A.cols, A.valid_mask()
    r = torch.arange(A.shape[0], dtype=torch.int64, device=cols.device)
    if rows is not None:
        cols, valid, r = cols[rows], valid[rows], r[rows]
    return torch.unique((cols.to(torch.int64) - r[:, None])[valid])


class BandedSpgemmPlan:
    """Plan for ``C = (A @ B)`` restricted to ``pattern`` where A has few
    distinct ``col - row`` offsets.

    ``feasible`` is False when A has more than 64 distinct offsets
    or the banded kernel's tile (A by diagonal besides the gather
    kernel's slabs) does not fit a block's shared memory; the caller then
    takes the gather kernel (:func:`~.spgemm_kernel.masked_spgemm_gather`)."""

    def __init__(self, A: SparseELL, B: SparseELL, pattern: SparseELL):
        self.feasible = False
        self.w_A, self.w_B, self.w_out = A.width, B.width, pattern.width
        self.offsets = ()
        n = A.shape[0]
        if n > 16384:
            # cheap probe: a 4k-row sample of an irregular matrix already
            # has more than 64 offsets, skipping the O(nnz) unique
            sel = torch.linspace(0, n - 1, 4096, dtype=torch.float64,
                                 device=A.cols.device)
            if (_distinct_offsets(A, sel.to(torch.int64)).numel()
                    > MAX_OFFSETS):
                return
        offs = _distinct_offsets(A)
        if offs.numel() > MAX_OFFSETS:
            return
        offsets = tuple(int(o) for o in offs.tolist()) or (0,)
        try:
            tile_geometry(n, self.w_A, self.w_B, self.w_out,
                          A.data.element_size(), len(offsets))
        except ValueError:
            return
        self.offsets = offsets
        self._pattern = pattern
        self._pat_cols = sentinel_cols(pattern)
        self.feasible = True

    def describe(self) -> str:
        return f"k={len(self.offsets)}" if self.feasible else "infeasible"

    def __call__(self, A: SparseELL, B: SparseELL) -> SparseELL:
        if not self.feasible:
            raise ValueError("plan is infeasible; use the gather kernel")
        vals = masked_spgemm_banded(A.data, A.cols, B.data, B.cols,
                                    self._pat_cols, self.offsets)
        pat = self._pattern
        return SparseELL(vals, pat.cols, pat.row_nnz, pat.shape)
