"""Device-format selection for hierarchy operators.

Priority: DIA (shift-multiply-add on the hand-written kernel) -> dense for
small operators -> padded-ELL gather for the rest.

Port of ``pyamg_tpu/sparse/device_op.py`` with the same thresholds.
"""

from __future__ import annotations

import numpy as np
import torch

from ..amg_core import csr_to_dia_fill_native, dia_offsets_native
from ..util.utils import numpy_dtype
from .dia import SparseDIA
from .ell import SparseELL
from .linop import DenseOp

__all__ = ["device_operator", "count_diagonals"]

DIA_MAX_OFFSETS = 512
DIA_MEM_BUDGET = 10          # accept k*n up to this multiple of nnz
DIA_MEM_FLOOR = 64_000_000   # ... or up to this many stored entries
DENSE_MAX = 4096


def _entry_rows_offsets(A_csr):
    """(row, col - row) for every stored entry, in int32."""
    rows = np.repeat(np.arange(A_csr.shape[0], dtype=np.int32),
                     np.diff(A_csr.indptr))
    return rows, A_csr.indices.astype(np.int32, copy=False) - rows


def count_diagonals(A_csr) -> int:
    """The number of distinct diagonals (col - row) that hold an entry."""
    import scipy.sparse as sp

    return int(np.unique(_entry_rows_offsets(sp.csr_matrix(A_csr))[1]).size)


def device_operator(A_csr, dia_max_offsets: int = DIA_MAX_OFFSETS,
                    dense_max: int = DENSE_MAX, dtype=None, device="cuda"):
    """The device representation of a host CSR operator: ``SparseDIA`` when
    its diagonals fit the budget, else ``DenseOp`` when small, else
    ``SparseELL``."""
    import scipy.sparse as sp

    A_csr = sp.csr_matrix(A_csr)
    npdt = numpy_dtype(dtype)
    n, m = A_csr.shape
    # the compiled passes find the offsets and fill the diagonals in one
    # stream each; numpy discovery without them (or above the limit)
    offs = dia_offsets_native(A_csr, max_offsets=dia_max_offsets)
    entry_rows = entry_offs = None
    if offs is None:
        entry_rows, entry_offs = _entry_rows_offsets(A_csr)
        offs = np.unique(entry_offs)
    k = int(offs.size)
    mem_ok = k * n <= max(DIA_MEM_BUDGET * max(A_csr.nnz, 1), DIA_MEM_FLOOR)
    if k <= dia_max_offsets and mem_ok:
        diags = csr_to_dia_fill_native(A_csr, offs, dtype=npdt)
        uniq = tuple(int(o) for o in offs)
        if diags is None:
            diags, uniq = SparseDIA.host_diags(
                A_csr, max_offsets=dia_max_offsets, dtype=npdt, offsets=offs,
                entry_offsets=entry_offs, entry_rows=entry_rows)
        return SparseDIA(torch.as_tensor(diags, device=device), uniq,
                         A_csr.shape)
    if n <= dense_max and m <= dense_max:
        if npdt is not None and A_csr.dtype != npdt:
            A_csr = A_csr.astype(npdt)
        return DenseOp(torch.as_tensor(A_csr.toarray(), device=device),
                       (n, m))
    return SparseELL.from_scipy(A_csr, dtype=npdt, device=device)
