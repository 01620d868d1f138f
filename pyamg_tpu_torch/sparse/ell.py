"""Padded-ELL sparse storage: the operator of unstructured levels.

Each row's stored entries sit in a fixed-width ``(n_rows, width)`` slab, so
the SpMV is one gather, one multiply and one row sum, and the device
setup's masked products (``spgemm_device``) work on whole slabs.

Conventions (those of ``pyamg_tpu/sparse/ell.py``):

* ``data[i, j]`` / ``cols[i, j]`` hold the j-th stored entry of row i, in
  ascending column order; ``row_nnz[i]`` counts them.
* Padding slots have ``data == 0`` and ``cols == i`` (the row's own index),
  so the SpMV needs no mask.  Where a matrix has more rows than columns
  (a prolongator), a padding slot's own index can lie past the last
  column: the SpMV and its transpose go through a copy of ``cols`` clamped
  once to the column range (XLA's gathers clamp and its scatters drop).

Port of ``pyamg_tpu/sparse/ell.py``.  The JAX package has no Pallas kernel
for the ELL SpMV: it is plain PyTorch here too.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..util.utils import numpy_dtype, torch_dtype

__all__ = ["SparseELL", "ell_matvec"]


def ell_matvec(data: torch.Tensor, cols: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """``y[i] = sum_j data[i, j] * x[cols[i, j]]``."""
    return (data * x[cols]).sum(dim=1)


class SparseELL:
    """Fixed-width padded sparse matrix (ELLPACK layout) on a torch device.

    ``data`` (n_rows, width) values, zero at padding slots; ``cols``
    (n_rows, width) int32 column indices; ``row_nnz`` (n_rows,) int32 count
    of valid slots; ``shape`` (n_rows, n_cols)."""

    def __init__(self, data: torch.Tensor, cols: torch.Tensor,
                 row_nnz: torch.Tensor, shape):
        self.data = data
        self.cols = cols
        self.row_nnz = row_nnz
        self.shape: Tuple[int, int] = (int(shape[0]), int(shape[1]))
        self._gather_cols = None

    # -- properties ---------------------------------------------------------
    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.row_nnz.sum())

    # -- constructors and views ----------------------------------------------
    @staticmethod
    def from_scipy(A, dtype=None, device="cuda", width=None) -> "SparseELL":
        """Padded ELL of a scipy matrix (any format) on ``device``, as wide
        as its longest row (at least 1), or ``width`` wide (ValueError if a
        row is longer)."""
        import scipy.sparse as sp

        A = sp.csr_matrix(A)
        A.sort_indices()
        n, m = A.shape
        nnz_per_row = np.diff(A.indptr).astype(np.int32)
        max_nnz = int(nnz_per_row.max()) if n else 0
        if width is not None and max_nnz > width:
            raise ValueError(f"width={width} < max row nnz {max_nnz}")
        w = max(1, max_nnz if width is None else int(width))
        dt = numpy_dtype(dtype) if dtype is not None else A.dtype
        data = np.zeros((n, w), dtype=dt)
        cols = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, w))
        rows = np.repeat(np.arange(n), nnz_per_row)
        slot = np.arange(A.nnz) - np.repeat(A.indptr[:-1], nnz_per_row)
        data[rows, slot] = A.data.astype(dt)
        cols[rows, slot] = A.indices.astype(np.int32)
        return SparseELL(torch.as_tensor(data, device=device),
                         torch.as_tensor(cols, device=device),
                         torch.as_tensor(nnz_per_row, device=device), (n, m))

    def to_scipy(self):
        """The host CSR matrix of the valid slots."""
        import scipy.sparse as sp

        n, m = self.shape
        valid = self.valid_mask().cpu().numpy()
        rows = np.broadcast_to(np.arange(n)[:, None], valid.shape)
        return sp.coo_matrix(
            (self.data.cpu().numpy()[valid],
             (rows[valid], self.cols.cpu().numpy()[valid])),
            shape=(n, m)).tocsr()

    def valid_mask(self) -> torch.Tensor:
        """(n_rows, width) boolean mask of the valid (non-padding) slots."""
        slots = torch.arange(self.width, dtype=torch.int32,
                             device=self.row_nnz.device)
        return slots[None, :] < self.row_nnz[:, None]

    def diagonal(self) -> torch.Tensor:
        """The main diagonal (0 where not stored)."""
        rows = torch.arange(self.shape[0], dtype=self.cols.dtype,
                            device=self.cols.device)
        return torch.where(self.cols == rows[:, None], self.data,
                           0).sum(dim=1)

    def astype(self, dtype) -> "SparseELL":
        return SparseELL(self.data.to(torch_dtype(dtype)), self.cols,
                         self.row_nnz, self.shape)

    # -- compute --------------------------------------------------------------
    def _cols_in_range(self) -> torch.Tensor:
        """``cols`` with padding slots clamped into the column range (built
        once, and only for matrices with more rows than columns)."""
        if self._gather_cols is None:
            n, m = self.shape
            self._gather_cols = self.cols if n <= m \
                else self.cols.clamp(max=max(m - 1, 0))
        return self._gather_cols

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x."""
        return ell_matvec(self.data, self._cols_in_range(), x)

    def rmatvec(self, y: torch.Tensor) -> torch.Tensor:
        """x = A^T @ y by a scatter-add over the slots."""
        dt = torch.result_type(self.data, y)
        out = torch.zeros(self.shape[1], dtype=dt, device=y.device)
        return out.index_add_(0, self._cols_in_range().reshape(-1),
                              (self.data * y[:, None]).reshape(-1).to(dt))

    def __repr__(self):
        return (f"SparseELL(shape={self.shape}, width={self.width}, "
                f"dtype={self.dtype}, device={self.device})")
