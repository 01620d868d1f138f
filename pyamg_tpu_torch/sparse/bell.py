"""Block padded-ELL (BELL) storage: a block matrix as a fixed-width slab of
dense blocks, so that block operations are batched dense operations.

Layout: ``data`` (n_brows, width, bs, bs), ``cols`` (n_brows, width)
int32 block-column indices, ``row_nnz`` (n_brows,) int32; padding blocks
are zero with ``cols`` equal to the block row's own index.

Port of ``pyamg_tpu/sparse/bell.py`` (plain PyTorch, as the JAX package's
is plain XLA).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..util.utils import numpy_dtype, torch_dtype

__all__ = ["BlockELL"]


class BlockELL:
    """Fixed-width padded block-sparse matrix on a torch device; ``shape``
    is the scalar (unblocked) shape."""

    def __init__(self, data: torch.Tensor, cols: torch.Tensor,
                 row_nnz: torch.Tensor, shape):
        self.data = data
        self.cols = cols
        self.row_nnz = row_nnz
        self.shape: Tuple[int, int] = (int(shape[0]), int(shape[1]))

    @property
    def blocksize(self) -> int:
        return self.data.shape[-1]

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
    def n_brows(self) -> int:
        return self.data.shape[0]

    @staticmethod
    def from_scipy(A, blocksize: int | None = None, width: int | None = None,
                   dtype=None, device="cuda") -> "BlockELL":
        """BELL of a scipy matrix (any format) in (blocksize, blocksize)
        blocks (a BSR input's own by default), as wide as its longest block
        row unless ``width`` is given."""
        import scipy.sparse as sp

        if blocksize is None:
            blocksize = A.blocksize[0] if sp.issparse(A) and A.format == "bsr" \
                else 1
        B = sp.bsr_matrix(A, blocksize=(blocksize, blocksize))
        B.sort_indices()
        nb = B.shape[0] // blocksize
        nnz_per_row = np.diff(B.indptr).astype(np.int32)
        w = max(1, int(nnz_per_row.max()) if width is None else width)
        npdt = numpy_dtype(dtype)
        dt = npdt if npdt is not None else B.dtype
        data = np.zeros((nb, w, blocksize, blocksize), dtype=dt)
        cols = np.tile(np.arange(nb, dtype=np.int32)[:, None], (1, w))
        rows = np.repeat(np.arange(nb), nnz_per_row)
        offs = np.arange(len(B.indices)) - np.repeat(B.indptr[:-1],
                                                     nnz_per_row)
        data[rows, offs] = B.data.astype(dt)
        cols[rows, offs] = B.indices.astype(np.int32)
        return BlockELL(torch.as_tensor(data, device=device),
                        torch.as_tensor(cols, device=device),
                        torch.as_tensor(nnz_per_row, device=device), B.shape)

    def to_scipy(self):
        """The operator as a scipy CSR matrix."""
        import scipy.sparse as sp

        data = self.data.cpu().numpy()
        cols = self.cols.cpu().numpy()
        nnz = self.row_nnz.cpu().numpy()
        valid = np.arange(self.width)[None, :] < nnz[:, None]
        indptr = np.concatenate([[0], np.cumsum(nnz)]).astype(np.int32)
        return sp.bsr_matrix((data[valid], cols[valid], indptr),
                             shape=self.shape).tocsr()

    def valid_mask(self) -> torch.Tensor:
        """(n_brows, width) True at stored blocks."""
        return (torch.arange(self.width, dtype=torch.int32,
                             device=self.device)[None, :]
                < self.row_nnz[:, None])

    def block_diagonal(self) -> torch.Tensor:
        """(n_brows, bs, bs) diagonal blocks (zero where absent)."""
        own = torch.arange(self.n_brows, dtype=self.cols.dtype,
                           device=self.device)[:, None]
        isdiag = (self.cols == own)[:, :, None, None]
        return torch.where(isdiag, self.data,
                           torch.zeros((), dtype=self.dtype,
                                       device=self.device)).sum(dim=1)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """``y = A @ x``, x of the unblocked length ``shape[1]``."""
        bs = self.blocksize
        xb = x.reshape(self.shape[1] // bs, bs)
        return torch.einsum("nwij,nwj->ni", self.data,
                            xb[self.cols]).reshape(-1)

    def __matmul__(self, x):
        return self.matvec(x)

    def astype(self, dtype) -> "BlockELL":
        return BlockELL(self.data.to(torch_dtype(dtype)), self.cols,
                        self.row_nnz, self.shape)

    def __repr__(self):
        return (f"BlockELL(shape={self.shape}, blocksize={self.blocksize}, "
                f"width={self.width}, dtype={self.dtype}, "
                f"device={self.device})")
