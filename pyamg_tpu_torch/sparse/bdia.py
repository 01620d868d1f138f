"""Block diagonal-offset (BDIA) sparse storage.

The block analogue of :class:`~pyamg_tpu_torch.sparse.SparseDIA` for square
matrices whose *block* sparsity is banded: multi-candidate smoothed
aggregation on structured grids and Q1 elasticity give operators that are
BSR matrices on a stencil pattern of K x K blocks (K the dofs per node).
One dense ``(n_blocks, K, K)`` array per block diagonal turns the BSR
matvec into shifted batched small-matrix products over a zero-padded x: no
gather.

Port of ``pyamg_tpu/sparse/bdia.py``.  The JAX package computes these
products with an XLA einsum, not a Pallas kernel: they are plain PyTorch
here too.  Blocked levels of the hierarchy take the scalar DIA form (and
its kernel) where it fits; this is their fallback and the form of the
structured path's blocked prolongation smoother S.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..util.utils import numpy_dtype, torch_dtype

__all__ = ["SparseBDIA"]


class SparseBDIA:
    """``blocks[k, i] = A_block[i, i + offsets[k]]`` (a zero K x K block
    where absent or out of range); offsets in block units; square only.
    ``shape`` is the scalar (unblocked) shape."""

    def __init__(self, blocks: torch.Tensor, offsets, shape):
        self.blocks = blocks                      # (n_off, n_brows, K, K)
        self.offsets: Tuple[int, ...] = tuple(int(o) for o in offsets)
        self.shape: Tuple[int, int] = (int(shape[0]), int(shape[1]))

    # -- properties ---------------------------------------------------------
    @property
    def dtype(self):
        return self.blocks.dtype

    @property
    def device(self):
        return self.blocks.device

    @property
    def blocksize(self) -> int:
        return self.blocks.shape[-1]

    @property
    def n_brows(self) -> int:
        return self.blocks.shape[1]

    @property
    def n_offsets(self) -> int:
        return len(self.offsets)

    @property
    def nnz(self) -> int:
        return int(torch.count_nonzero(self.blocks))

    # -- constructors --------------------------------------------------------
    @staticmethod
    def host_blocks(A_bsr, max_offsets: int = 128, dtype=None):
        """Host (numpy) BDIA arrays of a scipy BSR matrix: ``(blocks,
        offsets)``.  Raises ValueError for rectangular blocks or more than
        ``max_offsets`` block diagonals."""
        import scipy.sparse as sp

        A_bsr = sp.bsr_matrix(A_bsr)
        K, K2 = A_bsr.blocksize
        if K != K2:
            raise ValueError("SparseBDIA needs square blocks")
        nb = A_bsr.shape[0] // K
        rows = np.repeat(np.arange(nb, dtype=np.int64),
                         np.diff(A_bsr.indptr))
        offs = A_bsr.indices.astype(np.int64, copy=False) - rows
        uniq = np.unique(offs)
        if uniq.size > max_offsets:
            raise ValueError(
                f"matrix has {uniq.size} block diagonals > {max_offsets}")
        dt = np.dtype(dtype) if dtype is not None else A_bsr.dtype
        if np.iscomplexobj(A_bsr.data) \
                and not np.issubdtype(dt, np.complexfloating):
            raise ValueError("cannot build real BDIA from complex data")
        blocks = np.zeros((uniq.size, nb, K, K), dtype=dt)
        ks = np.searchsorted(uniq, offs)
        blocks[ks, rows] = A_bsr.data.astype(dt, copy=False)
        return blocks, tuple(int(o) for o in uniq)

    @staticmethod
    def from_scipy_bsr(A_bsr, max_offsets: int = 128, dtype=None,
                       device="cuda") -> "SparseBDIA":
        """Convert a scipy BSR matrix; ``dtype`` is a numpy or torch
        dtype."""
        blocks, offsets = SparseBDIA.host_blocks(A_bsr, max_offsets,
                                                 numpy_dtype(dtype))
        return SparseBDIA(torch.as_tensor(blocks, device=device), offsets,
                          A_bsr.shape)

    @staticmethod
    def host_transpose(blocks: np.ndarray, offsets, conj=False):
        """A^T (A^H with ``conj``) of host BDIA arrays: negate the offsets,
        shift each block diagonal and transpose every block."""
        nb = blocks.shape[1]
        K = blocks.shape[-1]
        offs_t = tuple(-o for o in reversed(offsets))
        out = np.zeros((len(offs_t), nb, K, K), dtype=blocks.dtype)
        for j, o in enumerate(offs_t):
            src = blocks[offsets.index(-o)]
            src_t = (src.conj() if conj else src).transpose(0, 2, 1)
            ln = max(min(nb - abs(o), nb), 0)
            if o >= 0:
                out[j, :ln] = src_t[o:o + ln]
            else:
                out[j, -o:-o + ln] = src_t[:ln]
        return out, offs_t

    def to_scipy(self):
        """The operator as a scipy CSR matrix (blocks that are all zero
        dropped)."""
        import scipy.sparse as sp

        nb = self.n_brows
        K = self.blocksize
        blocks = self.blocks.cpu().numpy()
        rows, cols, data = [], [], []
        for k, off in enumerate(self.offsets):
            r = np.arange(nb)
            c = r + off
            valid = (c >= 0) & (c < nb)
            valid &= np.abs(blocks[k]).reshape(nb, -1).sum(axis=1) > 0
            rows.append(r[valid])
            cols.append(c[valid])
            data.append(blocks[k][valid])
        rows = np.concatenate(rows)
        cols = np.concatenate(cols)
        data = np.concatenate(data) if rows.size else \
            np.zeros((0, K, K), dtype=blocks.dtype)
        order = np.argsort(rows, kind="stable")
        rows, cols, data = rows[order], cols[order], data[order]
        indptr = np.concatenate([[0], np.cumsum(
            np.bincount(rows, minlength=nb))])
        return sp.bsr_matrix((data, cols, indptr), shape=self.shape,
                             blocksize=(K, K)).tocsr()

    # -- compute --------------------------------------------------------------
    def _padded(self, X):
        """X as (n_brows, K, m) zero-padded by the extreme offsets along
        the block rows, and the pad below."""
        lo = -min(min(self.offsets), 0)
        hi = max(max(self.offsets), 0)
        return F.pad(X, (0, 0, 0, 0, lo, hi)), lo

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        """``Y_blk[i] = sum_k blocks[k, i] @ X_blk[i + offsets[k]]`` for X of
        shape (n, m)."""
        nb, K = self.n_brows, self.blocksize
        m = X.shape[1]
        Xpad, lo = self._padded(X.reshape(nb, K, m))
        Y = torch.zeros((nb, K, m), dtype=torch.result_type(self.blocks, X),
                        device=X.device)
        for k, off in enumerate(self.offsets):
            Y = Y + torch.einsum("nij,njm->nim", self.blocks[k],
                                 Xpad[lo + off:lo + off + nb])
        return Y.reshape(nb * K, m)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """``y_blk[i] = sum_k blocks[k, i] @ x_blk[i + offsets[k]]``."""
        return self.matmat(x.reshape(-1, 1)).reshape(-1)

    def __matmul__(self, x):
        return self.matvec(x) if x.dim() == 1 else self.matmat(x)

    def diagonal(self) -> torch.Tensor:
        """The scalar main diagonal."""
        if 0 in self.offsets:
            d = torch.diagonal(self.blocks[self.offsets.index(0)],
                               dim1=-2, dim2=-1)
            return d.reshape(-1)
        return torch.zeros(self.shape[0], dtype=self.dtype,
                           device=self.device)

    def block_diagonal(self) -> torch.Tensor:
        """The (n_brows, K, K) main block diagonal."""
        if 0 in self.offsets:
            return self.blocks[self.offsets.index(0)]
        return torch.zeros((self.n_brows, self.blocksize, self.blocksize),
                           dtype=self.dtype, device=self.device)

    def astype(self, dtype) -> "SparseBDIA":
        return SparseBDIA(self.blocks.to(torch_dtype(dtype)), self.offsets,
                          self.shape)

    def __repr__(self):
        return (f"SparseBDIA(shape={self.shape}, K={self.blocksize}, "
                f"n_offsets={self.n_offsets}, dtype={self.dtype}, "
                f"device={self.device})")
