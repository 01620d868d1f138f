"""Diagonal-offset (DIA) sparse storage: the operator of structured levels.

Matrices from discretized PDEs on grids, and their Galerkin coarse operators
under grid-block aggregation, have entries on a handful of fixed diagonals.
One dense vector per diagonal turns the SpMV into shifted multiply-adds, run
on the card by the hand-written kernel in ``dia_kernel``.

Port of ``pyamg_tpu/sparse/dia.py``.  :class:`ShardedDIA` is one rank's
row slab of a square DIA operator row-sharded over a mesh of ranks: the
matvec exchanges ``max|offset|`` entries with the neighbours its offsets
reach and runs the same kernel on the rectangular slab.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..amg_core import csr_to_dia_native
from ..util.utils import numpy_dtype, torch_dtype
from . import dia_kernel

__all__ = ["SparseDIA", "ShardedDIA"]


class SparseDIA:
    """``diags[k, i] = A[i, i + offsets[k]]`` (zero where absent or out of
    range), square or rectangular.

    ``offsets`` is kept twice: as a tuple of ints for the plain version and
    as an int32 tensor on the operator's device, built once here, for the
    kernel (a per-call host-to-device copy would sit on every matvec)."""

    def __init__(self, diags: torch.Tensor, offsets, shape,
                 offsets_dev: torch.Tensor | None = None):
        self.diags = diags
        self.offsets: Tuple[int, ...] = tuple(int(o) for o in offsets)
        self.shape: Tuple[int, int] = (int(shape[0]), int(shape[1]))
        if offsets_dev is None or offsets_dev.device != diags.device:
            offsets_dev = torch.tensor(self.offsets, dtype=torch.int32,
                                       device=diags.device)
        self.offsets_dev = offsets_dev

    # -- properties ---------------------------------------------------------
    @property
    def dtype(self):
        return self.diags.dtype

    @property
    def device(self):
        return self.diags.device

    @property
    def n_offsets(self) -> int:
        return len(self.offsets)

    @property
    def nnz(self) -> int:
        return int(torch.count_nonzero(self.diags))

    # -- constructors --------------------------------------------------------
    @staticmethod
    def host_diags(A, max_offsets: int = 128, dtype=None, offsets=None,
                   entry_offsets=None, entry_rows=None):
        """Host (numpy) DIA arrays of a scipy matrix: ``(diags, offsets)``.

        ``dtype``: numpy dtype to build the array in.  ``offsets``: known
        sorted distinct offsets (validated against the entries).
        ``entry_offsets``/``entry_rows``: precomputed per-entry col - row
        and row arrays."""
        import scipy.sparse as sp

        A = sp.csr_matrix(A)
        n, m = A.shape
        if offsets is None and entry_offsets is None and entry_rows is None:
            out = csr_to_dia_native(A, dtype=dtype, max_offsets=max_offsets)
            if out is not None:
                return out
            # else the numpy staging below (which also raises above the
            # limit, as the compiled pass refuses)
        if entry_rows is None:
            rows = np.repeat(np.arange(n, dtype=np.int32),
                             np.diff(A.indptr))
        else:
            rows = entry_rows
        if entry_offsets is None:
            offs = A.indices.astype(np.int32, copy=False) - rows
        else:
            offs = entry_offsets
        if offsets is None:
            uniq = np.unique(offs)
        else:
            uniq = np.asarray(sorted(int(o) for o in offsets),
                              dtype=offs.dtype)
        if uniq.size > max_offsets:
            raise ValueError(
                f"matrix has {uniq.size} distinct diagonals > {max_offsets}")
        dt = np.dtype(dtype) if dtype is not None else A.dtype
        if np.iscomplexobj(A.data) \
                and not np.issubdtype(dt, np.complexfloating):
            raise ValueError("cannot build real DIA from complex data")
        diags = np.zeros((uniq.size, n), dtype=dt)
        # offset -> slot lookup table: an O(nnz) gather
        lut = np.full(n + m + 1, -1, dtype=np.int64)
        lut[uniq + n] = np.arange(uniq.size, dtype=np.int64)
        ks = lut[offs.astype(np.int64, copy=False) + n]
        if offsets is not None and entry_offsets is None:
            if (ks < 0).any():
                raise ValueError("provided offsets do not cover the matrix")
        diags.reshape(-1)[ks * n + rows] = A.data.astype(dt, copy=False)
        return diags, tuple(int(o) for o in uniq)

    @staticmethod
    def from_scipy(A, max_offsets: int = 128, dtype=None,
                   device="cuda") -> "SparseDIA":
        """Convert a scipy matrix; ``dtype`` is a numpy or torch dtype.
        Raises ValueError above ``max_offsets`` distinct diagonals."""
        diags, uniq = SparseDIA.host_diags(A, max_offsets=max_offsets,
                                           dtype=numpy_dtype(dtype))
        return SparseDIA(torch.as_tensor(diags, device=device), uniq,
                         A.shape)

    @staticmethod
    def host_transpose(diags: np.ndarray, offsets, shape):
        """Transpose of host DIA arrays: the (-o) diagonal of A^T at row j is
        A's (o) diagonal at row j+o.  Returns ``(diags_T, offsets_T)`` of the
        ``shape[::-1]`` operator."""
        n, m = shape
        offs_t = tuple(-o for o in reversed(offsets))
        out = np.zeros((len(offs_t), m), dtype=diags.dtype)
        for j, o in enumerate(offs_t):
            src = diags[offsets.index(-o)]
            ln = min(n, m + o) if o < 0 else min(n - o, m)
            ln = max(ln, 0)
            if o >= 0:
                out[j, :ln] = src[o:o + ln]
            else:
                out[j, -o:-o + ln] = src[:ln]
        return out, offs_t

    def to_scipy(self):
        import scipy.sparse as sp

        n, m = self.shape
        diags = self.diags.cpu().numpy()
        rows, cols, vals = [], [], []
        for k, off in enumerate(self.offsets):
            r = np.arange(n)
            c = r + off
            valid = (c >= 0) & (c < m) & (diags[k] != 0)
            rows.append(r[valid])
            cols.append(c[valid])
            vals.append(diags[k][valid])
        return sp.coo_matrix(
            (np.concatenate(vals), (np.concatenate(rows),
                                    np.concatenate(cols))),
            shape=self.shape).tocsr()

    # -- compute --------------------------------------------------------------
    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """``y[i] = sum_k diags[k, i] * x[i + offsets[k]]``: the CUDA kernel
        on the card, its plain version on the CPU."""
        return dia_kernel.dia_matvec(self.diags, self.offsets_dev, x,
                                     self.shape[1])

    def matvec_plain(self, x: torch.Tensor) -> torch.Tensor:
        """The plain PyTorch shift-multiply-add, on any device."""
        return dia_kernel.dia_matvec_plain(self.diags, self.offsets, x,
                                           self.shape[1])

    def diagonal(self) -> torch.Tensor:
        if 0 in self.offsets:
            return self.diags[self.offsets.index(0)]
        return torch.zeros(self.shape[0], dtype=self.dtype,
                           device=self.device)

    def astype(self, dtype) -> "SparseDIA":
        return SparseDIA(self.diags.to(torch_dtype(dtype)), self.offsets,
                         self.shape,
                         offsets_dev=self.offsets_dev)

    def like(self, diags, offsets) -> "SparseDIA":
        """An operator of this one's shape and placement with other
        diagonals."""
        return SparseDIA(diags, offsets, self.shape)

    def __repr__(self):
        return (f"SparseDIA(shape={self.shape}, n_offsets={self.n_offsets}, "
                f"dtype={self.dtype}, device={self.device})")


class ShardedDIA:
    """This rank's rows of a square DIA operator row-sharded over a mesh:
    ``diags`` is ``(k, nl)``, the rows ``layout.start ..`` of the whole
    operator's diagonals (zero where the column falls outside it).

    ``matvec`` takes this rank's rows of x, receives the ``lo = max(0,
    -min(offsets))`` entries before them and the ``hi = max(0,
    max(offsets))`` after them from the ranks that hold them (zeros beyond
    the first and last row), and runs the DIA kernel on the rectangular
    ``(nl, lo + nl + hi)`` slab with every offset shifted by ``lo``: the
    products and their order are the whole operator's.  ``shape`` is the
    whole operator's."""

    def __init__(self, diags: torch.Tensor, offsets, layout, nnz=None):
        self.diags = diags
        self.offsets: Tuple[int, ...] = tuple(int(o) for o in offsets)
        self.layout = layout
        self.shape: Tuple[int, int] = (layout.n, layout.n)
        self.lo = max(0, -min(self.offsets))
        self.hi = max(0, max(self.offsets))
        self.ext_offsets = tuple(o + self.lo for o in self.offsets)
        self.offsets_dev = torch.tensor(self.ext_offsets, dtype=torch.int32,
                                        device=diags.device)
        self.halo = layout.halo(self.lo, self.hi)
        self._nnz = nnz

    @property
    def dtype(self):
        return self.diags.dtype

    @property
    def device(self):
        return self.diags.device

    @property
    def n_offsets(self) -> int:
        return len(self.offsets)

    @property
    def nnz(self) -> int:
        """Nonzeros of the whole operator (a collective at the first
        call)."""
        if self._nnz is None:
            count = torch.count_nonzero(self.diags).reshape(1)
            self._nnz = int(self.layout.mesh.all_reduce(count).item())
        return self._nnz

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``A x`` from this rank's rows of x."""
        xe = self.halo.extend(x)
        return dia_kernel.dia_matvec(self.diags, self.offsets_dev, xe,
                                     xe.shape[0])

    def matvec_plain(self, x: torch.Tensor) -> torch.Tensor:
        xe = self.halo.extend(x)
        return dia_kernel.dia_matvec_plain(self.diags, self.ext_offsets, xe,
                                           xe.shape[0])

    def diagonal(self) -> torch.Tensor:
        if 0 in self.offsets:
            return self.diags[self.offsets.index(0)]
        return self.diags.new_zeros(self.diags.shape[1])

    def astype(self, dtype) -> "ShardedDIA":
        return ShardedDIA(self.diags.to(torch_dtype(dtype)), self.offsets,
                          self.layout, self._nnz)

    def like(self, diags, offsets) -> "ShardedDIA":
        """An operator of this one's shape and placement with other
        diagonals."""
        return ShardedDIA(diags, offsets, self.layout)

    def transpose(self) -> "ShardedDIA":
        """``A^T`` row-sharded as A: the (o) diagonal of A^T at row j is
        A's (-o) diagonal at row j + o, read from the neighbours' rows."""
        m = max(abs(o) for o in self.offsets)
        nl = self.diags.shape[1]
        ext = self.layout.halo(m, m).extend(self.diags.T.contiguous())
        offsets = tuple(-o for o in reversed(self.offsets))
        rows = [ext[m + o:m + o + nl, self.offsets.index(-o)]
                for o in offsets]
        return ShardedDIA(torch.stack(rows), offsets, self.layout)

    def full_diags(self) -> torch.Tensor:
        """The whole operator's ``(k, n)`` diagonals (a collective)."""
        return self.layout.full(self.diags.T.contiguous()).T.contiguous()

    def to_scipy(self):
        """The whole operator as a host CSR matrix (a collective)."""
        return SparseDIA(self.full_diags(), self.offsets,
                         self.shape).to_scipy()

    def __repr__(self):
        return (f"ShardedDIA(shape={self.shape}, rows={self.layout.start}.."
                f"{self.layout.start + self.layout.nl}, "
                f"n_offsets={self.n_offsets}, dtype={self.dtype})")
