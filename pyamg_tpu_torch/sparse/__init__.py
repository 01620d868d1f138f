"""Sparse operators: DIA storage on the hand-written SpMV kernel
(``dia_kernel``; ``dia_variants`` holds two more DIA SpMV kernels in other
layouts, which the DIA benchmark runs), padded ELL with the masked-SpGEMM
kernels of the device setup, their block forms (``SparseBDIA``, banded
blocks in shifted batched products; ``BlockELL``), gather-free grid
transfers, the fine-embedded
DIA transfers of unstructured levels (``embed``), the device-format
chooser, and the host structural products ``spgemm``, ``rap`` and
``transpose`` (``ops``)."""

from .bdia import SparseBDIA
from .bell import BlockELL
from .dia import SparseDIA
from .ell import SparseELL, ell_matvec
from .linop import (ComposedOp, CptProlongOp, CptRestrictOp, DenseOp,
                    GridPoolOp, GridRepeatOp)
from .device_op import count_diagonals, device_operator
from .embed import embedded_dia_transfers, root_embedded_transfers
from .ops import rap, spgemm, transpose

__all__ = ["SparseDIA", "SparseELL", "SparseBDIA", "BlockELL", "ComposedOp",
           "GridRepeatOp", "GridPoolOp", "DenseOp", "CptProlongOp",
           "CptRestrictOp", "device_operator", "ell_matvec",
           "embedded_dia_transfers", "root_embedded_transfers",
           "count_diagonals", "spgemm", "rap", "transpose"]
