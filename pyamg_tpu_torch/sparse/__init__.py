"""Sparse operators: DIA storage on the hand-written SpMV kernel
(``dia_kernel``; ``dia_variants`` holds two more DIA SpMV kernels in other
layouts, which the DIA benchmark runs), padded ELL with the masked-SpGEMM
kernels of the device setup, gather-free grid transfers, and the
device-format chooser."""

from .dia import SparseDIA
from .ell import SparseELL
from .linop import ComposedOp, GridRepeatOp, GridPoolOp, DenseOp
from .device_op import device_operator

__all__ = ["SparseDIA", "SparseELL", "ComposedOp", "GridRepeatOp", "GridPoolOp",
           "DenseOp", "device_operator"]
