"""Sparse operators of the solve phase: DIA storage on the hand-written
kernel, gather-free grid transfers, and the device-format chooser."""

from .dia import SparseDIA
from .linop import ComposedOp, GridRepeatOp, GridPoolOp, DenseOp
from .device_op import device_operator

__all__ = ["SparseDIA", "ComposedOp", "GridRepeatOp", "GridPoolOp",
           "DenseOp", "device_operator"]
