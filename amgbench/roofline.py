"""Peaks of the card and the bytes and operations of the port's kernels.

The peaks are NVIDIA's data sheet for one H100 SXM (80 GB HBM3), dense
rates without sparsity, at the full 700 W power limit: the card a run is
on may be set below it, so every share is printed beside the card's name
and power limit.

A kernel's bound counts each input byte read once and each output byte
written once, and the larger of bytes over HBM bandwidth and operations
over the peak rate of its type is the least time the card could take.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2 ** 20
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}


def dia_bytes(k: int, n: int, m: int, diag_itemsize: int,
              x_itemsize: int) -> int:
    """A DIA matvec of an ``(n, m)`` operator with ``k`` diagonals: the
    ``(k, n)`` diagonals and x (``m``) read once, y (``n``) written once."""
    return k * n * diag_itemsize + (m + n) * x_itemsize


def dia_flops(k: int, n: int) -> int:
    """A multiply and an add for each stored diagonal entry."""
    return 2 * k * n


def ell_bytes(n: int, width: int, m: int, itemsize: int,
              col_itemsize: int) -> int:
    """A padded-ELL matvec of an ``(n, m)`` operator ``width`` slots wide:
    values and column indices read once, x (``m``) read once, y (``n``)
    written once."""
    return n * width * (itemsize + col_itemsize) + (m + n) * itemsize


def ell_flops(n: int, width: int) -> int:
    """A multiply and an add for each slot."""
    return 2 * n * width


def bound_seconds(nbytes: float, flops: float, dtype: str) -> float:
    """The least time of a kernel: bytes over HBM bandwidth or operations
    over the type's peak rate, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])
