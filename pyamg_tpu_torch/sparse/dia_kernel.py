"""The DIA SpMV kernel: its wrapper, its plain PyTorch twin and a launch count.

``y[i] = sum_k diags[k, i] * x[i + offsets[k]]`` with zero wherever
``i + offsets[k]`` falls outside ``[0, m)``.  The diagonals and x are both
float32, float64, complex64 or complex128, or the diagonals are bfloat16 and
x float32 (then y is float32, the products taken in float32).

:func:`dia_matvec` launches the hand-written CUDA kernel
(``csrc/dia_matvec.cu``) on a CUDA tensor and raises if it cannot; on a CPU
tensor it runs :func:`dia_matvec_plain`.  There is no size or dtype gate that
sends CUDA tensors elsewhere.  ``launches`` counts kernel launches and
nothing else.

The kernel has two routes with the same arithmetic: "tall" (a thread a
row) and "wide" (threads over (row, offset) pairs, for operators of few
rows and many offsets).  Its launcher chooses one from ``(n, k)``;
:func:`route` and :func:`wide_geometry` mirror that choice and the wide
route's tile for tests.  ``_dia_matvec_route`` forces a route, for timing
both on one shape; the port's code calls :func:`dia_matvec`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

__all__ = ["dia_matvec", "dia_matvec_plain", "launches", "entry_launches",
           "load", "route", "wide_geometry", "ROUTES"]

launches = 0          # kernel launches since import (or the last reset)

# the launcher's route argument; the port passes "auto"
ROUTES = {"auto": 0, "tall": 1, "wide": 2}
# csrc/dia_matvec.cu's wide route: threads a block, rows a block at least,
# the grid that fills the card (4 blocks of 512 an SM), bytes of staged
# products a block, and choose_route's limits: up to ``rows`` rows, the
# wide route from ``offsets`` offsets on
WIDE_THREADS = 512
WIDE_MIN_ROWS = 4
WIDE_BLOCKS = 132 * 4
WIDE_TILE_BYTES = 32 * 1024
WIDE_LIMITS = ((8192, 7), (16384, 16), (32768, 21), (65536, 111))

_lib = None


def load() -> ctypes.CDLL:
    """Build (at first use) and bind the kernel library."""
    global _lib
    if _lib is None:
        from .._build import load as build_and_load

        lib = build_and_load("dia_matvec")
        args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.dia_matvec_route.argtypes = [ctypes.c_int64, ctypes.c_int]
        for name in ("dia_matvec_wide_rows", "dia_matvec_wide_chunk"):
            getattr(lib, name).argtypes = [ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_int]
        _lib = lib
    return _lib


def route(n: int, k: int) -> str:
    """The route the launcher takes for an ``(n, m)`` operator with ``k``
    offsets, in every dtype: "wide" where the tall route's thread a row
    cannot fill the card and its chain of ``k`` dependent adds is long
    (``WIDE_LIMITS``: up to 8,192 rows from 7 offsets on, ..., up to
    65,536 from 111), else "tall" (``choose_route`` in the source)."""
    for rows, offsets in WIDE_LIMITS:
        if n <= rows:
            return "wide" if k >= offsets else "tall"
    return "tall"


def wide_geometry(n: int, k: int, itemsize: int):
    """``(rows, chunk)`` of the wide route: rows a block of 512 threads
    (the smallest power of two from 4 that keeps every lane of a row
    busy, 512 / rows <= k rounded up to a power of two, and the grid
    within 4 blocks an SM) and offsets a chunk of the 32 KB shared tile
    of ``itemsize``-byte products."""
    kp = 1
    while kp < k and kp < WIDE_THREADS:
        kp *= 2
    rows = WIDE_MIN_ROWS
    while rows < WIDE_THREADS and (rows * kp < WIDE_THREADS
                                   or -(-n // rows) > WIDE_BLOCKS):
        rows *= 2
    return rows, WIDE_TILE_BYTES // (rows * itemsize)


def dia_matvec_plain(diags: torch.Tensor, offsets, x: torch.Tensor,
                     m: int) -> torch.Tensor:
    """Plain shift-multiply-add form (``SparseDIA.matvec_xla`` in the JAX
    package): pad x once, accumulate k shifted products in offset order.
    ``offsets`` is a tuple of ints."""
    n = diags.shape[1]
    lo = -min(min(offsets), 0)
    hi = max(max(offsets), 0)
    xpad = F.pad(x, (lo, hi + max(n - m, 0)))
    y = torch.zeros(n, dtype=torch.result_type(diags, x), device=x.device)
    for k, off in enumerate(offsets):
        y = y + diags[k] * xpad[lo + off:lo + off + n]
    return y


# (diags dtype, x dtype) -> the library's entry point
_ENTRY = {(torch.float32, torch.float32): "dia_matvec_f32",
          (torch.float64, torch.float64): "dia_matvec_f64",
          (torch.bfloat16, torch.float32): "dia_matvec_bf16_f32",
          (torch.complex64, torch.complex64): "dia_matvec_c64",
          (torch.complex128, torch.complex128): "dia_matvec_c128"}
# the same launches, counted by the library's entry point
entry_launches = dict.fromkeys(_ENTRY.values(), 0)


def _check(diags, offsets, x, m):
    if (diags.dtype, x.dtype) not in _ENTRY:
        raise TypeError(f"dia_matvec takes float32, float64, complex64 or "
                        f"complex128 diags and x of one dtype, or bfloat16 "
                        f"diags with a float32 x; not {diags.dtype} diags "
                        f"with a {x.dtype} x")
    if offsets.dtype != torch.int32:
        raise TypeError("dia_matvec: offsets must be int32")
    if not (diags.device == x.device == offsets.device):
        raise ValueError(f"dia_matvec: diags on {diags.device}, offsets on "
                         f"{offsets.device}, x on {x.device}")
    if diags.dim() != 2 or x.dim() != 1 or offsets.dim() != 1:
        raise ValueError("dia_matvec: diags must be (k, n), x and offsets "
                         "1-D")
    if offsets.shape[0] != diags.shape[0] or x.shape[0] != m:
        raise ValueError(f"dia_matvec: {offsets.shape[0]} offsets for "
                         f"{diags.shape[0]} diagonals; x has {x.shape[0]} "
                         f"entries, the operator {m} columns")
    if not (diags.is_contiguous() and x.is_contiguous()
            and offsets.is_contiguous()):
        raise ValueError("dia_matvec: diags, offsets and x must be "
                         "contiguous")


def dia_matvec(diags: torch.Tensor, offsets: torch.Tensor, x: torch.Tensor,
               m: int) -> torch.Tensor:
    """DIA SpMV of the ``(diags.shape[1], m)`` operator with ``x``.

    ``offsets`` is an int32 tensor on the device of ``diags``.  A CUDA
    tensor goes through the CUDA kernel, on the route its launcher
    chooses; a CPU tensor through :func:`dia_matvec_plain`."""
    return _dia_matvec_route(diags, offsets, x, m, "auto")


def _dia_matvec_route(diags, offsets, x, m, which):
    """:func:`dia_matvec` on the kernel's route ``which`` ("auto", "tall"
    or "wide"); a CPU tensor runs the twin whatever the route.  For timing
    and testing the routes: the port calls :func:`dia_matvec`."""
    global launches
    _check(diags, offsets, x, m)
    if x.device.type == "cpu":
        return dia_matvec_plain(diags, tuple(offsets.tolist()), x, m)
    if x.device.type != "cuda":
        raise ValueError(f"dia_matvec: no kernel for device {x.device}")
    n = diags.shape[1]
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    if n == 0:
        return y
    entry = _ENTRY[diags.dtype, x.dtype]
    fn = getattr(load(), entry)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(diags.data_ptr(), offsets.data_ptr(), diags.shape[0], n, m,
             x.data_ptr(), y.data_ptr(), stream, x.device.index,
             ROUTES[which])
    if err != 0:
        raise RuntimeError(f"dia_matvec kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    entry_launches[entry] += 1
    return y
