"""The DIA SpMV kernel: its wrapper, its plain PyTorch twin and a launch count.

``y[i] = sum_k diags[k, i] * x[i + offsets[k]]`` with zero wherever
``i + offsets[k]`` falls outside ``[0, m)``.  The diagonals and x are both
float32 or both float64, or the diagonals are bfloat16 and x float32 (then
y is float32, the products taken in float32).

:func:`dia_matvec` launches the hand-written CUDA kernel
(``csrc/dia_matvec.cu``) on a CUDA tensor and raises if it cannot; on a CPU
tensor it runs :func:`dia_matvec_plain`.  There is no size or dtype gate that
sends CUDA tensors elsewhere.  ``launches`` counts kernel launches and
nothing else.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

__all__ = ["dia_matvec", "dia_matvec_plain", "launches", "load"]

launches = 0          # kernel launches since import (or the last reset)

_lib = None


def load() -> ctypes.CDLL:
    """Build (at first use) and bind the kernel library."""
    global _lib
    if _lib is None:
        from .._build import load as build_and_load

        lib = build_and_load("dia_matvec")
        args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        for fn in (lib.dia_matvec_f32, lib.dia_matvec_f64,
                   lib.dia_matvec_bf16_f32):
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


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
          (torch.bfloat16, torch.float32): "dia_matvec_bf16_f32"}


def _check(diags, offsets, x, m):
    if (diags.dtype, x.dtype) not in _ENTRY:
        raise TypeError(f"dia_matvec takes float32 or float64 diags and x of "
                        f"one dtype, or bfloat16 diags with a float32 x; not "
                        f"{diags.dtype} diags with a {x.dtype} x")
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
    tensor goes through the CUDA kernel, a CPU tensor through
    :func:`dia_matvec_plain`."""
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
    fn = getattr(load(), _ENTRY[diags.dtype, x.dtype])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(diags.data_ptr(), offsets.data_ptr(), diags.shape[0], n, m,
             x.data_ptr(), y.data_ptr(), stream, x.device.index)
    if err != 0:
        raise RuntimeError(f"dia_matvec kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return y
