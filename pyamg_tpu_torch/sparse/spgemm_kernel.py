"""The masked-SpGEMM kernels: their wrappers, their plain PyTorch twin and
launch counts.

``out[i, o] = sum_a sum_b Ad[i, a] * Bd[Ac[i, a], b]
                          * [Bc[Ac[i, a], b] == pat[i, o]]``

on padded-ELL slabs; ``pat`` holds -1 at the output's padding slots.

* :func:`masked_spgemm_gather` launches ``masked_spgemm_gather`` of
  ``csrc/masked_spgemm.cu`` (any A);
* :func:`masked_spgemm_banded` launches ``masked_spgemm_banded`` (A with
  at most 64 distinct ``col - row`` offsets, passed as ``offsets``).

On a CUDA tensor each launches its kernel or raises; on a CPU tensor each
runs :func:`masked_matmul_vals_plain`, the JAX package's XLA gather
formulation (``pyamg_tpu/sparse/spgemm_device.py::_masked_matmul_vals``).
``launches`` counts kernel launches by kernel name and nothing else;
``plain_cuda_calls`` counts calls of the plain twin on CUDA tensors, which
only comparisons make.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["masked_spgemm_gather", "masked_spgemm_banded",
           "masked_matmul_vals_plain", "launches", "plain_cuda_calls",
           "MAX_WIDTH", "MAX_OFFSETS", "load"]

MAX_WIDTH = 64          # widest A, B or output slab the kernels take
MAX_OFFSETS = 64        # most diagonals of a banded A

launches = {"masked_spgemm_banded": 0, "masked_spgemm_gather": 0}
plain_cuda_calls = 0

_lib = None


def load() -> ctypes.CDLL:
    """Build (at first use) and bind the kernel library."""
    global _lib
    if _lib is None:
        from .._build import load as build_and_load

        lib = build_and_load("masked_spgemm")
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        gather = [p, p, i, i64, p, p, i, i64, p, i, p, p, i]
        banded = gather[:11] + [ctypes.POINTER(ctypes.c_int32), i, p, i]
        for fn in (lib.masked_spgemm_gather_f32, lib.masked_spgemm_gather_f64):
            fn.argtypes = gather
            fn.restype = ctypes.c_int
        for fn in (lib.masked_spgemm_banded_f32, lib.masked_spgemm_banded_f64):
            fn.argtypes = banded
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def masked_matmul_vals_plain(Ad, Ac, Bd, Bc, pat_cols) -> torch.Tensor:
    """The plain twin of both kernels: a loop over A's slots, a gather of
    B rows, a broadcast compare against the pattern and a sum.

    A's padding slots (data 0) may name a row past B's end; the gather
    clamps it, as XLA's does, and the slot contributes 0."""
    global plain_cuda_calls
    if Ad.device.type == "cuda":
        plain_cuda_calls += 1
    acc = torch.zeros(pat_cols.shape, dtype=torch.result_type(Ad, Bd),
                      device=Ad.device)
    rows = Ac.clamp(0, max(Bd.shape[0] - 1, 0))
    for a in range(Ad.shape[1]):
        bg = Bd[rows[:, a]]                                  # (n, w_B)
        hit = Bc[rows[:, a]][:, :, None] == pat_cols[:, None, :]
        contrib = (Ad[:, a, None] * bg)[:, :, None]
        acc = acc + torch.where(hit, contrib, 0).sum(dim=1)
    return acc


def _check(name, Ad, Ac, Bd, Bc, pat_cols):
    if Ad.dtype not in (torch.float32, torch.float64) or Bd.dtype != Ad.dtype:
        raise TypeError(f"{name} takes float32 or float64 A and B of one "
                        f"dtype, not {Ad.dtype} and {Bd.dtype}")
    if any(t.dtype != torch.int32 for t in (Ac, Bc, pat_cols)):
        raise TypeError(f"{name}: column slabs must be int32")
    if len({t.device for t in (Ad, Ac, Bd, Bc, pat_cols)}) != 1:
        raise ValueError(f"{name}: operands lie on different devices")
    if any(t.dim() != 2 for t in (Ad, Ac, Bd, Bc, pat_cols)):
        raise ValueError(f"{name}: every slab must be 2-D")
    if (Ac.shape != Ad.shape or Bc.shape != Bd.shape
            or pat_cols.shape[0] != Ad.shape[0]):
        raise ValueError(f"{name}: A {tuple(Ad.shape)}/{tuple(Ac.shape)}, "
                         f"B {tuple(Bd.shape)}/{tuple(Bc.shape)}, pattern "
                         f"{tuple(pat_cols.shape)} do not fit")
    widest = max(Ad.shape[1], Bd.shape[1], pat_cols.shape[1])
    if widest > MAX_WIDTH:
        raise ValueError(f"{name} takes slabs up to {MAX_WIDTH} wide, "
                         f"not {widest}")
    if not all(t.is_contiguous() for t in (Ad, Ac, Bd, Bc, pat_cols)):
        raise ValueError(f"{name}: every slab must be contiguous")


def _launch(name, fn, Ad, Ac, Bd, Bc, pat_cols, *extra):
    n, w_out = pat_cols.shape
    out = torch.empty((n, w_out), dtype=Ad.dtype, device=Ad.device)
    if n == 0 or w_out == 0:
        return out
    stream = torch.cuda.current_stream(Ad.device).cuda_stream
    err = fn(Ad.data_ptr(), Ac.data_ptr(), Ad.shape[1], n, Bd.data_ptr(),
             Bc.data_ptr(), Bd.shape[1], Bd.shape[0], pat_cols.data_ptr(),
             w_out, out.data_ptr(), *extra, stream, Ad.device.index)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1
    return out


def _route(name, Ad):
    if Ad.device.type == "cpu":
        return False
    if Ad.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {Ad.device}")
    return True


def masked_spgemm_gather(Ad, Ac, Bd, Bc, pat_cols) -> torch.Tensor:
    """Values of ``(A @ B)`` at the pattern's slots, for any A.  A CUDA
    tensor goes through the gather kernel, a CPU tensor through
    :func:`masked_matmul_vals_plain`."""
    name = "masked_spgemm_gather"
    _check(name, Ad, Ac, Bd, Bc, pat_cols)
    if not _route(name, Ad):
        return masked_matmul_vals_plain(Ad, Ac, Bd, Bc, pat_cols)
    lib = load()
    fn = lib.masked_spgemm_gather_f32 if Ad.dtype == torch.float32 \
        else lib.masked_spgemm_gather_f64
    return _launch(name, fn, Ad, Ac, Bd, Bc, pat_cols)


def masked_spgemm_banded(Ad, Ac, Bd, Bc, pat_cols, offsets) -> torch.Tensor:
    """Values of ``(A @ B)`` at the pattern's slots for a banded A whose
    valid slots all lie on ``offsets`` (a tuple of at most 64 ints,
    ``col - row``).  A CUDA tensor goes through the banded kernel, a CPU
    tensor through :func:`masked_matmul_vals_plain`."""
    name = "masked_spgemm_banded"
    _check(name, Ad, Ac, Bd, Bc, pat_cols)
    if len(offsets) > MAX_OFFSETS:
        raise ValueError(f"{name} takes up to {MAX_OFFSETS} offsets, not "
                         f"{len(offsets)}")
    if not _route(name, Ad):
        return masked_matmul_vals_plain(Ad, Ac, Bd, Bc, pat_cols)
    lib = load()
    fn = lib.masked_spgemm_banded_f32 if Ad.dtype == torch.float32 \
        else lib.masked_spgemm_banded_f64
    offs = (ctypes.c_int32 * max(len(offsets), 1))(*offsets)
    return _launch(name, fn, Ad, Ac, Bd, Bc, pat_cols, offs, len(offsets))
