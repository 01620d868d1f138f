"""Two more DIA SpMV kernels, in other layouts: their wrappers, their plain
PyTorch twins and launch counts.

Both compute ``dia_kernel``'s function on a square float32 operator,
``y[i] = sum_k diags[k, i] * x[i + offsets[k]]`` with zero wherever
``i + offsets[k]`` falls outside ``[0, n)``, with ``offsets`` a tuple of
ints (as the JAX kernels take them):

* :func:`dia_matvec_v2` launches ``csrc/dia_matvec_v2.cu``, the Hopper form
  of ``pyamg_tpu/sparse/pallas_kernels.py::dia_matvec_pallas_v2``: x viewed
  as ``(R, 128)``, each offset split as ``q * 128 + s`` and read from a
  halo'd window of x;
* :func:`dia_matvec_v1` launches ``csrc/dia_matvec_v1.cu``, the Hopper form
  of ``dia_matvec_pallas_v1``: 1-D tiles over a zero-padded copy of x,
  which the wrapper builds.

On a CUDA tensor each launches its kernel or raises; on a CPU tensor each
runs its twin, which follows the kernel's index decomposition
(:func:`dia_matvec_v2_plain`: the floor split, two lane rolls and a select
over the ``(R, 128)`` view; :func:`dia_matvec_v1_plain`: the padded copy).
``launches`` counts kernel launches by kernel name and nothing else.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

__all__ = ["dia_matvec_v2", "dia_matvec_v1", "dia_matvec_v2_plain",
           "dia_matvec_v1_plain", "plan_v2", "launches", "load",
           "LANES", "MAX_OFFSETS"]

LANES = 128                 # the width of x's (R, 128) view in dia_matvec_v2
MAX_OFFSETS = 128           # the kernels take the offsets as an argument
SMEM_BYTES = 232448         # shared memory a block may hold on Hopper
ROWS = 32                   # rows of y a dia_matvec_v2 block owns
HALO = 32                   # the TPU kernel's first halo, doubled to fit

launches = {"dia_matvec_v2": 0, "dia_matvec_v1": 0}

_libs = {}


def load(name: str) -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/<name>.cu``."""
    if name not in _libs:
        from .._build import load as build_and_load

        lib = build_and_load(name)
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        offs = ctypes.POINTER(ctypes.c_int32)
        if name == "dia_matvec_v2":
            fn, args = lib.dia_matvec_v2_f32, [p, offs, i, i64, p, p, i, i,
                                              p, i]
        else:
            fn, args = lib.dia_matvec_v1_f32, [p, offs, i, i64, p, i64, p,
                                              p, i]
        fn.argtypes = args
        fn.restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]


def plan_v2(offsets) -> tuple[int, int]:
    """``(halo, rows)`` of :func:`dia_matvec_v2`: halo rows of x on each
    side of a block's window, and rows of y a block owns.

    The halo follows the TPU kernel's plan (``_plan``: 32 rows, doubled
    until it exceeds every ``|q| + [s != 0]``, with ``q, s =
    divmod(offset, 128)``).  A block owns ``ROWS`` rows, so that a 2048^2
    grid's 32,768 rows make 1,024 blocks to fill the card's 132 SMs.  The
    window of ``rows + 2 * halo`` rows of 128 float32 must fit a block's
    shared memory (a halo of 128 rows, offsets up to about +-16,256):
    wider offsets raise ValueError."""
    reach = 0
    for off in offsets:
        q, s = divmod(int(off), LANES)
        reach = max(reach, abs(q) + (1 if s else 0))
    halo = HALO
    while reach >= halo:
        halo *= 2
    if (ROWS + 2 * halo) * LANES * 4 > SMEM_BYTES:
        raise ValueError(f"dia_matvec_v2: offsets up to {reach} rows of "
                         f"{LANES} away need a halo of {halo} rows, wider "
                         f"than a block's shared memory holds; dia_matvec "
                         f"and dia_matvec_v1 take such offsets")
    return halo, ROWS


def dia_matvec_v2_plain(diags: torch.Tensor, offsets,
                        x: torch.Tensor) -> torch.Tensor:
    """The twin of :func:`dia_matvec_v2`, in the TPU kernel's terms: the
    zero-filled ``(R + 2 * halo, 128)`` window of x; for each offset,
    ``q, s = divmod(offset, 128)``, rows ``halo + q`` on (and
    ``halo + q + 1`` where ``s != 0``), each rolled left by ``s`` lanes and
    stitched by a select on ``lane < 128 - s``.  Products accumulate in
    offset order."""
    n = x.shape[0]
    halo, _ = plan_v2(offsets)
    R = -(-n // LANES)
    npad = R * LANES
    win = F.pad(x, (halo * LANES, halo * LANES + npad - n)).view(
        R + 2 * halo, LANES)
    lane = torch.arange(LANES, device=x.device)
    d = F.pad(diags, (0, npad - n))
    y = torch.zeros(npad, dtype=x.dtype, device=x.device)
    for k, off in enumerate(offsets):
        q, s = divmod(int(off), LANES)
        a = win[halo + q:halo + q + R]
        if s == 0:
            shifted = a
        else:
            b = win[halo + q + 1:halo + q + 1 + R]
            shifted = torch.where(lane < LANES - s, a.roll(-s, 1),
                                  b.roll(-s, 1))
        y = y + d[k] * shifted.reshape(-1)
    return y[:n]


def _padded(x: torch.Tensor, offsets) -> tuple[torch.Tensor, int]:
    """``(xpad, halo)`` of :func:`dia_matvec_v1`: x with ``halo = max
    |offset|`` zeros on each side."""
    halo = max((abs(int(o)) for o in offsets), default=0)
    return F.pad(x, (halo, halo)), halo


def dia_matvec_v1_plain(diags: torch.Tensor, offsets,
                        x: torch.Tensor) -> torch.Tensor:
    """The twin of :func:`dia_matvec_v1`: the same padded copy of x, then
    ``y += diags[k] * xpad[halo + offset:][:n]`` in offset order."""
    n = x.shape[0]
    xpad, halo = _padded(x, offsets)
    y = torch.zeros(n, dtype=x.dtype, device=x.device)
    for k, off in enumerate(offsets):
        y = y + diags[k] * xpad[halo + off:halo + off + n]
    return y


def _check(name, diags, offsets, x):
    if diags.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 diags and x, not "
                        f"{diags.dtype} and {x.dtype}")
    if diags.device != x.device:
        raise ValueError(f"{name}: diags on {diags.device}, x on {x.device}")
    if diags.dim() != 2 or x.dim() != 1:
        raise ValueError(f"{name}: diags must be (k, n) and x 1-D")
    if len(offsets) != diags.shape[0] or not 0 < len(offsets) <= MAX_OFFSETS:
        raise ValueError(f"{name}: {len(offsets)} offsets for "
                         f"{diags.shape[0]} diagonals (1 to {MAX_OFFSETS})")
    if x.shape[0] != diags.shape[1]:
        raise ValueError(f"{name} takes a square operator: x has "
                         f"{x.shape[0]} entries, the diagonals "
                         f"{diags.shape[1]}")
    if not (diags.is_contiguous() and x.is_contiguous()):
        raise ValueError(f"{name}: diags and x must be contiguous")


def _route(name, x):
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return True


def _launch(name, fn, *args, device):
    err = fn(*args, torch.cuda.current_stream(device).cuda_stream,
             device.index)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1


def dia_matvec_v2(diags: torch.Tensor, offsets,
                  x: torch.Tensor) -> torch.Tensor:
    """Square float32 DIA SpMV over the ``(R, 128)`` view of x.  A CUDA
    tensor goes through ``csrc/dia_matvec_v2.cu``, a CPU tensor through
    :func:`dia_matvec_v2_plain`."""
    name = "dia_matvec_v2"
    offsets = tuple(int(o) for o in offsets)
    _check(name, diags, offsets, x)
    if not _route(name, x):
        return dia_matvec_v2_plain(diags, offsets, x)
    n = x.shape[0]
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    halo, rows = plan_v2(offsets)
    offs = (ctypes.c_int32 * len(offsets))(*offsets)
    _launch(name, load(name).dia_matvec_v2_f32, diags.data_ptr(), offs,
            len(offsets), n, x.data_ptr(), y.data_ptr(), rows, halo,
            device=x.device)
    return y


def dia_matvec_v1(diags: torch.Tensor, offsets,
                  x: torch.Tensor) -> torch.Tensor:
    """Square float32 DIA SpMV in 1-D tiles over a zero-padded copy of x,
    built here.  A CUDA tensor goes through ``csrc/dia_matvec_v1.cu``, a
    CPU tensor through :func:`dia_matvec_v1_plain`."""
    name = "dia_matvec_v1"
    offsets = tuple(int(o) for o in offsets)
    _check(name, diags, offsets, x)
    if not _route(name, x):
        return dia_matvec_v1_plain(diags, offsets, x)
    n = x.shape[0]
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    xpad, halo = _padded(x, offsets)
    offs = (ctypes.c_int32 * len(offsets))(*offsets)
    _launch(name, load(name).dia_matvec_v1_f32, diags.data_ptr(), offs,
            len(offsets), n, xpad.data_ptr(), halo, y.data_ptr(),
            device=x.device)
    return y
