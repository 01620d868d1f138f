"""The masked-SpGEMM kernels: their wrappers, launch geometry, plain
PyTorch twin and launch counts.

``out[i, o] = sum_a sum_b Ad[i, a] * Bd[Ac[i, a], b]
                          * [Bc[Ac[i, a], b] == pat[i, o]]``

on padded-ELL slabs; ``pat`` holds -1 at the output's padding slots, after
its valid columns in ascending order.

* :func:`masked_spgemm_gather` launches ``masked_spgemm_gather`` of
  ``csrc/masked_spgemm.cu`` (any A);
* :func:`masked_spgemm_banded` launches ``masked_spgemm_banded`` (A with
  at most 64 distinct ``col - row`` offsets, passed as ``offsets`` in
  ascending order).

Both kernels give each block a tile of consecutive output rows, staged in
shared memory; :func:`tile_geometry` chooses the tile and the grid and
raises ``ValueError`` on a geometry that would not fit a block's shared
memory, on every device, so a CUDA tensor never reaches the twin.  That
is the only limit on the slabs' widths: A and the pattern are staged, so
their widths bound the tile (a tile of one row takes A and a pattern up
to 8,296 float32 or 5,808 float64 slots wide each), and B is read from
global memory at any width.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor each runs :func:`masked_matmul_vals_plain`, the JAX package's XLA
gather formulation (``pyamg_tpu/sparse/spgemm_device.py::
_masked_matmul_vals``).  ``launches`` counts kernel launches by kernel name
and nothing else; ``plain_cuda_calls`` counts calls of the plain twin on
CUDA tensors, which only comparisons make.  The private
``_masked_spgemm_*_slotwise`` functions launch the kernels' first bodies
(one thread per output slot) for ``chip_smoke.py`` to compare and time;
no path calls them and ``launches`` does not count them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..util import profiling

__all__ = ["masked_spgemm_gather", "masked_spgemm_banded",
           "masked_matmul_vals_plain", "launches", "plain_cuda_calls",
           "MAX_OFFSETS", "TileGeometry", "tile_geometry",
           "shared_bytes", "load"]

MAX_OFFSETS = 64        # most diagonals of a banded A
TILE_THREADS = 256      # threads of a block (kTileThreads)
TILE_ROWS = (256, 128, 64, 32, 16)     # tile heights, tallest first
MAX_SHARED_BYTES = 232_448             # dynamic shared memory of a block
SM_SHARED_BYTES = 233_472              # of an SM (1 KiB a block reserved)
SHARED_TARGET = 57_344  # tallest tile within this: 4 blocks an SM
ROW_THREADS = 1 << 17   # fewer rows than this take more lanes a row
H100_SMS = 132

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
        offs = ctypes.POINTER(ctypes.c_int32)
        slabs = [p, p, i, i64, p, p, i, i64, p, i, p]
        # the tiled entries end in two CUDA events (or null) recorded
        # around the kernel alone
        signatures = {
            "masked_spgemm_gather": slabs + [i, i, i, i, p, i, p, p],
            "masked_spgemm_banded": slabs + [offs, i, i, i, i, i, p, i, p, p],
            "masked_spgemm_gather_slotwise": slabs + [p, i],
            "masked_spgemm_banded_slotwise": slabs + [offs, i, p, i],
        }
        for name, argtypes in signatures.items():
            for dt in ("f32", "f64"):
                fn = getattr(lib, f"{name}_{dt}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        lib.masked_spgemm_shared_bytes.argtypes = [i, i, i, i, i]
        lib.masked_spgemm_shared_bytes.restype = ctypes.c_int64
        _lib = lib
    return _lib


def shared_bytes(rows, w_a, w_out, itemsize, k=0) -> int:
    """Dynamic shared memory of one block of the tiled kernels
    (``tile_layout`` in ``csrc/masked_spgemm.cu``): two stages of A's value
    and column slabs and the pattern slab, each with 16 bytes of slack for
    its alignment shift, then the accumulator and, for the banded kernel
    (``k`` offsets), A by diagonal and the offsets.  B is not staged."""
    def r16(b):
        return -(-b // 16) * 16

    stage = (r16(rows * w_a * itemsize) + r16(rows * w_a * 4)
             + r16(rows * w_out * 4) + 48)
    return (2 * stage + r16(rows * w_out * itemsize)
            + r16(k * rows * itemsize) + r16(4 * k))


class TileGeometry(NamedTuple):
    """A tiled launch: ``rows`` output rows a tile, ``lanes`` lanes a row,
    ``threads`` a block, and ``blocks`` blocks that each walk tiles
    ``block, block + blocks, ...`` of the ``tiles``."""
    n: int
    rows: int
    lanes: int
    threads: int
    tiles: int
    blocks: int
    shared_bytes: int

    def block_rows(self, block):
        """The row ranges block ``block`` computes, in the order of the
        kernel's persistent loop."""
        return [range(t * self.rows, min(self.n, (t + 1) * self.rows))
                for t in range(block, self.tiles, self.blocks)]


def tile_geometry(n, w_a, w_b, w_out, itemsize, k=0,
                  sms=H100_SMS) -> TileGeometry:
    """The launch of a tiled kernel over ``n`` output rows.

    ``lanes`` (a power of two): 1, so a thread walks its row alone, unless
    the rows are too few to fill the card (``n * lanes`` below
    :data:`ROW_THREADS`); then more, up to ``w_b`` rounded up.  ``rows``:
    the tallest tile of :data:`TILE_ROWS` that ``TILE_THREADS`` threads
    cover in one pass and whose shared memory stays within
    :data:`SHARED_TARGET`, else the shortest of them; where even that
    overflows a block's shared memory (A or the pattern some hundreds of
    slots wide), half as many rows, down to one.  Blocks: as many as
    ``sms`` SMs hold at once, at most one a tile.  Raises ValueError when
    a tile of one row does not fit a block's shared memory."""
    lanes = 1
    while lanes < min(32, w_b) and n * lanes < ROW_THREADS:
        lanes *= 2
    one_pass = [r for r in TILE_ROWS if r * lanes <= TILE_THREADS] \
        or [TILE_ROWS[-1]]
    fits = [r for r in one_pass
            if shared_bytes(r, w_a, w_out, itemsize, k) <= SHARED_TARGET]
    rows = fits[0] if fits else one_pass[-1]
    smem = shared_bytes(rows, w_a, w_out, itemsize, k)
    while smem > MAX_SHARED_BYTES and rows > 1:
        rows //= 2
        smem = shared_bytes(rows, w_a, w_out, itemsize, k)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"masked SpGEMM tile of {rows} rows (A {w_a} wide, pattern "
            f"{w_out} wide, {itemsize}-byte values, {k} offsets) needs "
            f"{smem} bytes of shared memory; a block has {MAX_SHARED_BYTES}")
    threads = min(TILE_THREADS, max(32, -(-rows * lanes // 32) * 32))
    per_sm = max(1, min(2048 // threads, 32,
                        SM_SHARED_BYTES // (smem + 1024)))
    tiles = -(-n // rows)
    return TileGeometry(n, rows, lanes, threads, tiles,
                        max(1, min(tiles, sms * per_sm)), smem)


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
    if not all(t.is_contiguous() for t in (Ad, Ac, Bd, Bc, pat_cols)):
        raise ValueError(f"{name}: every slab must be contiguous")


def _check_offsets(name, offsets):
    if len(offsets) > MAX_OFFSETS:
        raise ValueError(f"{name} takes up to {MAX_OFFSETS} offsets, not "
                         f"{len(offsets)}")
    if any(a >= b for a, b in zip(offsets, offsets[1:])):
        raise ValueError(f"{name}: offsets must be strictly ascending")


def _launch(name, fn, Ad, Ac, Bd, Bc, pat_cols, *extra, count=True,
            timed=False):
    """Launch ``fn`` on the slabs; ``timed``: a tiled entry, which takes
    the CUDA events of a recorded span open around it (the set-up's
    ``spgemm``, ``profiling.device_events``) and records them around its
    kernel."""
    n, w_out = pat_cols.shape
    out = torch.empty((n, w_out), dtype=Ad.dtype, device=Ad.device)
    if n == 0 or w_out == 0:
        return out
    stream = torch.cuda.current_stream(Ad.device).cuda_stream
    args = (Ad.data_ptr(), Ac.data_ptr(), Ad.shape[1], n, Bd.data_ptr(),
            Bc.data_ptr(), Bd.shape[1], Bd.shape[0], pat_cols.data_ptr(),
            w_out, out.data_ptr(), *extra, stream, Ad.device.index)
    if timed:
        with profiling.device_events(Ad.device) as events:
            err = fn(*args, *(events or (None, None)))
    else:
        err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    if count:
        launches[name] += 1
    return out


def _route(name, Ad):
    if Ad.device.type == "cpu":
        return False
    if Ad.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {Ad.device}")
    return True


def _geometry(Ad, Bd, pat_cols, k=0) -> TileGeometry:
    sms = (torch.cuda.get_device_properties(Ad.device).multi_processor_count
           if Ad.device.type == "cuda" else H100_SMS)
    return tile_geometry(Ad.shape[0], Ad.shape[1], Bd.shape[1],
                         pat_cols.shape[1], Ad.element_size(), k, sms)


def _tiled(geom: TileGeometry):
    """The launch arguments of a tiled kernel after its slabs."""
    return (geom.rows, geom.lanes.bit_length() - 1, geom.threads,
            geom.blocks)


def _entry(name, Ad):
    return getattr(load(), name + ("_f32" if Ad.dtype == torch.float32
                                   else "_f64"))


def masked_spgemm_gather(Ad, Ac, Bd, Bc, pat_cols) -> torch.Tensor:
    """Values of ``(A @ B)`` at the pattern's slots, for any A.  A CUDA
    tensor goes through the gather kernel, a CPU tensor through
    :func:`masked_matmul_vals_plain`."""
    name = "masked_spgemm_gather"
    _check(name, Ad, Ac, Bd, Bc, pat_cols)
    geom = _geometry(Ad, Bd, pat_cols)
    if not _route(name, Ad):
        return masked_matmul_vals_plain(Ad, Ac, Bd, Bc, pat_cols)
    return _launch(name, _entry(name, Ad), Ad, Ac, Bd, Bc, pat_cols,
                   *_tiled(geom), timed=True)


def masked_spgemm_banded(Ad, Ac, Bd, Bc, pat_cols, offsets) -> torch.Tensor:
    """Values of ``(A @ B)`` at the pattern's slots for a banded A whose
    valid slots all lie on ``offsets`` (a tuple of at most 64 ints,
    ``col - row``, ascending).  A CUDA tensor goes through the banded
    kernel, a CPU tensor through :func:`masked_matmul_vals_plain`."""
    name = "masked_spgemm_banded"
    _check(name, Ad, Ac, Bd, Bc, pat_cols)
    _check_offsets(name, offsets)
    geom = _geometry(Ad, Bd, pat_cols, len(offsets))
    if not _route(name, Ad):
        return masked_matmul_vals_plain(Ad, Ac, Bd, Bc, pat_cols)
    offs = (ctypes.c_int32 * max(len(offsets), 1))(*offsets)
    return _launch(name, _entry(name, Ad), Ad, Ac, Bd, Bc, pat_cols, offs,
                   len(offsets), *_tiled(geom), timed=True)


def _masked_spgemm_gather_slotwise(Ad, Ac, Bd, Bc, pat_cols):
    """:func:`masked_spgemm_gather` on the kernel's first body, one thread
    per output slot; a comparator for ``chip_smoke.py``."""
    name = "masked_spgemm_gather_slotwise"
    _check(name, Ad, Ac, Bd, Bc, pat_cols)
    if not _route(name, Ad):
        return masked_matmul_vals_plain(Ad, Ac, Bd, Bc, pat_cols)
    return _launch(name, _entry(name, Ad), Ad, Ac, Bd, Bc, pat_cols,
                   count=False)


def _masked_spgemm_banded_slotwise(Ad, Ac, Bd, Bc, pat_cols, offsets):
    """:func:`masked_spgemm_banded` on the kernel's first body, one thread
    per output slot; a comparator for ``chip_smoke.py``."""
    name = "masked_spgemm_banded_slotwise"
    _check(name, Ad, Ac, Bd, Bc, pat_cols)
    _check_offsets(name, offsets)
    if not _route(name, Ad):
        return masked_matmul_vals_plain(Ad, Ac, Bd, Bc, pat_cols)
    offs = (ctypes.c_int32 * max(len(offsets), 1))(*offsets)
    return _launch(name, _entry(name, Ad), Ad, Ac, Bd, Bc, pat_cols, offs,
                   len(offsets), count=False)
