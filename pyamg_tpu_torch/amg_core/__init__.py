"""Native host kernels of the setup phase (ctypes-bound C++).

Port of the bindings of ``pyamg_tpu/amg_core/__init__.py`` that the ported
setup calls: the greedy aggregations, first-fit coloring, the Gauss-Seidel
sweeps, ``S = I - c D^-1 A``, classical strength and the CSR-to-DIA
conversion.  The source is ``csrc/amg_core.cpp``; ``_build.build_host``
compiles it at first use into ``_build/`` (never beside the source).  Every
binding returns ``None`` (or ``False`` for the in-place sweeps) when the
library is unavailable or the input is not what it takes, and the caller
then runs its numpy/Python form: the package works without a toolchain.

``_lib`` holds the loaded library, ``None`` before the first use and
``False`` after a failed build; setting it to ``False`` forces the Python
forms (the tests do), setting it back to ``None`` loads again.
"""

from __future__ import annotations

import ctypes
import warnings

import numpy as np

__all__ = ["have_native", "standard_aggregation_native",
           "naive_aggregation_native", "first_fit_coloring_native",
           "gauss_seidel_sweeps_native", "gauss_seidel_indexed_native",
           "identity_minus_rowscaled_native", "classical_strength_native",
           "dia_offsets_native", "csr_to_dia_fill_native",
           "csr_to_dia_native"]

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    try:
        from .._build import build_host

        lib = ctypes.CDLL(str(build_host("amg_core")))
        _declare(lib)
        _lib = lib
    except Exception as e:      # no toolchain: the Python forms serve
        warnings.warn(f"amg_core native build unavailable ({e}); "
                      "using numpy fallbacks")
        _lib = False
    return _lib


def have_native() -> bool:
    """Whether the compiled library is loaded (building it if need be)."""
    return bool(_load())


_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_I = ctypes.c_int64
_D = ctypes.c_double


def _declare(lib):
    nrp = ctypes.POINTER(_I)
    lib.standard_aggregation.argtypes = [_I, _i64p, _i64p, _i64p, _i64p, nrp]
    lib.standard_aggregation_i32.argtypes = [_I, _i32p, _i32p, _i64p, _i64p,
                                             nrp]
    lib.naive_aggregation.argtypes = [_I, _i64p, _i64p, _i64p, _i64p, nrp]
    lib.gauss_seidel_indexed.argtypes = [_I, _i64p, _i64p, _i64p, _f64p,
                                         _f64p, _f64p]
    lib.gauss_seidel_sweeps.argtypes = [_I, _i64p, _i64p, _f64p, _f64p,
                                        _f64p, _I, _I]
    lib.gauss_seidel_sweeps_i32.argtypes = [_I, _i32p, _i32p, _f64p, _f64p,
                                            _f64p, _I, _I]
    lib.first_fit_coloring.argtypes = [_I, _i64p, _i64p, _i32p]
    lib.dia_offsets.argtypes = [_I, _I, _i64p, _i64p, _I, _i64p]
    lib.dia_offsets_i32.argtypes = [_I, _I, _i32p, _i32p, _I, _i64p]
    lib.csr_to_dia_f64.argtypes = [_I, _I, _i64p, _i64p, _f64p, _I, _i64p,
                                   _f64p]
    lib.csr_to_dia_f32.argtypes = [_I, _I, _i64p, _i64p, _f64p, _I, _i64p,
                                   _f32p]
    lib.csr_to_dia_f64_i32.argtypes = [_I, _I, _i32p, _i32p, _f64p, _I,
                                       _i64p, _f64p]
    lib.csr_to_dia_f32_i32.argtypes = [_I, _I, _i32p, _i32p, _f64p, _I,
                                       _i64p, _f32p]
    lib.identity_minus_rowscaled.argtypes = [_I, _i64p, _i64p, _f64p, _f64p,
                                             _D, _f64p]
    lib.identity_minus_rowscaled_i32.argtypes = [_I, _i32p, _i32p, _f64p,
                                                 _f64p, _D, _f64p]
    lib.classical_strength.argtypes = [_I, _i64p, _i64p, _f64p, _D, _i64p,
                                       _i64p, _f64p]
    lib.classical_strength_i32.argtypes = [_I, _i32p, _i32p, _f64p, _D,
                                           _i32p, _i32p, _f64p]
    for name in ("dia_offsets", "dia_offsets_i32",
                 "identity_minus_rowscaled", "identity_minus_rowscaled_i32",
                 "classical_strength", "classical_strength_i32"):
        getattr(lib, name).restype = _I
    for name in ("standard_aggregation", "standard_aggregation_i32",
                 "naive_aggregation", "gauss_seidel_indexed",
                 "gauss_seidel_sweeps", "gauss_seidel_sweeps_i32",
                 "first_fit_coloring", "csr_to_dia_f64", "csr_to_dia_f32",
                 "csr_to_dia_f64_i32", "csr_to_dia_f32_i32"):
        getattr(lib, name).restype = None


def _csr_arrays(A):
    return (np.ascontiguousarray(A.indptr, dtype=np.int64),
            np.ascontiguousarray(A.indices, dtype=np.int64))


def _csr_ix(A):
    """``(indptr, indices, suffix)``: scipy's native int32 index arrays pass
    to the ``*_i32`` entry points without a copy; anything else widens to
    int64."""
    p, j = A.indptr, A.indices
    if p.dtype == np.int32 and j.dtype == np.int32:
        return np.ascontiguousarray(p), np.ascontiguousarray(j), "_i32"
    return (*_csr_arrays(A), "")


def _real_f64(A):
    return A.dtype == np.float64


def _aggregation(fn, n, Cp, Cj):
    labels = np.zeros(n, dtype=np.int64)
    roots = np.zeros(n, dtype=np.int64)
    nr = _I(0)
    fn(n, Cp, Cj, labels, roots, ctypes.byref(nr))
    return labels, roots[:nr.value].copy()


def standard_aggregation_native(C):
    """``(labels, roots)`` of the three-pass greedy aggregation over the CSR
    graph C (-1 labels an isolated node), or None without the library."""
    lib = _load()
    if not lib:
        return None
    Cp, Cj, sfx = _csr_ix(C)
    return _aggregation(getattr(lib, "standard_aggregation" + sfx),
                        C.shape[0], Cp, Cj)


def naive_aggregation_native(C):
    """``(labels, roots)`` of the single-pass greedy aggregation, or None
    without the library."""
    lib = _load()
    if not lib:
        return None
    return _aggregation(lib.naive_aggregation, C.shape[0], *_csr_arrays(C))


def first_fit_coloring_native(G):
    """Greedy first-fit vertex coloring of the CSR graph G (the caller has
    removed the diagonal); int32 colors, or None without the library."""
    lib = _load()
    if not lib:
        return None
    Gp, Gj = _csr_arrays(G)
    colors = np.full(G.shape[0], -1, dtype=np.int32)
    lib.first_fit_coloring(G.shape[0], Gp, Gj, colors)
    return colors


def gauss_seidel_indexed_native(A, x, b, order):
    """One in-place Gauss-Seidel pass over the rows in ``order`` (real
    float64 only); False when it did not run."""
    lib = _load()
    if not lib or A.dtype != np.float64 or np.iscomplexobj(x):
        return False
    Ap, Aj = _csr_arrays(A)
    Ax = np.ascontiguousarray(A.data, dtype=np.float64)
    order = np.ascontiguousarray(order, dtype=np.int64)
    lib.gauss_seidel_indexed(order.size, order, Ap, Aj, Ax, x,
                             np.ascontiguousarray(b, dtype=np.float64))
    return True


def gauss_seidel_sweeps_native(A, x, b, iterations, sweep):
    """All iterations of natural-order Gauss-Seidel in one library call,
    in place on ``x`` (real float64 only); False when it did not run."""
    lib = _load()
    if (not lib or A.dtype != np.float64 or x.dtype != np.float64
            or not x.flags.c_contiguous or not x.flags.writeable):
        return False
    mode = {"forward": 0, "backward": 1, "symmetric": 2}.get(sweep)
    if mode is None:
        return False
    Ap, Aj, sfx = _csr_ix(A)
    Ax = np.ascontiguousarray(A.data, dtype=np.float64)
    getattr(lib, "gauss_seidel_sweeps" + sfx)(
        A.shape[0], Ap, Aj, Ax, x,
        np.ascontiguousarray(b, dtype=np.float64), int(iterations), mode)
    return True


def identity_minus_rowscaled_native(A, Dinv, c):
    """Data array of ``S = I - c diag(Dinv) A`` over A's own CSR pattern, or
    None when unavailable or when a row lacks a stored diagonal."""
    lib = _load()
    if not lib or not _real_f64(A):
        return None
    n = A.shape[0]
    Sx = np.empty(A.nnz, dtype=np.float64)
    Ax = np.ascontiguousarray(A.data, dtype=np.float64)
    Dc = np.ascontiguousarray(Dinv, dtype=np.float64)
    Ap, Aj, sfx = _csr_ix(A)
    got = getattr(lib, "identity_minus_rowscaled" + sfx)(
        n, Ap, Aj, Ax, Dc, float(c), Sx)
    return Sx if got == n else None


def classical_strength_native(A, theta):
    """Classical strength of connection of a sorted CSR matrix with the
    filter, the magnitudes and the row scaling in one pass; CSR S, or None
    without the library or for data that is not real float64."""
    lib = _load()
    if not lib or not _real_f64(A):
        return None
    import scipy.sparse as sp

    n = A.shape[0]
    Ap, Aj, sfx = _csr_ix(A)
    idt = np.int32 if sfx else np.int64
    Ax = np.ascontiguousarray(A.data, dtype=np.float64)
    Sp = np.zeros(n + 1, dtype=idt)
    Sj = np.zeros(A.nnz, dtype=idt)
    Sx = np.zeros(A.nnz, dtype=np.float64)
    nnz = getattr(lib, "classical_strength" + sfx)(n, Ap, Aj, Ax,
                                                   float(theta), Sp, Sj, Sx)
    return sp.csr_matrix((Sx[:nnz].copy(), Sj[:nnz].copy(), Sp),
                         shape=A.shape)


def dia_offsets_native(A_csr, max_offsets=128):
    """Distinct diagonal offsets of a CSR matrix (sorted int64 array) in one
    pass; None without the library or above ``max_offsets`` diagonals."""
    lib = _load()
    if not lib:
        return None
    n, m = A_csr.shape
    offsets = np.zeros(max_offsets, dtype=np.int64)
    Ap, Aj, sfx = _csr_ix(A_csr)
    k = getattr(lib, "dia_offsets" + sfx)(n, m, Ap, Aj, max_offsets, offsets)
    if k < 0:
        return None
    return offsets[:k].copy()


def csr_to_dia_fill_native(A_csr, offsets, dtype=None):
    """Scatter a real float64 CSR matrix into zeroed ``(k, n)`` diagonal
    arrays of float64 or float32 in one pass; None for other dtypes."""
    lib = _load()
    if not lib or not _real_f64(A_csr):
        return None
    dt = np.dtype(dtype) if dtype is not None else A_csr.dtype
    if dt not in (np.dtype(np.float64), np.dtype(np.float32)):
        return None
    n, m = A_csr.shape
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    Ax = np.ascontiguousarray(A_csr.data, dtype=np.float64)
    diags = np.zeros((offsets.size, n), dtype=dt)
    Ap, Aj, sfx = _csr_ix(A_csr)
    width = "f32" if dt == np.float32 else "f64"
    getattr(lib, f"csr_to_dia_{width}{sfx}")(n, m, Ap, Aj, Ax, offsets.size,
                                             offsets, diags)
    return diags


def csr_to_dia_native(A_csr, dtype=None, max_offsets=128):
    """``(diags, offsets)`` host DIA arrays of a real float64 CSR matrix in
    two passes; None without the library, for other dtypes, or above
    ``max_offsets`` diagonals."""
    offs = dia_offsets_native(A_csr, max_offsets=max_offsets)
    if offs is None:
        return None
    diags = csr_to_dia_fill_native(A_csr, offs, dtype=dtype)
    if diags is None:
        return None
    return diags, tuple(int(o) for o in offs)
