"""Native host kernels of the setup phase (ctypes-bound C++).

Port of the bindings of ``pyamg_tpu/amg_core/__init__.py`` that the ported
setup calls: the greedy aggregations, first-fit coloring, the Gauss-Seidel
sweeps (scalar and block), the Kaczmarz sweep, ``S = I - c D^-1 A`` and
the weak-axis filter of its ``jacobi_weak`` form, classical strength, the
CSR-to-DIA conversion, and the pattern-restricted products, constraint
projections and Gram matrices of the energy-minimization CG in scalar (CSR)
and block (BSR) form; for classical AMG the Ruge-Stuben splitting, direct
and standard interpolation, the evolution measure's steps and the batched
tridiagonal solves of the line smoothers.  The source is ``csrc/amg_core.cpp``; ``_build.build_host``
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
           "gauss_seidel_kaczmarz_native",
           "identity_minus_rowscaled_native", "weak_axis_filter_native",
           "classical_strength_native",
           "dia_offsets_native", "csr_to_dia_fill_native",
           "csr_to_dia_native", "bsr_gauss_seidel_native",
           "masked_spgemm_native", "constraint_project_native",
           "pattern_gram_native", "masked_spgemm_bsr_native",
           "constraint_project_bsr_native", "pattern_gram_bsr_native",
           "rs_cf_splitting", "identity_minus_scaled_native",
           "identity_minus_colscaled_native", "pattern_values_native",
           "evolution_nulldim1_native", "distance_filter_native",
           "evolution_epilogue_native", "direct_interpolation_native",
           "standard_interpolation_native", "thomas_lines_native"]

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
    lib.gauss_seidel_kaczmarz.argtypes = [_I, _i64p, _i64p, _f64p, _f64p,
                                          _f64p, _D]
    lib.gauss_seidel_kaczmarz_i32.argtypes = [_I, _i32p, _i32p, _f64p,
                                              _f64p, _f64p, _D]
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
    lib.weak_axis_filter.argtypes = [_I, _i64p, _i64p, _f64p, _I, _I,
                                     _i64p, _i64p, _i64p, _i64p, _f64p]
    lib.weak_axis_filter_i32.argtypes = [_I, _i32p, _i32p, _f64p, _I, _I,
                                         _i64p, _i64p, _i32p, _i32p, _f64p]
    lib.classical_strength.argtypes = [_I, _i64p, _i64p, _f64p, _D, _i64p,
                                       _i64p, _f64p]
    lib.classical_strength_i32.argtypes = [_I, _i32p, _i32p, _f64p, _D,
                                           _i32p, _i32p, _f64p]
    lib.bsr_gauss_seidel.argtypes = [_I, _I, _i64p, _i64p, _f64p, _f64p,
                                     _f64p, _f64p, _I, _I, _I]
    lib.masked_spgemm_rr.argtypes = [_I, _I, _i64p, _i64p, _f64p, _i64p,
                                     _i64p, _f64p, _i64p, _i64p, _f64p]
    lib.masked_spgemm_rr_i32.argtypes = [_I, _I, _i32p, _i32p, _f64p, _i32p,
                                         _i32p, _f64p, _i32p, _i32p, _f64p]
    vp = ctypes.c_void_p
    lib.constraint_project.argtypes = [_I, _I, _i64p, _i64p, _f64p, _f64p,
                                       vp, _f64p]
    lib.constraint_project_i32.argtypes = [_I, _I, _i32p, _i32p, _f64p,
                                           _f64p, vp, _f64p]
    lib.pattern_gram.argtypes = [_I, _I, _i64p, _i64p, _f64p, _f64p]
    lib.pattern_gram_i32.argtypes = [_I, _I, _i32p, _i32p, _f64p, _f64p]
    lib.masked_spgemm_bsr.argtypes = [_I, _I, _I, _I, _i64p, _i64p, _f64p,
                                      _i64p, _i64p, _f64p, _i64p, _i64p,
                                      _f64p]
    lib.masked_spgemm_bsr_i32.argtypes = [_I, _I, _I, _I, _i32p, _i32p,
                                          _f64p, _i32p, _i32p, _f64p, _i32p,
                                          _i32p, _f64p]
    lib.constraint_project_bsr.argtypes = [_I, _I, _I, _I, _i64p, _i64p,
                                           _f64p, _f64p, vp, _f64p]
    lib.constraint_project_bsr_i32.argtypes = [_I, _I, _I, _I, _i32p, _i32p,
                                               _f64p, _f64p, vp, _f64p]
    lib.pattern_gram_bsr.argtypes = [_I, _I, _I, _i64p, _i64p, _f64p, _f64p]
    lib.pattern_gram_bsr_i32.argtypes = [_I, _I, _I, _i32p, _i32p, _f64p,
                                         _f64p]
    for sfx, ix in (("", _i64p), ("_i32", _i32p)):
        getattr(lib, "rs_cf_splitting" + sfx).argtypes = [_I, ix, ix, ix,
                                                          ix, _i32p]
        getattr(lib, "identity_minus_scaled" + sfx).argtypes = [
            _I, ix, ix, _f64p, _D, _f64p]
        getattr(lib, "evolution_nulldim1" + sfx).argtypes = [
            _I, ix, ix, _f64p, _f64p, _D]
        getattr(lib, "identity_minus_colscaled" + sfx).argtypes = [
            _I, ix, ix, _f64p, _f64p, _D, _f64p]
        getattr(lib, "pattern_values" + sfx).argtypes = [_I, ix, ix, ix, ix,
                                                         _f64p, _f64p]
        getattr(lib, "distance_filter" + sfx).argtypes = [_I, ix, ix, _f64p,
                                                          _D]
        getattr(lib, "evolution_epilogue" + sfx).argtypes = [
            _I, ix, ix, _f64p, _D, _I, ix, ix, _f64p]
        getattr(lib, "direct_interpolation" + sfx).argtypes = [
            _I, ix, ix, _f64p, ix, ix, _i32p, ix, ix, ix, _f64p]
        getattr(lib, "standard_interpolation" + sfx).argtypes = [
            _I, ix, ix, _f64p, ix, ix, _f64p, _i32p, ix, ix, ix, _f64p]
        for name in ("identity_minus_scaled", "identity_minus_colscaled",
                     "pattern_values", "evolution_epilogue",
                     "direct_interpolation", "standard_interpolation"):
            getattr(lib, name + sfx).restype = _I
        for name in ("rs_cf_splitting", "evolution_nulldim1",
                     "distance_filter"):
            getattr(lib, name + sfx).restype = None
    lib.thomas_lines.argtypes = [_I, _I, _f64p, _f64p, _f64p, _f64p, _f64p]
    lib.thomas_lines.restype = None
    for name in ("dia_offsets", "dia_offsets_i32",
                 "identity_minus_rowscaled", "identity_minus_rowscaled_i32",
                 "weak_axis_filter", "weak_axis_filter_i32",
                 "classical_strength", "classical_strength_i32"):
        getattr(lib, name).restype = _I
    for name in ("standard_aggregation", "standard_aggregation_i32",
                 "naive_aggregation", "gauss_seidel_indexed",
                 "gauss_seidel_sweeps", "gauss_seidel_sweeps_i32",
                 "first_fit_coloring", "csr_to_dia_f64", "csr_to_dia_f32",
                 "csr_to_dia_f64_i32", "csr_to_dia_f32_i32",
                 "bsr_gauss_seidel", "masked_spgemm_rr",
                 "masked_spgemm_rr_i32", "constraint_project",
                 "constraint_project_i32", "pattern_gram", "pattern_gram_i32",
                 "masked_spgemm_bsr", "masked_spgemm_bsr_i32",
                 "constraint_project_bsr", "constraint_project_bsr_i32",
                 "pattern_gram_bsr", "pattern_gram_bsr_i32"):
        getattr(lib, name).restype = None


def _csr_arrays(A):
    return (np.ascontiguousarray(A.indptr, dtype=np.int64),
            np.ascontiguousarray(A.indices, dtype=np.int64))


def _ix_pair(*arrays):
    """``(arrays, suffix)``: scipy's native int32 index arrays pass to the
    ``*_i32`` entry points without a copy when all are int32; anything
    else widens to int64."""
    if all(a.dtype == np.int32 for a in arrays):
        return [np.ascontiguousarray(a) for a in arrays], "_i32"
    return [np.ascontiguousarray(a, dtype=np.int64) for a in arrays], ""


def _csr_ix(A):
    """``(indptr, indices, suffix)`` of a CSR matrix, as :func:`_ix_pair`
    gives them."""
    (p, j), sfx = _ix_pair(A.indptr, A.indices)
    return p, j, sfx


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


def gauss_seidel_kaczmarz_native(A, x, b, omega=1.0):
    """One forward Kaczmarz sweep (Gauss-Seidel on ``A A^H``), in place on
    ``x`` (real float64 only); False when it did not run."""
    lib = _load()
    if (not lib or A.dtype != np.float64 or x.dtype != np.float64
            or not x.flags.c_contiguous or not x.flags.writeable):
        return False
    Ap, Aj, sfx = _csr_ix(A)
    Ax = np.ascontiguousarray(A.data, dtype=np.float64)
    getattr(lib, "gauss_seidel_kaczmarz" + sfx)(
        A.shape[0], Ap, Aj, Ax, x,
        np.ascontiguousarray(b, dtype=np.float64), float(omega))
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


def weak_axis_filter_native(A, q, strides, block):
    """Compacted CSR of A without the couplings along the uncoarsened axes
    (``block[k] == 1``) of a grid of ``strides`` (natural axis order,
    ``q`` dofs per node), or None without the library or for data that is
    not real float64.  The same entries as
    ``aggregation.aggregation.weak_axis_filter``'s numpy form."""
    lib = _load()
    if not lib or not _real_f64(A) or np.iscomplexobj(A.data):
        return None
    import scipy.sparse as sp

    n = A.shape[0]
    order = np.argsort(strides)[::-1]
    strides_desc = np.ascontiguousarray(
        np.asarray(strides, dtype=np.int64)[order])
    coarsened_desc = np.ascontiguousarray(
        (np.asarray(block, dtype=np.int64)[order] != 1).astype(np.int64))
    Ax = np.ascontiguousarray(A.data, dtype=np.float64)
    Ap, Aj, sfx = _csr_ix(A)
    Bp = np.empty(n + 1, dtype=Ap.dtype)
    Bj = np.empty(A.nnz, dtype=Aj.dtype)
    Bx = np.empty(A.nnz, dtype=np.float64)
    out = getattr(lib, "weak_axis_filter" + sfx)(
        n, Ap, Aj, Ax, int(q), len(strides_desc), strides_desc,
        coarsened_desc, Bp, Bj, Bx)
    Aw = sp.csr_matrix((Bx[:out], Bj[:out], Bp), shape=A.shape)
    Aw.has_sorted_indices = A.has_sorted_indices
    return Aw


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


def bsr_gauss_seidel_native(indptr, indices, data, Dinv, x, b, bs,
                            start, stop, step):
    """One in-place block Gauss-Seidel pass over the block rows ``start``,
    ``start + step``, ... (not reaching ``stop``) of BSR arrays (real
    float64 only); False when it did not run."""
    lib = _load()
    if not lib or data.dtype != np.float64 or np.iscomplexobj(data):
        return False
    if x.dtype != np.float64 or not x.flags.c_contiguous:
        return False
    lib.bsr_gauss_seidel(
        indptr.shape[0] - 1, int(bs),
        np.ascontiguousarray(indptr, dtype=np.int64),
        np.ascontiguousarray(indices, dtype=np.int64),
        np.ascontiguousarray(data, dtype=np.float64),
        np.ascontiguousarray(Dinv, dtype=np.float64), x,
        np.ascontiguousarray(b, dtype=np.float64),
        int(start), int(stop), int(step))
    return True


def _csr_operand(M, need_sorted=False):
    """M as CSR without a copy when it is one; an unsorted one is copied
    before sorting, so that a caller's arrays never change."""
    import scipy.sparse as sp

    M = M if sp.issparse(M) and M.format == "csr" else sp.csr_matrix(M)
    if need_sorted and not M.has_sorted_indices:
        M = M.copy()
        M.sort_indices()
    return M


def masked_spgemm_native(A, B, pattern):
    """``(A @ B)`` on ``pattern``'s sparsity only (CSR in and out; only the
    structure of ``pattern`` is read); None without the library or for data
    that is not real float64."""
    lib = _load()
    if not lib:
        return None
    import scipy.sparse as sp

    A = _csr_operand(A, need_sorted=True)
    if not _real_f64(A):
        return None
    Br = _csr_operand(B)
    if not _real_f64(Br):
        return None
    P = _csr_operand(pattern, need_sorted=True)
    Cx = np.zeros(P.nnz, dtype=np.float64)
    a, sfx = _ix_pair(A.indptr, A.indices, Br.indptr, Br.indices, P.indptr,
                      P.indices)
    getattr(lib, "masked_spgemm_rr" + sfx)(
        A.shape[0], Br.shape[1], a[0], a[1],
        np.ascontiguousarray(A.data, dtype=np.float64), a[2], a[3],
        np.ascontiguousarray(Br.data, dtype=np.float64), a[4], a[5], Cx)
    # fresh index arrays: callers change the result in place
    return sp.csr_matrix((Cx, P.indices.copy(), P.indptr.copy()),
                         shape=P.shape)


def constraint_project_native(vals, indptr, indices, B, BtBinv, fmask=None):
    """Project the values ``vals`` of a CSR pattern in place so that
    ``(U @ B)[fmask] == 0`` (rows off ``fmask`` are zeroed); False when the
    library is missing or the data is not float64 with at most 16
    candidates."""
    lib = _load()
    if not lib:
        return False
    B = np.asarray(B)
    k = B.shape[1]
    if (k > 16 or vals.dtype != np.float64 or B.dtype != np.float64
            or np.asarray(BtBinv).dtype != np.float64):
        return False
    fm = None if fmask is None else np.ascontiguousarray(fmask,
                                                         dtype=np.uint8)
    (ip, ix), sfx = _ix_pair(indptr, indices)
    getattr(lib, "constraint_project" + sfx)(
        indptr.shape[0] - 1, k, ip, ix, np.ascontiguousarray(B),
        np.ascontiguousarray(BtBinv), None if fm is None else fm.ctypes.data,
        vals)
    return True


def pattern_gram_native(indptr, indices, B):
    """``(n, k, k)`` per-row Gram matrices of B over a CSR pattern, or None
    without the library or for B that is not float64 with at most 16
    columns."""
    lib = _load()
    if not lib:
        return None
    B = np.asarray(B)
    k = B.shape[1]
    if k > 16 or B.dtype != np.float64:
        return None
    n = indptr.shape[0] - 1
    out = np.empty((n, k, k), dtype=np.float64)
    (ip, ix), sfx = _ix_pair(indptr, indices)
    getattr(lib, "pattern_gram" + sfx)(n, k, ip, ix,
                                       np.ascontiguousarray(B), out)
    return out


def masked_spgemm_bsr_native(nbc, R, Cb, Ap, Aj, Ax, Bp, Bj, Bx, Cp, Cj):
    """Blocked masked product: ``(A @ B)`` on the block pattern
    ``(Cp, Cj)``, A of (R, R) blocks, B and C of (R, Cb) blocks; the
    ``(nnzb, R, Cb)`` values, or None without the library or for data that
    is not float64."""
    lib = _load()
    if not lib or Ax.dtype != np.float64 or Bx.dtype != np.float64:
        return None
    Cx = np.zeros((int(Cp[-1]), R, Cb), dtype=np.float64)
    a, sfx = _ix_pair(Ap, Aj, Bp, Bj, Cp, Cj)
    getattr(lib, "masked_spgemm_bsr" + sfx)(
        Ap.shape[0] - 1, int(nbc), int(R), int(Cb), a[0], a[1],
        np.ascontiguousarray(Ax), a[2], a[3], np.ascontiguousarray(Bx),
        a[4], a[5], Cx)
    return Cx


def constraint_project_bsr_native(vals, indptr, indices, R, Cb, B, Gblock,
                                  fmask=None):
    """The blocked projection in place: ``vals`` (nnzb, R, Cb) on the block
    pattern, B (scalar columns, k), ``Gblock`` (block rows, k, k) the Gram
    pseudo-inverse of each block row, ``fmask`` a keep mask per scalar row.
    False when the library is missing or the data is not float64 with at
    most 16 candidates."""
    lib = _load()
    if not lib:
        return False
    B = np.asarray(B)
    k = B.shape[1]
    if (k > 16 or vals.dtype != np.float64 or B.dtype != np.float64
            or np.asarray(Gblock).dtype != np.float64):
        return False
    fm = None if fmask is None else np.ascontiguousarray(fmask,
                                                         dtype=np.uint8)
    (ip, ix), sfx = _ix_pair(indptr, indices)
    getattr(lib, "constraint_project_bsr" + sfx)(
        indptr.shape[0] - 1, int(R), int(Cb), k, ip, ix,
        np.ascontiguousarray(B), np.ascontiguousarray(Gblock),
        None if fm is None else fm.ctypes.data, vals)
    return True


def pattern_gram_bsr_native(indptr, indices, Cb, B):
    """``(block rows, k, k)`` Gram matrices of B over a block pattern whose
    blocks span ``Cb`` scalar columns each, or None without the library or
    for B that is not float64 with at most 16 columns."""
    lib = _load()
    if not lib:
        return None
    B = np.asarray(B)
    k = B.shape[1]
    if k > 16 or B.dtype != np.float64:
        return None
    nbr = indptr.shape[0] - 1
    out = np.empty((nbr, k, k), dtype=np.float64)
    (ip, ix), sfx = _ix_pair(indptr, indices)
    getattr(lib, "pattern_gram_bsr" + sfx)(nbr, int(Cb), k, ip, ix,
                                           np.ascontiguousarray(B), out)
    return out


def rs_cf_splitting(S, T):
    """Ruge-Stuben splitting (int32, 1 = C) of the strength pattern S (no
    diagonal) and its transpose T, or None without the library."""
    lib = _load()
    if not lib:
        return None
    (Sp, Sj, Tp, Tj), sfx = _ix_pair(S.indptr, S.indices, T.indptr,
                                     T.indices)
    out = np.zeros(S.shape[0], dtype=np.int32)
    getattr(lib, "rs_cf_splitting" + sfx)(S.shape[0], Sp, Sj, Tp, Tj, out)
    return out


def _scaled_identity(name, M, c, *extra):
    lib = _load()
    if not lib or not _real_f64(M):
        return None
    n = M.shape[0]
    Sx = np.empty(M.nnz, dtype=np.float64)
    Mp, Mj, sfx = _csr_ix(M)
    got = getattr(lib, name + sfx)(
        n, Mp, Mj, np.ascontiguousarray(M.data, dtype=np.float64), *extra,
        float(c), Sx)
    return Sx if got == n else None


def identity_minus_scaled_native(M, c):
    """Data array of ``I - c M`` over M's own CSR pattern, or None without
    the library, for data that is not real float64, or when a row lacks a
    stored diagonal."""
    return _scaled_identity("identity_minus_scaled", M, c)


def identity_minus_colscaled_native(A, Dinv, c):
    """Data array of ``I - c A diag(Dinv)`` over A's own CSR pattern (for
    an exactly symmetric A, the transpose of ``I - c D^-1 A``), or None as
    :func:`identity_minus_scaled_native`."""
    return _scaled_identity("identity_minus_colscaled", A, c,
                            np.ascontiguousarray(Dinv, dtype=np.float64))


def pattern_values_native(C, A):
    """Data array of A's values on C's pattern (both sorted), or None
    without the library, for data that is not real float64, or when an
    entry of C is absent from A (scipy's ``multiply`` then keeps the exact
    intersection)."""
    lib = _load()
    if not lib or not _real_f64(A) or C.shape != A.shape:
        return None
    (Cp, Cj, Ap, Aj), sfx = _ix_pair(C.indptr, C.indices, A.indptr,
                                     A.indices)
    out = np.empty(C.nnz, dtype=np.float64)
    missing = getattr(lib, "pattern_values" + sfx)(
        A.shape[0], Cp, Cj, Ap, Aj,
        np.ascontiguousarray(A.data, dtype=np.float64), out)
    return out if missing == 0 else None


def evolution_nulldim1_native(Atilde, b1, tiny):
    """The evolution measure's one-candidate misfit, in place on the data
    of a CSR matrix (real float64 only); False when it did not run."""
    lib = _load()
    if not lib or not _real_f64(Atilde) or \
            not Atilde.data.flags.c_contiguous:
        return False
    Ap, Aj, sfx = _csr_ix(Atilde)
    getattr(lib, "evolution_nulldim1" + sfx)(
        Atilde.shape[0], Ap, Aj, Atilde.data,
        np.ascontiguousarray(b1, dtype=np.float64), float(tiny))
    return True


def distance_filter_native(C, epsilon):
    """The relative distance filter in place on the data of a CSR matrix
    (real float64 only; dropped entries zeroed, for the caller to
    compact); False when it did not run."""
    lib = _load()
    if not lib or not _real_f64(C) or not C.data.flags.c_contiguous:
        return False
    Cp, Cj, sfx = _csr_ix(C)
    getattr(lib, "distance_filter" + sfx)(C.shape[0], Cp, Cj, C.data,
                                          float(epsilon))
    return True


def evolution_epilogue_native(Atilde, epsilon, symmetrize):
    """The evolution measure's tail (distance filter, ``0.5 (S + S^T)``,
    unit diagonal, inversion, row scaling) in one call; the finished CSR
    strength matrix, or None without the library or for data that is not
    real float64.  Consumes ``Atilde.data``."""
    lib = _load()
    if not lib or not _real_f64(Atilde):
        return None
    import scipy.sparse as sp

    n = Atilde.shape[0]
    cap = 2 * Atilde.nnz + n
    Ap, Aj, sfx = _csr_ix(Atilde)
    idt = np.int32 if sfx else np.int64
    Op = np.empty(n + 1, dtype=idt)
    Oj = np.empty(cap, dtype=idt)
    Ox = np.empty(cap, dtype=np.float64)
    eps = np.inf if epsilon is None else float(epsilon)
    nnz = getattr(lib, "evolution_epilogue" + sfx)(
        n, Ap, Aj, np.ascontiguousarray(Atilde.data, dtype=np.float64), eps,
        int(bool(symmetrize)), Op, Oj, Ox)
    return sp.csr_matrix((Ox[:nnz], Oj[:nnz], Op), shape=Atilde.shape)


def _interpolation(name, A, S, with_values, splitting, cmap, nc, cap):
    import scipy.sparse as sp

    lib = _load()
    if not lib or not _real_f64(A) or (with_values and not _real_f64(S)):
        return None
    n = A.shape[0]
    (Ap, Aj, Sp, Sj), sfx = _ix_pair(A.indptr, A.indices, S.indptr,
                                     S.indices)
    idt = np.int32 if sfx else np.int64
    Pp = np.zeros(n + 1, dtype=idt)
    Pj = np.zeros(cap, dtype=idt)
    Px = np.zeros(cap, dtype=np.float64)
    vals = (np.ascontiguousarray(S.data, dtype=np.float64),) \
        if with_values else ()
    nnz = getattr(lib, name + sfx)(
        n, Ap, Aj, np.ascontiguousarray(A.data, dtype=np.float64), Sp, Sj,
        *vals, np.ascontiguousarray(splitting, dtype=np.int32),
        np.ascontiguousarray(cmap, dtype=idt), Pp, Pj, Px)
    return sp.csr_matrix((Px[:nnz].copy(), Pj[:nnz].copy(), Pp),
                         shape=(n, int(nc)))


def direct_interpolation_native(A, C, splitting, cmap, nc):
    """Direct interpolation P (CSR) from A and the strength pattern C (both
    sorted), or None without the library or for data that is not real
    float64."""
    return _interpolation("direct_interpolation", A, C, False, splitting,
                          cmap, nc, C.nnz + A.shape[0])


def standard_interpolation_native(A, S, splitting, cmap, nc):
    """Standard interpolation P (CSR) from A and S, A's values on the
    strength pattern (both sorted), or None without the library or for
    data that is not real float64."""
    return _interpolation("standard_interpolation", A, S, True, splitting,
                          cmap, nc, S.nnz + A.shape[0])


def thomas_lines_native(dl, dm, du, R):
    """Batched Thomas solve of independent tridiagonal lines, every array
    (nlines, L) float64 C-contiguous, in place on R; False when it did not
    run."""
    lib = _load()
    arrays = (dl, dm, du, R)
    if not lib or any(a.dtype != np.float64 for a in arrays) \
            or not R.flags.c_contiguous:
        return False
    nlines, L = R.shape
    lib.thomas_lines(nlines, L, *(np.ascontiguousarray(a)
                                  for a in (dl, dm, du)), R,
                     np.empty_like(R))
    return True
