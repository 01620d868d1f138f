"""Classical (Ruge-Stuben) AMG solver constructor.

Port of ``pyamg_tpu/classical/classical.py``.  The setup runs on the host
in numpy/scipy, level by level: strength of connection, C/F splitting,
direct or standard interpolation, ``R = P^T`` and the Galerkin product
``R A P`` (optionally filtered).  Then every level becomes device
operators: A as ``device_operator`` chooses (DIA on the hand-written
kernel, dense, or padded ELL), P and R as the C-point embedding of the
transfers (one DIA matvec and a gather or scatter of the coarse values)
where it is banded, else as ``device_operator`` chooses.
"""

from __future__ import annotations

import numpy as np

from ..multilevel import Level, MultilevelSolver
from ..relaxation.smoothing import change_smoothers
from ..sparse import device_operator, embedded_dia_transfers
from ..strength import (affinity_distance, algebraic_distance,
                        classical_strength_of_connection,
                        distance_strength_of_connection,
                        energy_based_strength_of_connection,
                        evolution_strength_of_connection,
                        symmetric_strength_of_connection)
from ..util.utils import (filter_matrix_rows, numpy_dtype, to_csr,
                          torch_dtype, unpack_arg)
from . import split
from .cr import CR
from .interpolate import direct_interpolation, standard_interpolation

__all__ = ["ruge_stuben_solver"]

_STRENGTH = {"classical": classical_strength_of_connection,
             "symmetric": symmetric_strength_of_connection,
             "evolution": evolution_strength_of_connection,
             "ode": evolution_strength_of_connection,
             "distance": distance_strength_of_connection,
             "energy_based": energy_based_strength_of_connection,
             "algebraic_distance": algebraic_distance,
             "affinity": affinity_distance}
_SPLITTINGS = {"RS": split.RS, "PMIS": split.PMIS, "PMISc": split.PMISc,
               "CLJP": split.CLJP, "CLJPc": split.CLJPc, "MIS": split.MIS}


def _strength_matrix(A, flag):
    fn, kwargs = unpack_arg(flag)
    if fn is None:
        return A.copy()
    if fn not in _STRENGTH:
        raise ValueError(f"unrecognized strength of connection method "
                         f"{fn!r}")
    return _STRENGTH[fn](A, **kwargs)


def ruge_stuben_solver(A, strength=("classical", {"theta": 0.25}),
                       CF="RS", interpolation="direct",
                       presmoother=("gauss_seidel", {"sweep": "symmetric"}),
                       postsmoother=("gauss_seidel", {"sweep": "symmetric"}),
                       max_levels=10, max_coarse=500, keep=False,
                       coarse_solver="pinv", coarse_filter=None,
                       op_dtype=None, device="cuda"):
    """Create a classical AMG solver on ``device``.

    The signature and defaults are the JAX package's.  ``strength``: any
    measure of :mod:`pyamg_tpu_torch.strength` by name ("classical",
    "symmetric", "evolution"/"ode", "distance", "energy_based",
    "algebraic_distance", "affinity") or None.  ``CF``: "RS", "PMIS",
    "PMISc", "CLJP", "CLJPc", "MIS", "CR" (compatible relaxation on A) or
    "grid" (red-black on level 0 of a matrix carrying ``A.grid``, PMIS
    below).  ``interpolation``: "direct" or "standard".  ``coarse_filter``
    drops Galerkin fill-in below that fraction of each row's largest
    off-diagonal entry (True: 0.01), lumped onto the diagonal.
    ``op_dtype`` builds every device operator and smoother in that dtype.
    A level whose strength graph gives a splitting of all C or all F ends
    the coarsening.

    Examples
    --------
    >>> import numpy as np
    >>> from pyamg_tpu_torch.gallery import poisson
    >>> A = poisson((32, 32), format='csr')
    >>> ml = ruge_stuben_solver(A, max_coarse=50, device="cpu")
    >>> res = []
    >>> x = ml.solve(np.ones(A.shape[0]), tol=1e-8, residuals=res)
    >>> res[-1] < 1e-8 * res[0]
    True
    """
    grid_meta = getattr(A, "grid", None)
    A = to_csr(A).astype(A.dtype)
    if A.shape[0] != A.shape[1]:
        raise ValueError("expected square matrix")

    levels = [Level()]
    levels[0].A_csr = A
    if grid_meta is None and isinstance(CF, tuple):
        grid_meta = unpack_arg(CF)[1].get("grid")
    levels[0].grid = tuple(grid_meta) if grid_meta is not None else None

    while (len(levels) < max_levels
           and levels[-1].A_csr.shape[0] > max_coarse):
        n_prev = levels[-1].A_csr.shape[0]
        _extend_hierarchy(levels, strength, CF, interpolation, keep,
                          coarse_filter)
        if levels[-1].A_csr.shape[0] == n_prev:
            break               # coarsening stalled

    for lvl in levels:
        lvl.A = device_operator(lvl.A_csr, dtype=numpy_dtype(op_dtype),
                                device=device)
        if hasattr(lvl, "P_csr"):
            lvl.P, lvl.R = _device_transfers(lvl.P_csr, lvl.R_csr,
                                             lvl.splitting, op_dtype, device)

    ml = MultilevelSolver(levels, coarse_solver=coarse_solver, device=device)
    if op_dtype is not None:
        ml._op_dtype = torch_dtype(op_dtype)
    change_smoothers(ml, presmoother, postsmoother)
    return ml


def _splitting(levels, A, C, CF):
    """The C/F splitting of the newest level and, for the grid splitting
    of level 0, the coarse grid (None)."""
    fn, kwargs = unpack_arg(CF)
    if fn == "grid":
        grid = getattr(levels[-1], "grid", None) or kwargs.get("grid")
        if grid is not None and int(np.prod(grid)) == A.shape[0] \
                and len(levels) == 1:
            return split.grid_splitting(grid)
        return split.PMIS(C), None      # coarse levels: no geometry left
    if fn == "CR":
        return CR(A, **kwargs), None    # relaxation on A, not on C
    if fn not in _SPLITTINGS:
        raise ValueError(f"unknown C/F splitting method {CF!r}")
    return _SPLITTINGS[fn](C, **kwargs), None


def _extend_hierarchy(levels, strength, CF, interpolation, keep,
                      coarse_filter=None):
    """One coarsening step."""
    A = levels[-1].A_csr
    C = _strength_matrix(A, strength)
    splitting, cgrid = _splitting(levels, A, C, CF)
    if splitting.sum() == 0 or splitting.sum() == len(splitting):
        return                  # a degenerate split ends the coarsening

    ifn, ikwargs = unpack_arg(interpolation)
    if ifn == "direct":
        P = direct_interpolation(A, C, splitting, **ikwargs)
    elif ifn == "standard":
        P = standard_interpolation(A, C, splitting, **ikwargs)
    else:
        raise ValueError(f"unknown interpolation method {interpolation!r}")
    R = P.T.tocsr()

    lvl = levels[-1]
    lvl.P_csr = P
    lvl.R_csr = R
    lvl.splitting = np.asarray(splitting)
    if keep:
        lvl.C = C

    levels.append(Level())
    levels[-1].A_csr = _galerkin(R, A, P, coarse_filter)
    levels[-1].grid = cgrid


def _galerkin(R, A, P, coarse_filter=None):
    """The coarse operator ``R A P`` without stored zeros; with
    ``coarse_filter``, weak fill-in lumped onto the diagonal (row sums
    kept), which holds back the densification of coarse operators under
    rotated anisotropy."""
    A_coarse = (R @ A @ P).tocsr()
    A_coarse.eliminate_zeros()
    if coarse_filter:
        theta = coarse_filter if isinstance(coarse_filter, float) else 1e-2
        A_coarse = filter_matrix_rows(A_coarse, theta, lump=True)
    return A_coarse


def _device_transfers(P_csr, R_csr, splitting, dtype=None, device="cuda",
                      max_offsets=96):
    """``(P, R)`` of a level on ``device`` in ``dtype``: the C-point
    embedding where it is banded -- P's coarse columns moved to the C
    points' fine positions make it an (n x n) operator, banded where the
    level is, so P and R cost one DIA matvec and a scatter or gather of
    the coarse values (R the plain transpose, as ``R_csr`` is) -- else
    ``device_operator``'s forms of ``P_csr`` and ``R_csr``."""
    npdt = numpy_dtype(dtype)
    pr = embedded_dia_transfers(P_csr, np.flatnonzero(splitting),
                                dtype=npdt, max_offsets=max_offsets,
                                restrict="transpose", device=device)
    if pr is not None:
        return pr
    return (device_operator(P_csr, dtype=npdt, device=device),
            device_operator(R_csr, dtype=npdt, device=device))
