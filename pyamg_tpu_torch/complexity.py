"""Work models of the setup and of one cycle, in units of the fine level's
nnz, read off a hierarchy's actual options.

Port of ``pyamg_tpu/complexity.py``: the prolongation smoother's kind and
iterations, the evolution measure's degree, the relaxation's sweeps,
iterations, degree and normal-equation doubling, and Schwarz subdomain
sizes; AMLI as the package's AMLI cycle (a W-shaped recursion and three
coarse matvecs a visit).  ``cycle_complexity`` reads each level's
``SmootherData``; the port's smoother kinds are the JAX package's (a
Chebyshev smoother is ``"polynomial"`` with its coefficients in both), so
the same hierarchy has the same work.

Examples
--------
>>> import pyamg_tpu_torch
>>> from pyamg_tpu_torch.gallery import poisson
>>> from pyamg_tpu_torch.complexity import cycle_complexity, setup_complexity
>>> A = poisson((16, 16), format='csr')
>>> ml = pyamg_tpu_torch.smoothed_aggregation_solver(A, max_coarse=10,
...                                                  device="cpu")
>>> bool(cycle_complexity(ml) > 1.0)         # work in fine-nnz units
True
>>> bool(setup_complexity(ml) > cycle_complexity(ml))
True
"""

from __future__ import annotations

import numpy as np

from .util.utils import unpack_arg

__all__ = ["setup_complexity", "cycle_complexity"]

# the JAX package's earlier keyword names, superseded by costs read off the
# hierarchy itself: accepted and ignored with a DeprecationWarning, as
# there, rather than refused
_LEGACY_COST_KWARGS = frozenset({
    "strength_cost", "aggregation_cost", "presmoother_cost",
    "postsmoother_cost", "smooth_cost", "improve_candidates_cost",
})


def _warn_legacy_cost_kwargs(fn_name, kwargs):
    if not kwargs:
        return
    unknown = set(kwargs) - _LEGACY_COST_KWARGS
    if unknown:
        raise TypeError(f"{fn_name}() got unexpected keyword arguments "
                        f"{sorted(unknown)}")
    import warnings

    warnings.warn(
        f"{fn_name}(): the {sorted(kwargs)} keyword(s) are deprecated and "
        "ignored — per-component costs are now read from the hierarchy's "
        "actual per-level options", DeprecationWarning, stacklevel=3)


def _nnz(lvl):
    return lvl.A_csr.nnz if hasattr(lvl, "A_csr") else lvl.A.nnz


def _p_nnz(lvl):
    if hasattr(lvl, "P_csr"):
        return lvl.P_csr.nnz, lvl.P_csr.shape[0]
    P = lvl.P
    return P.nnz, P.shape[0]


def _levelize(opt, nlevels):
    """Expand a single option (str/tuple/None) or a list to per-level
    length, repeating the final entry."""
    if isinstance(opt, (str, tuple)) or opt is None:
        opt = [opt]
    opt = list(opt)
    while len(opt) < nlevels:
        opt.append(opt[-1])
    return opt


def _spec_factor(spec):
    """Relaxation work multiplier of an option spec: normal-equation
    methods touch A twice, symmetric sweeps twice, times iterations and
    degree."""
    fn, kwargs = unpack_arg(spec)
    if fn is None:
        return 0.0
    factor = 1.0
    if str(fn).endswith(("nr", "ne")):
        factor *= 2
    if kwargs.get("sweep") == "symmetric":
        factor *= 2
    factor *= kwargs.get("iterations", 1)
    if fn == "chebyshev":
        factor *= kwargs.get("degree", 3)      # this package's default
    else:
        factor *= kwargs.get("degree", 1)
    return factor


def _data_factor(sm):
    """Relaxation work multiplier read off a level's ACTUAL precomputed
    smoother state (``relaxation.device.SmootherData``)."""
    if sm is None or getattr(sm, "kind", "none") == "none":
        return 0.0
    factor = float(getattr(sm, "iterations", 1) or 1)
    if getattr(sm, "sweep", "") == "symmetric":
        factor *= 2
    kind = getattr(sm, "kind", "")
    if kind.endswith(("_ne", "_nr")) or kind in ("jacobi_ne",
                                                 "gauss_seidel_ne",
                                                 "gauss_seidel_nr"):
        factor *= 2
    coeffs = getattr(sm, "coefficients", ()) or ()
    if kind in ("chebyshev", "polynomial") and len(coeffs):
        factor *= len(coeffs)
    return factor


def _schwarz_terms(lvl, sm, power):
    """(nnz multiplier, subdomain-solve work) of a Schwarz-smoothed level:
    subdomain sizes from the SmootherData's subdomain index table when it
    has one, else from A's row lengths (subdomains = overlapping rows of
    A)."""
    idx = getattr(sm, "subdomain_idx", None)
    if idx is not None:
        idx = np.asarray(idx.cpu())             # the table lives on the card
        sizes = (idx >= 0).sum(axis=1).astype(float)
    else:
        A = lvl.A_csr
        sizes = np.diff(A.indptr).astype(float)
    return float(sizes.mean()), float(np.sum(sizes ** power))


def setup_complexity(ml, strength="symmetric",
                     smooth=("jacobi", {"omega": 4.0 / 3.0}),
                     improve_candidates=None, aggregate="standard",
                     presmoother=("gauss_seidel", {"sweep": "symmetric"}),
                     postsmoother=("gauss_seidel", {"sweep": "symmetric"}),
                     keep=False, max_levels=10, max_coarse=500,
                     coarse_solver="pinv", symmetry="hermitian",
                     **legacy_kwargs):
    """Setup-phase work in units of fine-grid nnz, reading the actual
    options per level.

    Charges, per non-coarsest level: prolongation smoothing (6 matrix
    additions per energy-minimization iteration + the A·P product),
    the evolution strength-of-connection product chain, the Galerkin
    triple product, Schwarz subdomain factorizations, and candidate
    improvement relaxation on B.  The legacy cost keywords are accepted
    and ignored with a ``DeprecationWarning``; any other keyword raises.
    """
    _warn_legacy_cost_kwargs("setup_complexity", legacy_kwargs)
    nlevels = len(ml.levels)
    strength = _levelize(strength, nlevels)
    smooth = _levelize(smooth, nlevels)
    improve_candidates = _levelize(improve_candidates, nlevels)
    presmoother = _levelize(presmoother, nlevels)
    postsmoother = _levelize(postsmoother, nlevels)

    work = 0.0
    for i, lvl in enumerate(ml.levels[:-1]):
        a_nnz = _nnz(lvl)
        n = lvl.A_csr.shape[0] if hasattr(lvl, "A_csr") else lvl.A.shape[0]
        p_nnz, p_rows = _p_nnz(lvl) if (hasattr(lvl, "P_csr")
                                        or hasattr(lvl, "P")) else (a_nnz, n)

        # prolongation smoothing: energy minimization costs ~6 sparse
        # matrix additions per iteration on P's pattern, plus the A*P
        # product per iteration (jacobi/richardson: one product)
        s_fn, s_kw = unpack_arg(smooth[i])
        maxiter = 1
        if s_fn in ("energy", "cg", "cgnr", "gmres"):
            maxiter = int(s_kw.get("maxiter", 4))
            work += 6.0 * p_nnz * maxiter
        elif s_fn in ("jacobi", "richardson"):
            maxiter = int(s_kw.get("degree", 1))
        work += a_nnz * (p_nnz / float(max(p_rows, 1))) * maxiter

        # strength of connection: the evolution measure multiplies
        # (I - cD^{-1}A) up to degree k (masked onto A^(k/2)'s pattern)
        st_fn, st_kw = unpack_arg(strength[i])
        if st_fn in ("evolution", "ode"):
            k = int(st_kw.get("k", 2))
            Ah = lvl.A_csr if hasattr(lvl, "A_csr") else lvl.A
            Ak = Ah ** max(k // 2, 1)
            work += a_nnz * (Ak.nnz / float(max(n, 1)))

        # Galerkin triple product R*(A*P)
        work += a_nnz * (p_nnz / float(max(p_rows, 1))) * 2.0

        # Schwarz setup: one dense factorization per subdomain (size^3)
        pre_fn, _ = unpack_arg(presmoother[i])
        post_fn, _ = unpack_arg(postsmoother[i])
        if "schwarz" in str(pre_fn) or "schwarz" in str(post_fn):
            sm = getattr(lvl, "presmoother", None)
            _, cube = _schwarz_terms(lvl, sm, 3)
            work += cube

        # candidate improvement: relaxation applied to each column of B
        ic = improve_candidates[i]
        ic_fn, _ = unpack_arg(ic) if ic is not None else (None, {})
        if ic_fn is not None:
            nulldim = (lvl.B.shape[1] if getattr(lvl, "B", None) is not None
                       else 1)
            work += _spec_factor(ic) * a_nnz * nulldim

    return work / float(_nnz(ml.levels[0]))


def cycle_complexity(ml, cycle="V", presmoothing=None, postsmoothing=None,
                     **legacy_kwargs):
    """Work of one cycle in units of fine-grid nnz.

    ``presmoothing``/``postsmoothing`` may pass explicit option specs
    (str / tuple / per-level list); by default the
    multipliers are read off each level's ACTUAL precomputed smoother
    state, so iterations, symmetric sweeps, Chebyshev degree and
    normal-equation doubling are all reflected.  ``AMLI`` is modeled from
    this package's compiled cycle: a W-shaped recursion plus three extra
    coarse-operator matvecs per visit (the A-conjugate direction setup).
    The legacy cost keywords warn and are ignored, as in
    :func:`setup_complexity`.
    """
    _warn_legacy_cost_kwargs("cycle_complexity", legacy_kwargs)
    cycle = str(cycle).upper()
    nlevels = len(ml.levels)
    nnz = [float(_nnz(lvl)) for lvl in ml.levels]

    if presmoothing is not None or postsmoothing is not None:
        pres = _levelize(presmoothing, nlevels)
        posts = _levelize(postsmoothing, nlevels)
        cost = [_spec_factor(pres[i]) + _spec_factor(posts[i])
                for i in range(nlevels)]
        schwarz_lvls = [i for i in range(nlevels - 1)
                        if "schwarz" in str(unpack_arg(pres[i])[0])
                        or "schwarz" in str(unpack_arg(posts[i])[0])]
    else:
        cost = [_data_factor(getattr(lvl, "presmoother", None))
                + _data_factor(getattr(lvl, "postsmoother", None))
                for lvl in ml.levels]
        schwarz_lvls = [
            i for i, lvl in enumerate(ml.levels[:-1])
            if getattr(getattr(lvl, "presmoother", None), "kind", "")
            == "schwarz"
            or getattr(getattr(lvl, "postsmoother", None), "kind", "")
            == "schwarz"]

    # Schwarz: each row's residual is recomputed once per subdomain it
    # belongs to (mean row length multiplier on nnz) and each subdomain
    # solve costs size^2 with the prefactored inverse
    schwarz_work = np.zeros(nlevels)
    for i in schwarz_lvls:
        sm = getattr(ml.levels[i], "presmoother", None)
        mult, sq = _schwarz_terms(ml.levels[i], sm, 2)
        schwarz_work[i] = sq
        nnz[i] *= mult

    def V(level):
        if nlevels == 1:
            return nnz[0]
        if level == nlevels - 2:
            return cost[level] * nnz[level] + nnz[level + 1] \
                + schwarz_work[level]
        return cost[level] * nnz[level] + schwarz_work[level] + V(level + 1)

    def W(level):
        if nlevels == 1:
            return nnz[0]
        if level == nlevels - 2:
            return cost[level] * nnz[level] + nnz[level + 1] \
                + schwarz_work[level]
        return cost[level] * nnz[level] + schwarz_work[level] \
            + 2 * W(level + 1)

    def F(level):
        if nlevels == 1:
            return nnz[0]
        if level == nlevels - 2:
            return cost[level] * nnz[level] + nnz[level + 1] \
                + schwarz_work[level]
        return cost[level] * nnz[level] + schwarz_work[level] \
            + F(level + 1) + V(level + 1)

    def AMLI(level):
        if nlevels == 1:
            return nnz[0]
        if level == nlevels - 2:
            return cost[level] * nnz[level] + nnz[level + 1] \
                + schwarz_work[level]
        # two A-conjugate coarse directions: 2 recursive solves + 3
        # coarse matvecs (the AMLI branch of MultilevelSolver's cycle)
        return cost[level] * nnz[level] + schwarz_work[level] \
            + 2 * AMLI(level + 1) + 3 * nnz[level + 1]

    fns = {"V": V, "W": W, "F": F, "AMLI": AMLI}
    if cycle not in fns:
        raise ValueError(f"unrecognized cycle type {cycle!r}")
    return float(fns[cycle](0)) / float(_nnz(ml.levels[0]))
