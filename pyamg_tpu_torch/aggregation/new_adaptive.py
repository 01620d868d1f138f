"""Recursive adaptive smoothed aggregation with Ritz-filtered targets.

Port of ``pyamg_tpu/aggregation/new_adaptive.py``, on the host in
numpy/scipy; only the accepted hierarchy is moved to the device.

The hierarchy is built depth first.  Each level starts from targets found
by relaxation on ``A x = 0``, filters them globally (a Ritz decomposition
of A^2 on their span, keeping the targets the weak approximation property
does not already cover) and locally (a minimal basis on each aggregate:
the tentative prolongator), smooths P, forms the coarse operator and
recurses.  Then host V-cycles on the homogeneous system measure the
sub-hierarchy's convergence factor; while it is above ``conv_tol`` the
slowest error joins the targets and the level is rebuilt, up to the
iteration and target caps.  The per-aggregate decompositions are one
batched ``eigh`` over zero-padded aggregate blocks.

Examples
--------
>>> import numpy as np
>>> float(A_norm(np.ones(4), np.eye(4)))
2.0
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp

from ..multilevel import Level, MultilevelSolver
from ..relaxation.smoothing import change_smoothers
from ..util.linalg import approximate_spectral_radius
from ..util.utils import to_csr
from .adaptive import _host_vcycle, _relax_zero
from .aggregation import (_aggregate, _finalize_device_operators, _smooth_P,
                          _strength)

__all__ = ["asa_solver", "tl_sa_solver", "global_ritz_process",
           "local_ritz_process", "A_norm", "my_rand"]


def A_norm(x, A):
    """The energy norm ``sqrt(Re(x^H A x))``."""
    x = np.ravel(np.asarray(x))
    return np.sqrt(np.real(np.vdot(x, A @ x)))


def my_rand(d1, d2, zero_crossings=True):
    """A ``(d1, d2)`` array uniform in [-1, 1) (in [0, 1) when
    ``zero_crossings`` is False), from an unseeded generator."""
    x = np.random.default_rng().random((d1, d2))
    return (x - 0.5) * 2.0 if zero_crossings else x


def global_ritz_process(A, B1, B2=None, weak_tol=15.0, verbose=False):
    """An energy-orthonormal target set from the columns of ``[B1, B2]``.

    A^2 is Ritz-decomposed on their span (an orthonormal basis Q from QR,
    the Gram ``(A Q)^H (A Q)``); the Ritz vectors are kept in ascending
    order of their values E while ``1/E > weak_tol / rho(A)``, at least
    one, each scaled by ``1/sqrt(E)``."""
    A = to_csr(A)
    B = np.asarray(B1)
    if B.ndim == 1:
        B = B[:, None]
    if B2 is not None:
        B2 = np.asarray(B2)
        B = np.column_stack([B, B2.reshape(B.shape[0], -1)])

    Q, _ = np.linalg.qr(B)
    AQ = A @ Q
    G = AQ.conj().T @ AQ
    G = 0.5 * (G + G.conj().T)
    evals, evecs = np.linalg.eigh(G)
    evals = np.maximum(evals.real, 1e-300)
    V = Q @ evecs

    cutoff = weak_tol / approximate_spectral_radius(A)
    below = np.flatnonzero(1.0 / evals <= cutoff)
    keep = max(int(below[0]) if below.size else V.shape[1], 1)
    V = V[:, :keep] / np.sqrt(evals[None, :keep])
    if verbose:
        print(f"global Ritz: kept {keep}/{B.shape[1]} targets")
    return V


def local_ritz_process(A, AggOp, B, weak_tol=15.0, verbose=False):
    """The minimal local basis of the targets on each aggregate, which is
    the tentative prolongator.  Returns ``(T, counts)``, counts the basis
    vectors kept per aggregate.

    On each aggregate, the eigenvectors of the local Gram ``Ba^H Ba`` are
    kept, in descending order of eigenvalue E, while ``E > card(agg) *
    (weak_tol / rho(A)) / nnz(AggOp)`` (at least one), as ``Ba v /
    sqrt(E)``; one batched ``eigh`` over all aggregates."""
    A = to_csr(A)
    AggOp = sp.csr_matrix(AggOp)
    B = np.asarray(B)
    if B.ndim == 1:
        B = B[:, None]
    n, K = B.shape
    n_nodes, n_agg = AggOp.shape
    npdes = n // n_nodes

    tol = weak_tol / approximate_spectral_radius(A)
    total_nnz = max(AggOp.getnnz(), 1)

    # each aggregate's dofs, zero-padded to the largest aggregate
    Acsc = AggOp.tocsc()
    sizes = np.diff(Acsc.indptr)
    max_nodes = int(sizes.max()) if n_agg else 0
    node_idx = np.full((n_agg, max_nodes), -1, dtype=np.int64)
    agg_of = np.repeat(np.arange(n_agg), sizes)
    pos = np.arange(Acsc.indices.size) - np.repeat(Acsc.indptr[:-1], sizes)
    node_idx[agg_of, pos] = Acsc.indices
    valid = node_idx >= 0
    safe = np.where(valid, node_idx, 0)
    L = max_nodes * npdes
    dof_idx = (safe[:, :, None] * npdes
               + np.arange(npdes)[None, None, :]).reshape(n_agg, L)
    dvalid = np.repeat(valid, npdes, axis=1)
    Ba = B[dof_idx] * dvalid[:, :, None]        # (n_agg, L, K)

    G = np.einsum("alk,alm->akm", Ba.conj(), Ba)
    evals, evecs = np.linalg.eigh(G)
    evals = evals[:, ::-1].real                 # descending
    evecs = evecs[:, :, ::-1]

    local_const = (sizes * npdes)[:, None] * tol / total_nnz
    counts = np.maximum((evals > local_const).sum(axis=1), 1)
    scale = 1.0 / np.sqrt(np.maximum(evals, 1e-300))
    basis = np.einsum("alk,akm->alm", Ba, evecs) * scale[:, None, :]

    # aggregate a's first counts[a] basis vectors over its dof rows, in
    # the order (aggregate, dof, vector)
    col_of_agg = np.concatenate([[0], np.cumsum(counts)])
    keep = dvalid[:, :, None] & (np.arange(K)[None, None, :]
                                 < counts[:, None, None])
    a_idx, l_idx, j_idx = np.nonzero(keep)
    T = sp.csr_matrix((basis[a_idx, l_idx, j_idx],
                       (dof_idx[a_idx, l_idx], col_of_agg[a_idx] + j_idx)),
                      shape=(n, int(col_of_agg[-1])))
    if verbose:
        print(f"local Ritz: {T.shape[1]} columns from {K}x{n_agg} potential")
    return T, counts


def _relax_targets(A, num, iters, prepostsmoother, seed, work):
    """``max(num, 1)`` random vectors from ``default_rng(seed)`` (uniform
    in [-0.5, 0.5), complex for a complex A), each relaxed ``iters`` times
    on ``A x = 0``; the work counts ``2 nnz(A) iters`` each."""
    rng = np.random.default_rng(seed)
    ts = []
    for _ in range(max(num, 1)):
        x = rng.random(A.shape[0]).astype(A.dtype) - 0.5
        if np.iscomplexobj(np.zeros(1, dtype=A.dtype)):
            x = x + 1j * (rng.random(A.shape[0]) - 0.5)
        x = _relax_zero(A, x, prepostsmoother, iters)
        work[0] += 2 * A.nnz * iters
        ts.append(x)
    return np.column_stack(ts)


def _a_norm(x, A):
    return float(np.sqrt(abs(np.vdot(x, A @ x))))


def _test_level_conv(levels, level, iters, prepostsmoother, work, seed):
    """The convergence factor of host V-cycles on ``levels[level:]`` for
    ``A x = 0`` from a random start (``default_rng(seed)``): the ratio of
    the energy norms of the last two of ``max(iters, 2)`` cycles.  Returns
    ``(slowest error, factor)``."""
    As = [lvl.A for lvl in levels[level:]]
    Ps = [getattr(lvl, "P", None) for lvl in levels[level:]]
    rng = np.random.default_rng(seed)
    A = As[0]
    x = rng.random(A.shape[0]).astype(A.dtype) - 0.5
    if np.iscomplexobj(np.zeros(1, dtype=A.dtype)):
        x = x + 1j * (rng.random(A.shape[0]) - 0.5)
    prev = _a_norm(x, A)
    factor = 1.0
    b = np.zeros_like(x)
    for _ in range(max(iters, 2)):
        x = _host_vcycle(As, Ps, 0, x, b, prepostsmoother, 1)
        cur = _a_norm(x, A)
        factor = cur / max(prev, 1e-300)
        prev = cur
        work[0] += 2 * sum(a.nnz for a in As)
    return x, factor


def _galerkin(R, A, P):
    """``R A P`` as CSR."""
    return (R @ A @ P).tocsr()


class _HostLevel:
    """A level of the recursion: A, and once it coarsens B, T, AggOp, C, P
    and R (scipy and numpy)."""


def _try_solve(A_l, levels, level, *, max_targets, min_targets,
               num_initial_targets, targets_iters, conv_tol, weak_tol,
               local_weak_tol, coarse_size, smooth, strength, aggregate,
               max_levels, max_level_iterations, prepostsmoother, work,
               verbose, seed, initial_B=None):
    """Build ``levels[level:]`` from ``A_l``, recursively: the targets
    (``initial_B``, else relaxed from ``seed + level``), strength and
    aggregates, the filtered targets and T, then until the caps: P, R,
    the coarse operator, the levels below (seed + 7), the convergence test
    (seed + 13 count), and a stop when the factor is at most ``conv_tol``
    with at least ``min_targets`` targets, or ``max_targets`` are
    reached; else the slowest error joins the targets."""
    if level >= len(levels):
        levels.append(_HostLevel())
    else:
        levels[level] = _HostLevel()
        del levels[level + 1:]
    cur = levels[level]
    cur.A = A_l

    if A_l.shape[0] <= coarse_size or level >= max_levels - 1:
        return

    if initial_B is not None:
        B = np.asarray(initial_B, dtype=A_l.dtype)
        if B.ndim == 1:
            B = B[:, None]
    else:
        B = _relax_targets(A_l, num_initial_targets, targets_iters,
                           prepostsmoother, seed + level, work)
    C = _strength(A_l, B, strength)
    AggOp, _ = _aggregate(C, A_l, B, aggregate)

    B = global_ritz_process(A_l, B, weak_tol=weak_tol, verbose=verbose)
    T, _ = local_ritz_process(A_l, AggOp, B, weak_tol=local_weak_tol,
                              verbose=verbose)
    cur.B, cur.T, cur.AggOp, cur.C = B, T, AggOp, C

    count = 0
    while count < max_level_iterations:
        P = to_csr(_smooth_P(cur.T, A_l, cur.C, cur.B, smooth))
        cur.P = P
        cur.R = P.conjugate().T.tocsr()
        Ac = _galerkin(cur.R, A_l, P)

        _try_solve(Ac, levels, level + 1, max_targets=max_targets,
                   min_targets=min_targets,
                   num_initial_targets=num_initial_targets,
                   targets_iters=targets_iters, conv_tol=conv_tol,
                   weak_tol=weak_tol, local_weak_tol=local_weak_tol,
                   coarse_size=coarse_size, smooth=smooth,
                   strength=strength, aggregate=aggregate,
                   max_levels=max_levels,
                   max_level_iterations=max_level_iterations,
                   prepostsmoother=prepostsmoother, work=work,
                   verbose=verbose, seed=seed + 7)

        t, factor = _test_level_conv(levels, level, targets_iters,
                                     prepostsmoother, work,
                                     seed + 13 * count)
        if verbose:
            print("  " * level + f"level {level}: conv factor {factor:.3f} "
                  f"with {cur.B.shape[1]} target(s)")
        if factor <= conv_tol and cur.B.shape[1] >= min_targets:
            return
        if cur.B.shape[1] >= max_targets:
            return
        count += 1
        if count >= max_level_iterations:
            # the cap: B and T stay those of the P and R just built
            return
        B = global_ritz_process(A_l, cur.B, t, weak_tol=weak_tol,
                                verbose=verbose)
        T, _ = local_ritz_process(A_l, cur.AggOp, B,
                                  weak_tol=local_weak_tol, verbose=verbose)
        cur.B, cur.T = B, T


def tl_sa_solver(A, B=None, max_targets=4, min_targets=0,
                 num_initial_targets=1, targets_iters=10, conv_tol=0.5,
                 weak_tol=15.0, local_weak_tol=15.0, max_coarse=100,
                 coarse_size=None, max_levels=20, max_level_iterations=4,
                 prepostsmoother=("gauss_seidel", {"sweep": "symmetric"}),
                 smooth=("richardson", {"omega": 1.0}),
                 strength="symmetric", aggregate="standard",
                 coarse_solver="pinv", verbose=False, seed=0, device="cuda",
                 **kwargs):
    """The recursive adaptive SA hierarchy of ``A`` (see the module
    docstring) as a ``MultilevelSolver`` on ``device``, its setup work in
    units of nnz(A) on ``ml._asa_work``.  ``B`` seeds the finest level's
    targets.  The legacy keywords ``max_candidates`` (= ``max_targets``),
    ``improvement_iters`` (``max_level_iterations`` = half of it, at least
    1) and ``target_convergence`` (ignored) are taken; any other keyword
    is ignored with a warning."""
    if "max_candidates" in kwargs:
        max_targets = kwargs.pop("max_candidates")
    if "improvement_iters" in kwargs:
        max_level_iterations = max(kwargs.pop("improvement_iters") // 2, 1)
    kwargs.pop("target_convergence", None)
    if kwargs:
        warnings.warn("tl_sa_solver ignoring unsupported options: "
                      f"{sorted(kwargs)}")

    A = to_csr(A)
    if coarse_size is None:
        coarse_size = max_coarse
    work = [0.0]
    host_levels = []
    B0 = None
    if B is not None:
        B0 = np.asarray(B, dtype=A.dtype)
        if B0.ndim == 1:
            B0 = B0[:, None]
    _try_solve(A, host_levels, 0, initial_B=B0, max_targets=max_targets,
               min_targets=min_targets,
               num_initial_targets=num_initial_targets,
               targets_iters=targets_iters, conv_tol=conv_tol,
               weak_tol=weak_tol, local_weak_tol=local_weak_tol,
               coarse_size=coarse_size, smooth=smooth, strength=strength,
               aggregate=aggregate, max_levels=max_levels,
               max_level_iterations=max_level_iterations,
               prepostsmoother=prepostsmoother, work=work, verbose=verbose,
               seed=seed)

    levels = []
    for hl in host_levels:
        lvl = Level(A_csr=hl.A, blocksize=1)
        if hasattr(hl, "P"):
            lvl.P_csr, lvl.R_csr = hl.P, hl.R
            lvl.B, lvl.AggOp, lvl.T, lvl.C = hl.B, hl.AggOp, hl.T, hl.C
        levels.append(lvl)
    _finalize_device_operators(levels, device=device)
    ml = MultilevelSolver(levels, coarse_solver=coarse_solver, device=device)
    change_smoothers(ml, prepostsmoother, prepostsmoother)
    ml._asa_work = work[0] / max(A.nnz, 1)
    return ml


def asa_solver(A, B=None, device="cuda", **kwargs):
    """The recursive adaptive SA solver: :func:`tl_sa_solver` with the
    same keywords."""
    return tl_sa_solver(A, B=B, device=device, **kwargs)
