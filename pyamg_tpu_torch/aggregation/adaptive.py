"""Adaptive smoothed aggregation (alpha-SA).

Port of ``pyamg_tpu/aggregation/adaptive.py`` (Brezina, Falgout,
MacLachlan, Manteuffel, McCormick, Ruge, "Adaptive Smoothed Aggregation
(alphaSA) Multigrid", SIAM Review 47(2), 2005), on the host in
numpy/scipy; only the final hierarchy is moved to the device.

* initial stage: a random vector (``default_rng(seed)``, the JAX package's
  draws) is relaxed on ``A x = 0``, carried down a trial hierarchy as it is
  built (each level's restriction relaxed on that level's homogeneous
  system) and brought back up with relaxation at every level.  On a grid
  the trial hierarchy takes the structured path, so the candidate is
  relaxed with the cycle's own smoother (zebra needs the grid); otherwise
  its aggregates and strength graphs are frozen for the later builds.
* general stage: each further candidate starts as a random vector run
  through the current solver on ``A x = 0`` (host V-cycles), is refined
  level by level while the hierarchy is rebuilt in the enlarged candidate
  space, and climbs back with relaxation at every level.
* local elimination zeroes a candidate on aggregates where it is small or
  already represented by the tentative prolongator.

The intermediate hierarchies are host-only (``finalize_device=False``);
nothing reaches the device before the final build.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..util.linalg import approximate_spectral_radius, norm
from ..util.utils import (host_relaxation,
                          levelize_smooth_or_improve_candidates,
                          levelize_strength_or_aggregation, to_csr,
                          unpack_arg)
from .aggregation import (_aggregate, _extend_sa_hierarchy, _smooth_P,
                          _strength, smoothed_aggregation_solver,
                          structured_smoother_S)
from .tentative import fit_candidates

__all__ = ["adaptive_sa_solver", "eliminate_local_candidates",
           "initial_setup_stage"]

# host smoothers that take a ``sweep`` argument
_SWEEP_SMOOTHERS = frozenset(["gauss_seidel", "sor", "block_gauss_seidel",
                              "gauss_seidel_indexed", "gauss_seidel_ne",
                              "gauss_seidel_nr"])


def _relax(A, x, b, method, iterations):
    """``iterations`` passes of a host relaxation on ``A x = b``, in place;
    a device-only name is symmetric Gauss-Seidel (``host_relaxation``)."""
    fn, kwargs = host_relaxation(method)
    kwargs.pop("iterations", None)
    if fn.__name__ in _SWEEP_SMOOTHERS:
        kwargs.setdefault("sweep", "symmetric")
    fn(A, x, b, iterations=iterations, **kwargs)


def _relax_zero(A, x, method, iterations):
    """Relax on ``A x = 0`` in place, then scale x to unit inf-norm (the
    candidate pipeline is scale-invariant, and strong relaxation on
    ``A x = 0`` shrinks x geometrically: 15 zebra sweeps a level over a
    deep hierarchy would underflow it to 0).  Returns x."""
    _relax(A, x, np.zeros(A.shape[0], dtype=A.dtype), method, iterations)
    nrm = norm(x, "inf")
    if nrm > 0 and np.isfinite(nrm):
        x /= nrm
    return x


def eliminate_local_candidates(x, AggOp, A, T, Ca=1.0):
    """Zero the candidate ``x`` (in place) on the aggregates where it is
    not needed: where its local mass ``<x, x>_agg``, or what is left of it
    after projecting onto range(T), is at most ``Ca * card(agg) * <A x, x>
    / (n rho(A))``."""
    AggOp = to_csr(AggOp)
    xv = np.ravel(x)
    n_nodes = AggOp.shape[0]
    npdes = xv.shape[0] // n_nodes

    def agg_ip(z):
        z2 = (np.abs(z) ** 2).reshape(n_nodes, npdes).sum(axis=1)
        return AggOp.T @ z2

    rho = approximate_spectral_radius(A)
    xAx = float(np.real(np.vdot(xv, A @ xv)))
    card = npdes * np.asarray(AggOp.sum(axis=0)).ravel()
    weights = Ca * card * xAx / (A.shape[0] * max(rho, 1e-300))
    mask = agg_ip(xv) <= weights
    mask |= agg_ip(xv - T @ (T.conjugate().T @ xv)) <= weights
    drop_aggs = np.nonzero(mask)[0]
    if drop_aggs.size:
        drop_nodes = AggOp[:, drop_aggs].tocsc().indices
        dofs = (npdes * drop_nodes[:, None]
                + np.arange(npdes)[None, :]).ravel()
        xv[dofs] = 0.0
    if x.ndim > 1:
        x[:] = xv.reshape(x.shape)
    return x


def initial_setup_stage(A, symmetry, pdef, candidate_iters, epsilon,
                        max_levels, max_coarse, aggregate, prepostsmoother,
                        smooth, strength, initial_candidate=None, seed=0,
                        structured_ok=False):
    """The initial stage: build a trial hierarchy while carrying a relaxed
    candidate down every level, then prolongate the coarsest one back up
    with relaxation at every level.  Returns ``(x, aggregate, strength,
    work)``: on the generic descent, aggregate and strength are
    "predefined" lists that freeze the aggregates found."""
    A = to_csr(A)
    max_levels, max_coarse, strength = levelize_strength_or_aggregation(
        strength, max_levels, max_coarse)
    max_levels, max_coarse, aggregate = levelize_strength_or_aggregation(
        aggregate, max_levels, max_coarse)
    smooth = levelize_smooth_or_improve_candidates(smooth, max_levels)

    rng = np.random.default_rng(seed)
    work = 0.0
    if initial_candidate is None:
        x = rng.random(A.shape[0]).astype(A.dtype)
        if np.iscomplexobj(np.zeros(1, dtype=A.dtype)):
            x = x + 1j * rng.random(A.shape[0])
    else:
        x = np.ravel(np.asarray(initial_candidate, dtype=A.dtype)).copy()
    x = _relax_zero(A, x, prepostsmoother, candidate_iters)
    work += 2 * A.nnz * candidate_iters

    # on a grid (where the caller allows it) the trial hierarchy takes the
    # structured path of the final build: every coarse operator keeps its
    # grid, so the candidate is relaxed with the cycle's own smoother
    grid0 = getattr(A, "grid", None)
    structured = (structured_ok and grid0 is not None
                  and int(np.prod(grid0)) == A.shape[0]
                  and symmetry in ("hermitian", "symmetric"))
    A_l = A
    As, Ps, aggs, strgs, xs = [A], [], [], [], [x]
    if structured:
        from ..multilevel import Level

        lvl0 = Level()
        lvl0.A_csr = A
        lvl0.A_bsr = None
        lvl0.B = x[:, None]
        lvl0.blocksize = 1
        lvl0.symmetry = symmetry
        lvl0.grid = tuple(int(g) for g in grid0)
        lvl0._line_smoother = unpack_arg(prepostsmoother)[0] in (
            "zebra", "line_jacobi", "line_gauss_seidel")
        slevels = [lvl0]
        none_improve = [None] * max_levels
        while A_l.shape[0] > max_coarse and len(As) < max_levels:
            slevels[-1].B = x[:, None]     # the relaxed candidate drives T
            n_prev = slevels[-1].A_csr.shape[0]
            _extend_sa_hierarchy(slevels, strength, aggregate, smooth,
                                 none_improve, False, False, symmetry)
            if slevels[-1].A_csr.shape[0] == n_prev:
                break
            A_l = slevels[-1].A_csr
            Ps.append(to_csr(slevels[-2].P_csr))
            As.append(A_l)
            x = np.ravel(np.asarray(slevels[-1].B))
            if A_l.shape[0] > max_coarse and len(As) < max_levels:
                x = _relax_zero(A_l, x, prepostsmoother, candidate_iters)
                work += 2 * A_l.nnz * candidate_iters
            xs.append(x)
    while not structured and A_l.shape[0] > max_coarse \
            and len(As) < max_levels:
        i = len(As) - 1
        C = _strength(A_l, x[:, None], strength[i])
        AggOp, _ = _aggregate(C, A_l, x[:, None], aggregate[i])
        if AggOp.shape[1] == 0 or AggOp.shape[1] == AggOp.shape[0]:
            break
        T, x_c = fit_candidates(AggOp, x[:, None])
        P = _smooth_P(T, A_l, C, x_c, smooth[i],
                      sym_hint=symmetry != "nonsymmetric")
        R = P.conjugate().T.tocsr() if symmetry == "hermitian" \
            else P.T.tocsr()
        A_l = (R @ A_l @ P).tocsr()
        strgs.append(C)
        aggs.append(AggOp)
        Ps.append(to_csr(P))
        As.append(A_l)
        x = np.ravel(x_c)
        if A_l.shape[0] > max_coarse and len(As) < max_levels:
            # the coarsest x stays the relaxed restriction of the level
            # above it
            x = _relax_zero(A_l, x, prepostsmoother, candidate_iters)
            work += 2 * A_l.nnz * candidate_iters
        xs.append(x)

    # climb: prolongate the coarsest candidate to the finest level,
    # relaxing on each level's homogeneous system on the way
    x = xs[-1]
    for lev in range(len(Ps) - 1, -1, -1):
        x = Ps[lev] @ x
        x = _relax_zero(As[lev], x, prepostsmoother, candidate_iters)
        work += 2 * As[lev].nnz * candidate_iters

    aggregate = [("predefined", {"AggOp": agg}) for agg in aggs] \
        if aggs else aggregate
    strength = [("predefined", {"C": C}) for C in strgs] \
        if strgs else strength
    return x, aggregate, strength, work


def _host_vcycle(As, Ps, i, x, b, prepostsmoother, candidate_iters=1,
                 Rs=None):
    """One host V-cycle on the lists of operators and prolongators from
    level ``i`` (``Rs``: the restrictions where they are built already)."""
    A = As[i]
    if i >= len(Ps) or Ps[i] is None or A.shape[0] <= 1:
        try:
            return np.linalg.lstsq(A.toarray(), b, rcond=None)[0]
        except np.linalg.LinAlgError:
            return x
    x = x.copy()
    _relax(A, x, b, prepostsmoother, candidate_iters)
    r = b - A @ x
    P = Ps[i]
    if Rs is not None and i < len(Rs) and Rs[i] is not None:
        bc = Rs[i] @ r
    else:
        bc = P.conjugate().T @ r
    xc = _host_vcycle(As, Ps, i + 1, np.zeros_like(bc), bc,
                      prepostsmoother, candidate_iters, Rs=Rs)
    x = x + P @ xc
    _relax(A, x, b, prepostsmoother, candidate_iters)
    return x


def _bridge_rows(T, k):
    """A tentative prolongator whose rows live on a level with ``k`` dofs
    per node, re-indexed to address the same dofs of a level with ``k+1``
    dofs per node (the new dof's rows are empty)."""
    T = to_csr(T)
    m = T.shape[0] // k
    counts = np.diff(T.indptr).reshape(m, k)
    new_counts = np.hstack(
        [counts, np.zeros((m, 1), dtype=counts.dtype)]).ravel()
    new_indptr = np.concatenate(
        [np.zeros(1, dtype=T.indptr.dtype), np.cumsum(new_counts)])
    return sp.csr_matrix((T.data, T.indices, new_indptr),
                         shape=(m * (k + 1), T.shape[1]))


def _general_setup_stage(ml, A, symmetry, candidate_iters, prepostsmoother,
                         smooth, eliminate_local, seed):
    """The general stage: one further candidate from the current solver's
    slowest error, refined level by level while the hierarchy is rebuilt
    top-down in the enlarged candidate space (the coarse tentative
    prolongators bridged into it), then relaxed back up to the finest
    level.  Returns ``(x, work)``."""
    rng = np.random.default_rng(seed)
    levels = ml.levels
    nl = len(levels)
    n = A.shape[0]
    work = 0.0
    x = rng.random(n).astype(A.dtype)
    if np.iscomplexobj(np.zeros(1, dtype=A.dtype)):
        x = x + 1j * rng.random(n)
    # the current solver on A x = 0, in host V-cycles: this hierarchy is
    # applied a few times and then rebuilt
    As_full = [lvl.A_csr for lvl in levels]
    Ps_full = [getattr(lvl, "P_csr", None) for lvl in levels[:-1]]
    Rs_full = [getattr(lvl, "R_csr", None) for lvl in levels[:-1]]
    b0 = np.zeros(n, dtype=A.dtype)
    for _ in range(candidate_iters):
        x = _host_vcycle(As_full, Ps_full, 0, x, b0, prepostsmoother, 1,
                         Rs=Rs_full)
    work += 2 * ml.operator_complexity() * A.nnz * candidate_iters

    T0 = getattr(levels[0], "T", None)
    # host copies of the hierarchy, updated top-down during the descent
    As = [lvl.A_csr for lvl in levels]
    Ps = [getattr(lvl, "P_csr", None) for lvl in levels[:-1]]
    Ts = [getattr(lvl, "T", None) for lvl in levels[:-1]]
    Bs = [getattr(lvl, "B", None) for lvl in levels]
    Cs = [getattr(lvl, "C", None) for lvl in levels[:-1]]
    Aggs = [getattr(lvl, "AggOp", None) for lvl in levels[:-1]]
    metas = [getattr(lvl, "struct_meta", None) for lvl in levels[:-1]]

    def resmooth(T_new, i, Bc_coarse):
        """Smooth a refitted tentative prolongator as the final build
        will: a structured level with its structured smoother (rebuilt on
        the enlarged operator where the descent replaced it), any other
        with ``_smooth_P``."""
        meta = metas[i]
        if meta is None:
            return to_csr(_smooth_P(to_csr(T_new), As[i], Cs[i], Bc_coarse,
                                    smooth[i],
                                    sym_hint=symmetry != "nonsymmetric"))
        if As[i] is levels[i].A_csr:
            S, degree = meta["S_csr"], meta["degree"]
        else:
            q_i = As[i].shape[0] // int(np.prod(meta["grid"]))
            S, degree = structured_smoother_S(
                As[i], meta["sfn"], meta["skw"], symmetry,
                grid=meta["grid"], block=meta["block"], q_lvl=q_i)
        P = to_csr(T_new)
        for _ in range(degree):
            P = (S @ P).tocsr()
        return P

    xs = [x]
    for i in range(nl - 2):
        if Aggs[i] is None or Bs[i] is None:
            break
        # refit level i's tentative prolongator with the candidate appended
        T_new, Bc = fit_candidates(Aggs[i], np.column_stack([Bs[i], xs[-1]]))
        P_new = resmooth(T_new, i, Bc)
        As[i + 1] = (P_new.conjugate().T @ As[i] @ P_new).tocsr()
        Ps[i] = P_new
        x_c = np.ravel(np.asarray(Bc)[:, -1]).copy()
        if i + 1 < nl - 1 and Ts[i + 1] is not None:
            # bridge level i+1's tentative prolongator into the enlarged
            # space, so that the old sub-hierarchy below can polish the
            # restricted candidate
            T_b = _bridge_rows(Ts[i + 1], Bs[i + 1].shape[1])
            P_b = resmooth(T_b, i + 1, Bs[i + 2])
            Ps[i + 1] = P_b
            Ts[i + 1] = T_b
            As[i + 2] = (P_b.conjugate().T @ As[i + 1] @ P_b).tocsr()
            Bs[i + 1] = np.asarray(Bc)[:, :-1]
            for _ in range(max(candidate_iters // 2, 1)):
                x_c = _host_vcycle(As, Ps, i + 1, x_c, np.zeros_like(x_c),
                                   prepostsmoother, 1)
            work += 2 * sum(a.nnz for a in As[i + 1:]) * candidate_iters
        else:
            x_c = _relax_zero(As[i + 1], x_c, prepostsmoother,
                              candidate_iters)
            work += 2 * As[i + 1].nnz * candidate_iters
        xs.append(x_c)

    # climb back; Gauss-Seidel relaxes only on the candidate's support, so
    # that locally eliminated regions stay zero
    from ..relaxation.relaxation import gauss_seidel_indexed

    x = xs[-1]
    for i in range(len(xs) - 2, -1, -1):
        x = Ps[i] @ x
        if unpack_arg(prepostsmoother)[0] == "gauss_seidel":
            idx = np.nonzero(np.ravel(x))[0]
            gauss_seidel_indexed(As[i], x, np.zeros_like(x), idx,
                                 iterations=candidate_iters,
                                 sweep="symmetric")
        else:
            x = _relax_zero(As[i], x, prepostsmoother, candidate_iters)
        work += 2 * As[i].nnz * candidate_iters

    elim, elim_kwargs = unpack_arg(eliminate_local)
    if elim is True and T0 is not None and Aggs[0] is not None:
        nrm = norm(x, "inf")
        if nrm > 0:
            x = x / nrm
        eliminate_local_candidates(x, Aggs[0], A, to_csr(T0), **elim_kwargs)
    return x, work


def adaptive_sa_solver(A, initial_candidates=None, symmetry="hermitian",
                       pdef=True, num_candidates=1, candidate_iters=5,
                       improvement_iters=0, epsilon=0.1,
                       max_levels=10, max_coarse=100,
                       aggregate="standard",
                       prepostsmoother=("gauss_seidel",
                                        {"sweep": "symmetric"}),
                       smooth=("jacobi", {}), strength="symmetric",
                       coarse_solver="pinv",
                       eliminate_local=(False, {"Ca": 1.0}),
                       keep=False, seed=0, device="cuda", **kwargs):
    """Create an adaptive SA solver on ``device``; returns ``(ml, work)``.

    The signature and defaults are the JAX package's, with ``device``
    ("cuda" by default, no fallback to the CPU); ``kwargs`` go to every
    ``smoothed_aggregation_solver`` build (``op_dtype`` among them).
    ``num_candidates`` is the total number of near-nullspace candidates
    (the initial stage makes the first, the general stage the rest);
    ``work`` is the setup work in units of the fine level's nnz.

    Examples
    --------
    >>> import numpy as np
    >>> from pyamg_tpu_torch.gallery import poisson
    >>> A = poisson((16, 16), format='csr')
    >>> ml, work = adaptive_sa_solver(A, num_candidates=1, max_coarse=20,
    ...                               device="cpu")
    >>> b = np.ones(A.shape[0])
    >>> res = []
    >>> x = ml.solve(b, tol=1e-8, residuals=res)
    >>> bool(res[-1] < 1e-8 * res[0] and work > 0)
    True
    """
    A = to_csr(A)             # a CSR input is itself, its grid kept
    grid = getattr(A, "grid", None)
    work = 0.0

    def build(B, agg, strg, keep_flag=True, finalize=False):
        # the intermediate hierarchies stay on the host: they make
        # candidates and aggregates and never run a device cycle
        return smoothed_aggregation_solver(
            A, B=B, symmetry=symmetry, strength=strg, aggregate=agg,
            smooth=smooth, presmoother=prepostsmoother,
            postsmoother=prepostsmoother, improve_candidates=None,
            max_levels=max_levels, max_coarse=max_coarse,
            coarse_solver=coarse_solver, keep=keep_flag,
            finalize_device=finalize, device=device, **kwargs)

    if initial_candidates is None:
        x, aggregate_f, strength_f, w = initial_setup_stage(
            A, symmetry, pdef, candidate_iters, epsilon, max_levels,
            max_coarse, aggregate, prepostsmoother, smooth, strength,
            seed=seed, structured_ok=True)
        work += w
        if grid is None:
            aggregate, strength = aggregate_f, strength_f
        # on a grid the builds keep the caller's aggregation: the structured
        # path's grid blocks, which "predefined" lists would defeat
        nrm = norm(x, "inf")
        B = (x / (nrm if nrm else 1.0))[:, None].astype(A.dtype)
    else:
        B = np.asarray(initial_candidates, dtype=A.dtype)
        if B.ndim == 1:
            B = B[:, None]
        # freeze the aggregates of a trial hierarchy built on the given B
        sa = build(B, aggregate, strength)
        if len(sa.levels) > 1 and all(getattr(lvl, "AggOp", None) is not None
                                      for lvl in sa.levels[:-1]):
            aggregate = [("predefined", {"AggOp": to_csr(lvl.AggOp)})
                         for lvl in sa.levels[:-1]]
            if all(getattr(lvl, "C", None) is not None
                   for lvl in sa.levels[:-1]):
                strength = [("predefined", {"C": to_csr(lvl.C)})
                            for lvl in sa.levels[:-1]]

    ml = build(B, aggregate, strength)
    smooth_lv = levelize_smooth_or_improve_candidates(smooth, max_levels)

    while B.shape[1] < num_candidates:
        x, w = _general_setup_stage(ml, A, symmetry, candidate_iters,
                                    prepostsmoother, smooth_lv,
                                    eliminate_local, seed + B.shape[1])
        work += w
        nrm = norm(x, "inf")
        if nrm == 0 or not np.isfinite(nrm):
            break
        B = np.column_stack([B, x / nrm])
        if B.shape[1] < num_candidates:
            # only the next general stage reads this hierarchy
            ml = build(B, aggregate, strength)

    if B.shape[1] > 1 and improvement_iters > 0:
        b0 = np.zeros(A.shape[0], dtype=A.dtype)
        for _ in range(improvement_iters):
            for _j in range(B.shape[1]):
                # rebuild without the oldest candidate, run that solver on
                # A x = 0 from it and append the result
                x0 = B[:, 0].copy()
                B = B[:, 1:]
                sa_tmp = build(B, aggregate, strength)
                As_t = [lvl.A_csr for lvl in sa_tmp.levels]
                Ps_t = [getattr(lvl, "P_csr", None)
                        for lvl in sa_tmp.levels[:-1]]
                Rs_t = [getattr(lvl, "R_csr", None)
                        for lvl in sa_tmp.levels[:-1]]
                x = x0
                for _ in range(candidate_iters):
                    x = _host_vcycle(As_t, Ps_t, 0, x, b0, prepostsmoother,
                                     1, Rs=Rs_t)
                work += (2 * sa_tmp.operator_complexity() * A.nnz
                         * candidate_iters)
                elim, elim_kwargs = unpack_arg(eliminate_local)
                if elim is True and hasattr(sa_tmp.levels[0], "AggOp"):
                    x = x / max(norm(x, "inf"), 1e-300)
                    eliminate_local_candidates(
                        x, sa_tmp.levels[0].AggOp, A, sa_tmp.levels[0].T,
                        **elim_kwargs)
                nrm = norm(x, "inf")
                B = np.column_stack([B, x / (nrm if nrm else 1.0)])
    elif improvement_iters > 0:
        # one candidate: repeat the initial descent from the current B
        for _ in range(improvement_iters):
            x, aggregate_f2, strength_f2, w = initial_setup_stage(
                A, symmetry, pdef, candidate_iters, epsilon,
                len(aggregate) + 1 if isinstance(aggregate, list)
                else max_levels,
                max_coarse, aggregate, prepostsmoother, smooth, strength,
                initial_candidate=B[:, 0], seed=seed, structured_ok=True)
            work += w
            if grid is None:
                aggregate, strength = aggregate_f2, strength_f2
            B = (x / max(norm(x, "inf"), 1e-300))[:, None].astype(A.dtype)

    ml = build(B, aggregate, strength, keep_flag=keep, finalize=True)
    return ml, float(work) / max(A.nnz, 1)
