"""Smoothed aggregation (SA) solver constructor.

Port of ``pyamg_tpu/aggregation/aggregation.py`` for scalar, hermitian or
symmetric problems with one near-nullspace candidate.  Per level, on the
host in numpy/scipy: relax the candidate (``improve_candidates``), then

* on a 2-D grid (a matrix carrying ``A.grid``, as the gallery builds it):
  grid-block aggregation -> tentative prolongator -> ``P = S T`` with ``S =
  I - omega/rho(D^-1 A) D^-1 A`` -> ``R = P^H`` -> Galerkin product; the
  device operators are A as ``SparseDIA`` and P, R as gather-free
  ``ComposedOp`` chains of a DIA smoother and a grid operator;
* otherwise: strength of connection -> (diagonal-dominance filter) ->
  aggregation -> tentative prolongator -> prolongation smoothing -> R by
  symmetry -> Galerkin product (-> coarse filter); the device operators
  are whatever ``device_operator`` chooses for A (DIA, dense or padded
  ELL) and, for P and R, the aggregate-root embedding as DIA where its
  pattern is banded, else ``device_operator``'s form.

Setups outside the port raise ``NotImplementedError`` naming the ROADMAP
item that ports them.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..amg_core import have_native, identity_minus_rowscaled_native
from ..multilevel import Level, MultilevelSolver
from ..relaxation.smoothing import change_smoothers, rho_D_inv_A
from ..sparse import (ComposedOp, GridPoolOp, GridRepeatOp, SparseDIA,
                      device_operator, root_embedded_transfers)
from ..strength import (classical_strength_of_connection,
                        symmetric_strength_of_connection)
from ..util.linalg import approximate_spectral_radius
from ..util.utils import (eliminate_diag_dom_nodes, filter_matrix_rows,
                          get_diagonal,
                          levelize_smooth_or_improve_candidates,
                          levelize_strength_or_aggregation, not_ported,
                          numpy_dtype, relaxation_as_linear_operator, to_csr,
                          torch_dtype, unpack_arg)
from .aggregate import (grid_aggregation, naive_aggregation,
                        parallel_aggregation, standard_aggregation)
from .smooth import (energy_prolongation_smoother,
                     jacobi_prolongation_smoother,
                     richardson_prolongation_smoother)
from .tentative import fit_candidates

__all__ = ["smoothed_aggregation_solver", "structured_smoother_S",
           "galerkin_product"]

_UNSTRUCTURED = "the unstructured SA chain"


def _strength(A, B, flag):
    fn, kwargs = unpack_arg(flag)
    if fn == "symmetric":
        return symmetric_strength_of_connection(A, **kwargs)
    if fn == "classical":
        return classical_strength_of_connection(A, **kwargs)
    if fn == "predefined":
        return to_csr(kwargs["C"])
    if fn is None:
        C = to_csr(A).copy()
        C.data = np.ones_like(C.data)
        return C
    if fn in ("distance", "ode", "evolution", "energy_based",
              "algebraic_distance", "affinity"):
        raise not_ported(f"strength of connection {fn!r}", _UNSTRUCTURED)
    raise ValueError(f"unrecognized strength of connection method {fn!r}")


def _aggregate(C, A, B, flag):
    fn, kwargs = unpack_arg(flag)
    if fn == "standard":
        # the sequential three-pass greedy is O(nnz) at any size in the
        # compiled library; without it the round-based form takes over for
        # large graphs (a caller's ``sequential_limit`` moves the line)
        lim = kwargs.pop("sequential_limit", None)
        if lim is None:
            lim = 50_000_000 if have_native() else 50_000
        if C.shape[0] > lim:
            return parallel_aggregation(C, **kwargs)
        return standard_aggregation(C, **kwargs)
    if fn in ("parallel", "mis"):
        return parallel_aggregation(C, **kwargs)
    if fn == "naive":
        return naive_aggregation(C, **kwargs)
    if fn == "predefined":
        return to_csr(kwargs["AggOp"]), None
    if fn in ("lloyd", "pairwise"):
        raise not_ported(f"aggregation {fn!r}", _UNSTRUCTURED)
    raise ValueError(f"unrecognized aggregation method {fn!r}")


def _smooth_P(T, A, C, B, flag, sym_hint=None):
    fn, kwargs = unpack_arg(flag)
    if fn == "jacobi":
        return jacobi_prolongation_smoother(A, T, C, B, sym_hint=sym_hint,
                                            **kwargs)
    if fn == "richardson":
        return richardson_prolongation_smoother(A, T, sym_hint=sym_hint,
                                                **kwargs)
    if fn == "energy":
        return energy_prolongation_smoother(A, T, C, B, **kwargs)
    if fn is None:
        return to_csr(T)
    raise ValueError(f"unrecognized prolongation smoother {fn!r}")


def smoothed_aggregation_solver(A, B=None, BH=None, symmetry="hermitian",
                                strength="symmetric",
                                aggregate="standard",
                                smooth=("jacobi",
                                        {"omega": 4.0 / 3.0}),
                                presmoother=("block_gauss_seidel",
                                             {"sweep": "symmetric"}),
                                postsmoother=("block_gauss_seidel",
                                              {"sweep": "symmetric"}),
                                improve_candidates=(("block_gauss_seidel",
                                                     {"sweep": "symmetric",
                                                      "iterations": 4}),
                                                    None),
                                max_levels=10, max_coarse=500,
                                diagonal_dominance=False, keep=False,
                                coarse_solver="pinv", coarse_filter=None,
                                op_dtype=None, finalize_device=True,
                                device="cuda", **kwargs):
    """Create a smoothed-aggregation AMG solver on ``device``.

    The signature and defaults are the JAX package's.  ``op_dtype`` builds
    every device operator and smoother in that dtype (e.g.
    ``torch.float32`` for a float32 preconditioner from a float64 host
    setup).  ``device`` is where the hierarchy lives: "cuda" by default,
    and there is no fallback to the CPU.  With ``finalize_device=False`` the
    levels hold only the host matrices.

    Ported: scalar hermitian or symmetric problems with one near-nullspace
    candidate, on a 2-D grid (``A.grid``) or without grid metadata; other
    setups (nonsymmetric, BSR input, several candidates, 3-D grid metadata)
    raise ``NotImplementedError``.

    Examples
    --------
    >>> import numpy as np
    >>> from pyamg_tpu_torch.gallery import poisson
    >>> A = poisson((32, 32), format='csr')
    >>> ml = smoothed_aggregation_solver(A, max_coarse=50, device="cpu")
    >>> b = np.ones(A.shape[0])
    >>> res = []
    >>> x = ml.solve(b, tol=1e-8, residuals=res)
    >>> res[-1] < 1e-8 * res[0]
    True
    """
    if symmetry not in ("hermitian", "symmetric", "nonsymmetric"):
        raise ValueError("expected 'symmetric', 'nonsymmetric' or "
                         "'hermitian' for the symmetry parameter")
    if symmetry == "nonsymmetric":
        raise not_ported("nonsymmetric SA", _UNSTRUCTURED)
    if sp.issparse(A) and A.format == "bsr" and A.blocksize[0] > 1:
        raise not_ported("blocked (BSR) SA", "bdia/bell")

    A_in = A
    A = to_csr(A_in)
    n = A.shape[0]
    if B is None:
        B = np.ones((n, 1), dtype=A.dtype)
    else:
        B = np.asarray(B, dtype=A.dtype)
        if B.ndim == 1:
            B = B[:, None]
        if B.shape[0] != n:
            raise ValueError("near nullspace has incorrect dimensions")
        if B.shape[1] > 1:
            raise not_ported("multi-candidate SA", "bdia/bell")

    max_levels, max_coarse, strength = levelize_strength_or_aggregation(
        strength, max_levels, max_coarse)
    max_levels, max_coarse, aggregate = levelize_strength_or_aggregation(
        aggregate, max_levels, max_coarse)
    improve_candidates = levelize_smooth_or_improve_candidates(
        improve_candidates, max_levels)
    smooth = levelize_smooth_or_improve_candidates(smooth, max_levels)

    levels = [Level()]
    levels[0].A_csr = A
    levels[0].B = B
    levels[0].blocksize = 1
    levels[0].symmetry = symmetry
    levels[0].grid = getattr(A_in, "grid", None)
    # anisotropy-aware semicoarsening is only contractive together with
    # line relaxation along the strong axis
    _pre_name = unpack_arg(presmoother)[0]
    levels[0]._line_smoother = _pre_name in ("zebra", "line_jacobi",
                                             "line_gauss_seidel")
    agg0 = aggregate[0] if isinstance(aggregate, list) else aggregate
    fn0, kw0 = unpack_arg(agg0)
    if fn0 == "grid" and "grid" in kw0:
        levels[0].grid = tuple(kw0["grid"])

    while (len(levels) < max_levels
           and levels[-1].A_csr.shape[0] > max_coarse):
        n_prev = levels[-1].A_csr.shape[0]
        _extend_sa_hierarchy(levels, strength, aggregate, smooth,
                             improve_candidates, diagonal_dominance, keep,
                             symmetry, coarse_filter)
        if levels[-1].A_csr.shape[0] == n_prev:
            break

    if finalize_device:
        _finalize_device_operators(levels, op_dtype=op_dtype, device=device)
    ml = MultilevelSolver(levels, coarse_solver=coarse_solver, device=device)
    if op_dtype is not None:
        ml._op_dtype = torch_dtype(op_dtype)
    if finalize_device:
        change_smoothers(ml, presmoother, postsmoother)
    return ml


def _finalize_device_operators(levels, op_dtype=None, device="cuda"):
    """Build the device form of every level.  A: ``device_operator``'s
    choice.  Transfers of a structured level: P = ``ComposedOp(S,
    GridRepeatOp)`` and R = ``ComposedOp(GridPoolOp, S^H)`` with S and S^H
    as ``SparseDIA``; of any other level: the aggregate-root embedding
    where it is banded, else ``device_operator``'s choice.  Every array is
    cast to ``op_dtype`` on the host and moved to ``device`` once."""
    npdt = numpy_dtype(op_dtype)
    for lvl in levels:
        lvl.A = device_operator(lvl.A_csr, dtype=npdt, device=device)
        if not hasattr(lvl, "P_csr"):
            continue
        meta = getattr(lvl, "struct_meta", None)
        if meta is None:
            emb = root_embedded_transfers(lvl, dtype=npdt, device=device)
            if emb is not None:
                lvl.P, lvl.R = emb
            else:
                lvl.P = device_operator(lvl.P_csr, dtype=npdt, device=device)
                lvl.R = device_operator(lvl.R_csr, dtype=npdt, device=device)
            continue
        n_f, n_c = lvl.P_csr.shape
        wmap = meta["wmap"]
        if npdt is not None:
            wmap = wmap.astype(npdt, copy=False)
        wmap = torch.as_tensor(wmap, device=device)
        T = GridRepeatOp(wmap, meta["grid"], meta["block"], (n_f, n_c))
        # for symmetry='symmetric' the host builds R_csr = P.T (no
        # conjugation); a real wmap makes conj a no-op either way
        pool_conj = (np.iscomplexobj(meta["wmap"])
                     and getattr(lvl, "symmetry", "hermitian") == "hermitian")
        Tt = GridPoolOp(wmap, meta["grid"], meta["block"], (n_c, n_f),
                        conj=pool_conj)
        if meta["degree"] == 0 or meta["S_csr"] is None:
            lvl.P, lvl.R = T, Tt
            continue
        # S = I - c D^{-1} A shares A's banded structure; S and S^H are
        # built on the host (a shift of each diagonal vector for S^H)
        s_shape = meta["S_csr"].shape
        s_diags, s_offs = SparseDIA.host_diags(meta["S_csr"], dtype=npdt,
                                               max_offsets=1024)
        sh_diags, sh_offs = SparseDIA.host_transpose(s_diags, s_offs,
                                                     s_shape)
        S = SparseDIA(torch.as_tensor(s_diags, device=device), s_offs,
                      s_shape)
        SH = SparseDIA(torch.as_tensor(sh_diags, device=device), sh_offs,
                       s_shape[::-1])
        lvl.P = ComposedOp([S] * meta["degree"] + [T], (n_f, n_c))
        lvl.R = ComposedOp([Tt] + [SH] * meta["degree"], (n_c, n_f))


def _add_identity_inplace(S_data, A, n):
    """I + (matrix with A's sparsity and data S_data), without an SpADD --
    valid when A stores its full diagonal (falls back to eye-plus if
    not)."""
    diag_mask = A.indices == np.repeat(np.arange(n), np.diff(A.indptr))
    if int(diag_mask.sum()) == n:
        S_data[diag_mask] += 1.0
        return sp.csr_matrix((S_data, A.indices, A.indptr), shape=A.shape)
    S = sp.csr_matrix((S_data, A.indices, A.indptr), shape=A.shape)
    return (sp.eye(n, format="csr") + S).tocsr()


def structured_smoother_S(A, sfn, skw, symmetry):
    """Prolongation-smoother matrix of the structured path, ``P = S^degree
    @ T``, for Jacobi and Richardson smoothing.  Returns
    ``(S_csr_or_None, degree)``."""
    degree = int(skw.get("degree", 1)) if sfn else 0
    if degree == 0 or sfn is None:
        return None, degree
    sym_hint = (symmetry in ("hermitian", "symmetric")
                and not np.iscomplexobj(A.data))
    omega = float(skw.get("omega", 4.0 / 3.0))
    if sfn == "richardson":
        c = omega / approximate_spectral_radius(A, symmetric=sym_hint or None)
        return _add_identity_inplace((-c) * A.data.copy(), A,
                                     A.shape[0]), degree
    if sfn != "jacobi":
        # jacobi_weak: the semicoarsening branch of line smoothers
        raise not_ported(f"prolongation smoother {sfn!r}", _UNSTRUCTURED)
    c = omega / rho_D_inv_A(A, symmetric=sym_hint)
    Dinv = get_diagonal(A, inv=True)
    # S = I - c D^{-1} A in place on A's sparsity: ((-c) * Dinv_i) * A_ij;
    # the compiled one-pass form equals the numpy expression bit for bit
    Sx = identity_minus_rowscaled_native(A, Dinv, c)
    if Sx is not None:
        return sp.csr_matrix((Sx, A.indices, A.indptr),
                             shape=A.shape), degree
    S_data = (-c) * np.repeat(Dinv, np.diff(A.indptr)) * A.data
    return _add_identity_inplace(S_data, A, A.shape[0]), degree


def _extend_structured(levels, lvl, A, B, grid, sfn, skw, akw, keep,
                       symmetry):
    """One structured coarsening step: grid-block aggregation and Jacobi
    prolongation smoothing, recorded with the metadata that
    :func:`_finalize_device_operators` needs."""
    block = akw.get("block")
    if block is None:
        # per-level anisotropy-aware blocks: under strong grid-aligned
        # anisotropy with line relaxation, coarsen only the weak axes
        strides = [int(np.prod(grid[kk + 1:])) for kk in range(len(grid))]
        coup = np.array([np.abs(A.diagonal(s)).sum() + 1e-300
                         for s in strides])
        line_smoothing = getattr(lvl, "_line_smoother", False)
        if (line_smoothing and len(grid) >= 2
                and coup.max() > 25.0 * coup.min()):
            geo = float(np.sqrt(coup.max() * coup.min()))
            block = tuple(1 if cc > geo else 3 for cc in coup)
            sfn, skw = "jacobi_weak", {}
        else:
            block = (3,) * len(grid)
    block = tuple(block)
    if all(b == 1 for b in block):
        block = (3,) * len(grid)
    AggOp, _roots, cgrid = grid_aggregation(grid, block)
    T, B_coarse = fit_candidates(AggOp, B)
    T = T.tocsr()
    T.sort_indices()

    n = A.shape[0]
    wmap = np.zeros(n, dtype=A.dtype)
    wmap[np.repeat(np.arange(n), np.diff(T.indptr))] = T.data

    S_csr, degree = structured_smoother_S(A, sfn, skw, symmetry)
    P = T
    for _ in range(degree):
        P = (S_csr @ P).tocsr()
    R = P.conjugate().T.tocsr() if symmetry == "hermitian" else P.T.tocsr()

    lvl.struct_meta = {"grid": tuple(grid), "block": block, "wmap": wmap,
                       "S_csr": S_csr, "degree": degree, "sfn": sfn,
                       "skw": dict(skw) if skw else {}}
    lvl.P_csr = P
    lvl.R_csr = R
    if keep:
        lvl.AggOp = AggOp
        lvl.T = T

    A_coarse = (R @ A @ P).tocsr()
    A_coarse.eliminate_zeros()

    new = Level()
    new.A_csr = A_coarse
    new.B = B_coarse
    new.blocksize = 1
    new.symmetry = symmetry
    new.grid = cgrid
    A_coarse.grid = cgrid
    new._line_smoother = getattr(lvl, "_line_smoother", False)
    levels.append(new)


def galerkin_product(lvl, A):
    """The coarse operator ``R A P`` of the level's transfers, stored
    zeros dropped."""
    A_coarse = (lvl.R_csr @ A @ lvl.P_csr).tocsr()
    A_coarse.eliminate_zeros()
    return A_coarse


def _extend_sa_hierarchy(levels, strength, aggregate, smooth,
                         improve_candidates, diagonal_dominance, keep,
                         symmetry, coarse_filter=None):
    """One SA coarsening step."""
    lvl = levels[-1]
    A = lvl.A_csr
    B = lvl.B
    i = len(levels) - 1

    # improve the candidate by relaxing on A B = 0
    ic = improve_candidates[i]
    if ic is not None:
        b0 = np.zeros((A.shape[0], 1), dtype=A.dtype)
        op = relaxation_as_linear_operator(ic, A, b0)
        B = np.column_stack([op @ B[:, k] for k in range(B.shape[1])])
        lvl.B = B

    grid = getattr(lvl, "grid", None)
    sfn, skw = unpack_arg(smooth[i]) if smooth[i] is not None else (None, {})
    afn, akw = unpack_arg(aggregate[i])
    if grid is not None and len(grid) > 2:
        raise not_ported(f"SA on a matrix with {len(grid)}-D grid metadata",
                         _UNSTRUCTURED)
    # structured-grid path: grid-block aggregation keeps every level a
    # stencil matrix, so the device operators are DIA and grid transfers
    if (grid is not None
            and (afn == "grid" or (afn == "standard" and len(grid) == 2))
            and sfn in (None, "jacobi", "richardson")
            and np.prod(grid) == A.shape[0]):
        _extend_structured(levels, lvl, A, B, grid, sfn, skw, akw, keep,
                           symmetry)
        return

    C = _strength(A, B, strength[i])
    if diagonal_dominance:
        kwargs = diagonal_dominance[1] \
            if isinstance(diagonal_dominance, tuple) else {}
        C = eliminate_diag_dom_nodes(A, C, **(kwargs if isinstance(
            kwargs, dict) else {}))

    AggOp, Cpts = _aggregate(C, A, B, aggregate[i])
    if AggOp.shape[1] == 0:
        return

    T, B_coarse = fit_candidates(AggOp, B)
    P = _smooth_P(T, A, C, B_coarse, smooth[i], sym_hint=True)
    R = P.conjugate().T.tocsr() if symmetry == "hermitian" else P.T.tocsr()

    lvl.C = C if keep else None
    if keep:
        lvl.AggOp = AggOp
        lvl.T = T
    lvl.P_csr = to_csr(P)
    lvl.R_csr = to_csr(R)

    # the fine position of every coarse dof, for the gather-free DIA form
    # of the transfers (sparse/embed.py): aggregate a embeds at its root
    if Cpts is not None:
        roots = np.asarray(Cpts, dtype=np.int64)
        if roots.size and roots.size == AggOp.shape[1] == lvl.P_csr.shape[1]:
            lvl.root_dofs = roots

    A_coarse = galerkin_product(lvl, A)
    if coarse_filter:
        # drop weak Galerkin fill-in, lumped onto the diagonal (row sums
        # kept): bounds the densification of coarse operators
        theta = coarse_filter if isinstance(coarse_filter, float) else 1e-2
        A_coarse = filter_matrix_rows(A_coarse, theta, lump=True)

    new = Level()
    new.A_csr = A_coarse
    new.B = B_coarse
    new.blocksize = 1
    new.symmetry = symmetry
    levels.append(new)
