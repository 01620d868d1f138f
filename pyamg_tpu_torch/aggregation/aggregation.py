"""Smoothed aggregation (SA) solver constructor.

Port of ``pyamg_tpu/aggregation/aggregation.py`` for hermitian,
symmetric and nonsymmetric problems, scalar (CSR) or blocked (BSR, ``bs``
dofs per node), with any number K of near-nullspace candidates (default:
the constant per dof of a node, ``kron(ones, eye(bs))``).  Per level, on
the host in numpy/scipy: relax the candidates (``improve_candidates``),
then

* on a grid (a hermitian or symmetric matrix carrying ``A.grid``, as the
  gallery builds it: a 2-D grid with ``aggregate="standard"``, a grid of
  any dimension with ``aggregate=("grid", {"block": ...})``) with Jacobi,
  Richardson or no prolongation smoothing: grid-block aggregation ->
  tentative prolongator -> ``P = S T`` with ``S = I - omega/rho(D^-1 A)
  D^-1 A`` -> ``R = P^H`` -> Galerkin product; coarse levels carry K dofs
  per grid node.  Under strong grid-aligned anisotropy with a line
  smoother, only the weak axes coarsen and S is ``jacobi_weak`` (Jacobi
  without the strong-axis couplings).  The device operators are A as
  ``SparseDIA`` (a blocked level flattened to scalar diagonals, else
  ``SparseBDIA``) and P, R as gather-free ``ComposedOp`` chains of the
  smoother S (``SparseDIA``, or ``SparseBDIA`` on a blocked level) and a
  grid operator;
* otherwise: strength of connection (of the block graph for BSR) ->
  (diagonal-dominance filter) -> aggregation -> tentative prolongator ->
  prolongation smoothing (Jacobi, Richardson, energy minimization) -> R by
  symmetry (nonsymmetric: R^H smoothed the same way on A^H, from the left
  candidates BH and A^H's strength) -> Galerkin product, in BSR blocks on
  a blocked level (-> coarse filter); the device operators are whatever
  ``device_operator`` chooses for A (DIA, dense or padded ELL) and, for P and R, the
  aggregate-root embedding as DIA where it exists and is banded (K equal
  to the fine dofs per node), else ``device_operator``'s form.

Setups outside the port raise ``NotImplementedError`` naming the ROADMAP
item that ports them.
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp
import torch

from ..amg_core import (have_native, identity_minus_rowscaled_native,
                        weak_axis_filter_native)
from ..multilevel import Level, MultilevelSolver
from ..relaxation.smoothing import change_smoothers, rho_D_inv_A
from ..sparse import (ComposedOp, DenseOp, GridPoolOp, GridRepeatOp,
                      SparseBDIA, SparseDIA, device_operator,
                      root_embedded_transfers)
from ..sparse.device_op import DIA_MEM_BUDGET, DIA_MEM_FLOOR
from ..strength import (affinity_distance, algebraic_distance,
                        classical_strength_of_connection,
                        distance_strength_of_connection,
                        energy_based_strength_of_connection,
                        evolution_strength_of_connection,
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
    if fn == "distance":
        return distance_strength_of_connection(A, **kwargs)
    if fn in ("ode", "evolution"):
        if "B" in kwargs:
            return evolution_strength_of_connection(A, **kwargs)
        return evolution_strength_of_connection(A, B, **kwargs)
    if fn == "energy_based":
        return energy_based_strength_of_connection(A, **kwargs)
    if fn == "algebraic_distance":
        return algebraic_distance(A, **kwargs)
    if fn == "affinity":
        return affinity_distance(A, **kwargs)
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
        return energy_prolongation_smoother(A, T, C, B, None, (False, {}),
                                            **kwargs)
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

    Ported: hermitian, symmetric and nonsymmetric problems (the last with
    left candidates ``BH``, B by default, and R smoothed on A^H), CSR or
    BSR, with any number of near-nullspace candidates ``B`` (n, K), with
    grid metadata (``A.grid``, any dimension; a nonsymmetric matrix takes
    the unstructured chain) or without.

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
    A_in = A
    blocksize = 1
    if sp.issparse(A_in) and A_in.format == "bsr":
        blocksize = A_in.blocksize[0]
    A = to_csr(A_in)
    n = A.shape[0]
    if B is None:
        B = np.kron(np.ones((n // blocksize, 1), dtype=A.dtype),
                    np.eye(blocksize, dtype=A.dtype))
    else:
        B = np.asarray(B, dtype=A.dtype)
        if B.ndim == 1:
            B = B[:, None]
        if B.shape[0] != n:
            raise ValueError("near nullspace has incorrect dimensions")
        if B.shape[1] > 5:
            warnings.warn("Having more than 5 candidates per level is costly")
    if symmetry == "nonsymmetric":
        # the left near-nullspace candidates, for the restriction
        BH = B.copy() if BH is None else np.asarray(BH, dtype=A.dtype)
        if BH.ndim == 1:
            BH = BH[:, None]

    max_levels, max_coarse, strength = levelize_strength_or_aggregation(
        strength, max_levels, max_coarse)
    max_levels, max_coarse, aggregate = levelize_strength_or_aggregation(
        aggregate, max_levels, max_coarse)
    improve_candidates = levelize_smooth_or_improve_candidates(
        improve_candidates, max_levels)
    smooth = levelize_smooth_or_improve_candidates(smooth, max_levels)

    levels = [Level()]
    levels[0].A_csr = A
    levels[0].A_bsr = sp.bsr_matrix(A_in) if blocksize > 1 else None
    levels[0].B = B
    levels[0].blocksize = blocksize
    if symmetry == "nonsymmetric":
        levels[0].BH = BH
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
           and levels[-1].A_csr.shape[0] // max(levels[-1].blocksize, 1)
           > max_coarse):
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


def _banded_device_op(A_csr, q, A_bsr, npdt, device):
    """``SparseBDIA`` of a level with q dofs per grid node, or None when its
    block pattern is not banded (more than 64 block diagonals) or the
    dense bands would pass the scalar chooser's memory budget."""
    if A_bsr is None or A_bsr.blocksize != (q, q):
        A_bsr = A_csr.tobsr(blocksize=(q, q))
    nb = A_bsr.shape[0] // q
    brows = np.repeat(np.arange(nb), np.diff(A_bsr.indptr))
    n_off = np.unique(A_bsr.indices - brows).size
    if n_off * nb * q * q > max(DIA_MEM_BUDGET * max(A_bsr.nnz, 1),
                                DIA_MEM_FLOOR):
        return None
    try:
        blocks, offs = SparseBDIA.host_blocks(A_bsr, max_offsets=64,
                                              dtype=npdt)
    except ValueError:
        return None
    return SparseBDIA(torch.as_tensor(blocks, device=device), offs,
                      A_csr.shape)


def _finalize_device_operators(levels, op_dtype=None, device="cuda"):
    """Build the device form of every level.  A: ``device_operator``'s
    choice; on a blocked level with a grid, a scalar DIA or dense form
    first (a banded operator of uniform blocks is a scalar DIA of at most
    ``n_off * (2q - 1)`` diagonals, and rides the DIA kernel), else
    ``SparseBDIA``, else the padded ELL.  Transfers of a structured level:
    P = ``ComposedOp(S, GridRepeatOp)`` and R = ``ComposedOp(GridPoolOp,
    S^H)`` with S and S^H as ``SparseDIA`` (``SparseBDIA`` with q > 1 dofs
    per node); of any other level: the aggregate-root embedding where it
    is banded, else ``device_operator``'s choice.  Every array is cast to
    ``op_dtype`` on the host and moved to ``device`` once."""
    npdt = numpy_dtype(op_dtype)
    for lvl in levels:
        q_lvl = max(getattr(lvl, "blocksize", 1), 1)
        lvl.A = device_operator(lvl.A_csr, dtype=npdt, device=device)
        if (q_lvl > 1 and getattr(lvl, "grid", None) is not None
                and not isinstance(lvl.A, (SparseDIA, DenseOp))):
            lvl.A = _banded_device_op(lvl.A_csr, q_lvl,
                                      getattr(lvl, "A_bsr", None), npdt,
                                      device) or lvl.A
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
        q = meta.get("q", 1)
        wmap = meta["wmap"]
        if npdt is not None:
            wmap = wmap.astype(npdt, copy=False)
        wmap = torch.as_tensor(wmap, device=device)
        T = GridRepeatOp(wmap, meta["grid"], meta["block"], (n_f, n_c),
                         node_dofs=q)
        # for symmetry='symmetric' the host builds R_csr = P.T (no
        # conjugation); a real wmap makes conj a no-op either way
        conj = (getattr(lvl, "symmetry", "hermitian") == "hermitian")
        Tt = GridPoolOp(wmap, meta["grid"], meta["block"], (n_c, n_f),
                        node_dofs=q,
                        conj=conj and np.iscomplexobj(meta["wmap"]))
        if meta["degree"] == 0 or meta["S_csr"] is None:
            lvl.P, lvl.R = T, Tt
            continue
        # S = I - c D^{-1} A shares A's banded structure; S and S^H are
        # built on the host (a shift of each diagonal for S^H)
        s_shape = meta["S_csr"].shape
        if q > 1:
            s_blocks, s_offs = SparseBDIA.host_blocks(
                meta["S_csr"].tobsr(blocksize=(q, q)), dtype=npdt)
            sh_blocks, sh_offs = SparseBDIA.host_transpose(
                s_blocks, s_offs,
                conj=conj and np.iscomplexobj(meta["S_csr"].data))
            S = SparseBDIA(torch.as_tensor(s_blocks, device=device), s_offs,
                           s_shape)
            SH = SparseBDIA(torch.as_tensor(sh_blocks, device=device),
                            sh_offs, s_shape)
        else:
            s_diags, s_offs = SparseDIA.host_diags(meta["S_csr"], dtype=npdt,
                                                   max_offsets=1024)
            sh_diags, sh_offs = SparseDIA.host_transpose(s_diags, s_offs,
                                                         s_shape)
            if conj and np.iscomplexobj(meta["S_csr"].data):
                sh_diags = sh_diags.conj()
            S = SparseDIA(torch.as_tensor(s_diags, device=device), s_offs,
                          s_shape)
            SH = SparseDIA(torch.as_tensor(sh_diags, device=device),
                           sh_offs, s_shape[::-1])
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


def structured_smoother_S(A, sfn, skw, symmetry, grid=None, block=None,
                          q_lvl=1):
    """Prolongation-smoother matrix of the structured path, ``P = S^degree
    @ T``, for Jacobi, Richardson and ``jacobi_weak`` smoothing.  Returns
    ``(S_csr_or_None, degree)``.

    ``jacobi_weak`` (the semicoarsening levels of line smoothers) is Jacobi
    on ``A_w``, A without the couplings along the uncoarsened axes of
    ``block`` on ``grid`` (``q_lvl`` dofs per node): ``S = I - c D^{-1}
    A_w`` with D the diagonal of A, so that S P keeps width 1 along the
    strong axes."""
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
    Dinv = get_diagonal(A, inv=True)
    if sfn == "jacobi_weak":
        A = weak_axis_filter(A, q_lvl, grid, block)
    elif sfn != "jacobi":
        raise ValueError(f"unrecognized prolongation smoother {sfn!r}")
    c = omega / rho_D_inv_A(A, symmetric=sym_hint)
    # S = I - c D^{-1} A in place on A's sparsity: ((-c) * Dinv_i) * A_ij;
    # the compiled one-pass form equals the numpy expression bit for bit
    Sx = identity_minus_rowscaled_native(A, Dinv, c)
    if Sx is not None:
        return sp.csr_matrix((Sx, A.indices, A.indptr),
                             shape=A.shape), degree
    S_data = (-c) * np.repeat(Dinv, np.diff(A.indptr)) * A.data
    return _add_identity_inplace(S_data, A, A.shape[0]), degree


def weak_axis_filter(A, q, grid, block):
    """A without the couplings whose node offset moves along an
    uncoarsened axis (``block[k] == 1``) of ``grid`` (``q`` dofs per node),
    stored zeros dropped.  The node offset is split over the axes by
    descending stride, ``d_k = rint(rem / stride_k)`` (half to even); the
    compiled pass and this numpy form keep the same entries."""
    strides = [int(np.prod(grid[kk + 1:])) for kk in range(len(grid))]
    Aw = weak_axis_filter_native(A, q, strides, block)
    if Aw is not None:
        if Aw.nnz and not Aw.data.all():
            Aw.eliminate_zeros()
        return Aw
    n = A.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr))
    rem = A.indices.astype(np.int64) // q - rows // q
    keep = np.ones(A.nnz, dtype=bool)
    for k in np.argsort(strides)[::-1]:
        dk = np.rint(rem / strides[k]).astype(np.int64)
        rem = rem - dk * strides[k]
        if block[k] == 1:
            keep &= dk == 0
    # fresh index arrays: eliminate_zeros compacts them in place
    Aw = sp.csr_matrix((np.where(keep, A.data, 0), A.indices.copy(),
                        A.indptr.copy()), shape=A.shape)
    Aw.eliminate_zeros()
    return Aw


def _extend_structured(levels, lvl, A, B, grid, sfn, skw, akw, keep,
                       symmetry):
    """One structured coarsening step: grid-block aggregation and Jacobi
    prolongation smoothing, recorded with the metadata that
    :func:`_finalize_device_operators` needs.  With K candidates the coarse
    level carries K dofs per grid node (node-major) and its operator is
    block-banded."""
    block = akw.get("block")
    q_lvl = max(getattr(lvl, "blocksize", 1), 1)
    if block is None:
        # per-level anisotropy-aware blocks: under strong grid-aligned
        # anisotropy with line relaxation, coarsen only the weak axes
        strides = [int(np.prod(grid[kk + 1:])) * q_lvl
                   for kk in range(len(grid))]
        coup = np.array([np.abs(A.diagonal(s)).sum() + 1e-300
                         for s in strides])
        K_cand = B.shape[1]
        if (getattr(lvl, "_line_smoother", False)
                and K_cand % q_lvl == 0 and q_lvl in (1, K_cand)
                and len(grid) >= 2 and coup.max() > 25.0 * coup.min()):
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
    K = B.shape[1]
    rows_w = np.repeat(np.arange(n), np.diff(T.indptr))
    if K == 1 and q_lvl == 1:
        wmap = np.zeros(n, dtype=A.dtype)
        wmap[rows_w] = T.data
    else:
        # (n_dofs, K): the weight of each fine dof on its node's K coarse
        # values; needed on a node-blocked level even for K == 1
        wmap = np.zeros((n, K), dtype=A.dtype)
        wmap[rows_w, T.indices % K] = T.data

    S_csr, degree = structured_smoother_S(A, sfn, skw, symmetry, grid=grid,
                                          block=block, q_lvl=q_lvl)
    P = T
    for _ in range(degree):
        P = (S_csr @ P).tocsr()
    R = P.conjugate().T.tocsr() if symmetry == "hermitian" else P.T.tocsr()

    lvl.struct_meta = {"grid": tuple(grid), "block": block, "wmap": wmap,
                       "S_csr": S_csr, "degree": degree, "sfn": sfn,
                       "skw": dict(skw) if skw else {}, "K": K, "q": q_lvl}
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
    new.blocksize = K                 # K dofs per coarse grid node
    new.symmetry = symmetry
    new.A_bsr = None
    new.grid = cgrid
    if K == 1:
        A_coarse.grid = cgrid
    new._line_smoother = getattr(lvl, "_line_smoother", False)
    levels.append(new)


def galerkin_product(lvl, A, bs, K_c, symmetry):
    """The coarse operator ``R A P`` of the level's transfers, stored zeros
    dropped; on a blocked level (``bs`` > 1 dofs per node, ``K_c`` > 1
    coarse candidates) in BSR blocks.  Returns ``(A_coarse_csr,
    A_coarse_bsr or None)``."""
    A_coarse_bsr = None
    if (bs > 1 and getattr(lvl, "A_bsr", None) is not None and K_c > 1
            and lvl.P_csr.shape[0] % bs == 0
            and lvl.P_csr.shape[1] % K_c == 0):
        try:
            Pb = lvl.P_csr.tobsr(blocksize=(bs, K_c))
            if symmetry == "hermitian":
                Rb = Pb.conjugate().transpose()
            elif symmetry == "symmetric":
                Rb = Pb.transpose()
            else:           # the nonsymmetric level's own R
                Rb = lvl.R_csr.tobsr(blocksize=(K_c, bs))
            A_coarse_bsr = Rb @ lvl.A_bsr @ Pb
            A_coarse = A_coarse_bsr.tocsr()
        except ValueError:
            A_coarse_bsr = None
    if A_coarse_bsr is None:
        A_coarse = (lvl.R_csr @ A @ lvl.P_csr).tocsr()
    A_coarse.eliminate_zeros()
    return A_coarse, A_coarse_bsr


def coarse_bsr_twin(A_coarse, A_coarse_bsr, blocksize, filtered=False):
    """The coarse level's BSR twin: the BSR Galerkin product when its
    blocksize matches and no filter changed the CSR form, else a
    conversion; None on a scalar level."""
    if blocksize <= 1 or A_coarse.shape[0] % blocksize:
        return None
    if (A_coarse_bsr is not None and not filtered
            and A_coarse_bsr.blocksize == (blocksize, blocksize)):
        A_coarse_bsr.eliminate_zeros()
        return A_coarse_bsr
    return A_coarse.tobsr(blocksize=(blocksize, blocksize))


def _extend_sa_hierarchy(levels, strength, aggregate, smooth,
                         improve_candidates, diagonal_dominance, keep,
                         symmetry, coarse_filter=None):
    """One SA coarsening step."""
    lvl = levels[-1]
    A = lvl.A_csr
    B = lvl.B
    bs = lvl.blocksize
    i = len(levels) - 1
    # a blocked level's strength, aggregation and smoothing see its BSR
    # twin: the block graph, node aggregates, BSR prolongation smoothing
    A_bsr = getattr(lvl, "A_bsr", None)
    A_for_strength = A_bsr if (bs > 1 and A_bsr is not None) else A

    # improve the candidates by relaxing on A B = 0
    ic = improve_candidates[i]
    if ic is not None:
        b0 = np.zeros((A.shape[0], 1), dtype=A.dtype)
        op = relaxation_as_linear_operator(ic, A, b0)
        B = np.column_stack([op @ B[:, k] for k in range(B.shape[1])])
        lvl.B = B
        if symmetry == "nonsymmetric":
            opH = relaxation_as_linear_operator(
                ic, A.conjugate().T.tocsr(), b0)
            lvl.BH = np.column_stack([opH @ lvl.BH[:, k]
                                      for k in range(lvl.BH.shape[1])])

    grid = getattr(lvl, "grid", None)
    sfn, skw = unpack_arg(smooth[i]) if smooth[i] is not None else (None, {})
    afn, akw = unpack_arg(aggregate[i])
    # structured-grid path: grid-block aggregation keeps every level a
    # stencil matrix (q = max(bs, 1) dofs per grid node), so the device
    # operators are DIA (or BDIA) and grid transfers.  "standard" takes it
    # on a 2-D grid only: 3^3 blocks coarsen a 3-D grid too fast (17 against
    # 13 iterations on the 64^3 Poisson problem in the JAX package), so a
    # 3-D grid goes down the unstructured chain unless the caller asks for
    # ("grid", {"block": ...}); a nonsymmetric level always does
    if (grid is not None
            and symmetry in ("hermitian", "symmetric")
            and (afn == "grid" or (afn == "standard" and len(grid) == 2))
            and sfn in (None, "jacobi", "richardson")
            and np.prod(grid) * max(bs, 1) == A.shape[0]):
        _extend_structured(levels, lvl, A, B, grid, sfn, skw, akw, keep,
                           symmetry)
        return

    C = _strength(A_for_strength, B, strength[i])
    if diagonal_dominance:
        kwargs = diagonal_dominance[1] \
            if isinstance(diagonal_dominance, tuple) else {}
        C = eliminate_diag_dom_nodes(A, C, **(kwargs if isinstance(
            kwargs, dict) else {}))

    AggOp, Cpts = _aggregate(C, A_for_strength, B, aggregate[i])
    if AggOp.shape[1] == 0:
        return

    T, B_coarse = fit_candidates(AggOp, B)
    P = _smooth_P(T, A_for_strength, C, B_coarse, smooth[i],
                  sym_hint=symmetry != "nonsymmetric")
    if symmetry == "hermitian":
        R = P.conjugate().T.tocsr()
    elif symmetry == "symmetric":
        R = P.T.tocsr()
    else:
        # R^H is the prolongation of A^H from the left candidates, on the
        # same aggregates with A^H's own strength
        TH, BH_coarse = fit_candidates(AggOp, lvl.BH)
        AH = (A_bsr.conjugate().T.tobsr() if (bs > 1 and A_bsr is not None)
              else A.conjugate().T.tocsr())
        CH = _strength(AH, lvl.BH, strength[i])
        R = _smooth_P(TH, AH, CH, BH_coarse, smooth[i]).conjugate().T.tocsr()

    lvl.C = C if keep else None
    if keep:
        lvl.AggOp = AggOp
        lvl.T = T
    lvl.P_csr = to_csr(P)
    lvl.R_csr = to_csr(R)

    # the fine position of every coarse dof, for the gather-free DIA form
    # of the transfers (sparse/embed.py): coarse dof a*K+k embeds at fine
    # dof roots[a]*q+k, one to one only when K equals the fine dofs per
    # node q (a blocked level 0 with K != q keeps device_operator's form)
    if Cpts is not None:
        n_agg = AggOp.shape[1]
        nc = lvl.P_csr.shape[1]
        roots = np.asarray(Cpts, dtype=np.int64)
        if n_agg and roots.size == n_agg and nc % n_agg == 0:
            K = nc // n_agg
            q = max(bs, 1)
            if K == q:
                lvl.root_dofs = (roots[:, None] * q
                                 + np.arange(K)[None, :]).ravel()

    A_coarse, A_coarse_bsr = galerkin_product(lvl, A, bs, B_coarse.shape[1],
                                              symmetry)
    if coarse_filter:
        # drop weak Galerkin fill-in, lumped onto the diagonal (row sums
        # kept): bounds the densification of coarse operators
        theta = coarse_filter if isinstance(coarse_filter, float) else 1e-2
        A_coarse = filter_matrix_rows(A_coarse, theta, lump=True)

    new = Level()
    new.A_csr = A_coarse
    new.B = B_coarse
    new.blocksize = B.shape[1] if B.shape[1] > 1 else 1
    new.symmetry = symmetry
    if symmetry == "nonsymmetric":
        new.BH = BH_coarse
    new.A_bsr = coarse_bsr_twin(A_coarse, A_coarse_bsr, new.blocksize,
                                filtered=bool(coarse_filter))
    levels.append(new)
