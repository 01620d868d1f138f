"""Root-node smoothed aggregation solver constructor.

Port of ``pyamg_tpu/aggregation/rootnode.py`` for hermitian, symmetric and
nonsymmetric problems, scalar (CSR) or blocked (BSR).  It is SA with four
differences: each aggregate keeps its root node, whose rows of P are rows
of the identity (``get_Cpt_params``, ``scale_T``); T fits only the first
``blocksize`` candidates, so that the root blocks are square; the coarse
candidates come by injection at the roots, ``P_I^T B``; and prolongation
smoothing is energy minimization with that root-node constraint.  The dofs
per node stay the same on every level.  The coarse dofs are fine root
dofs, so the transfers take the root-embedded DIA form
(``sparse/embed.py``) wherever it is banded.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..multilevel import Level, MultilevelSolver
from ..relaxation.smoothing import change_smoothers
from ..util.utils import (get_Cpt_params,
                          levelize_smooth_or_improve_candidates,
                          levelize_strength_or_aggregation,
                          relaxation_as_linear_operator, scale_T, to_csr,
                          torch_dtype, unpack_arg)
from .aggregation import (_aggregate,
                          _finalize_device_operators, _strength,
                          coarse_bsr_twin, galerkin_product)
from .smooth import energy_prolongation_smoother
from .tentative import fit_candidates

__all__ = ["rootnode_solver"]


def rootnode_solver(A, B=None, BH=None, symmetry="hermitian",
                    strength="symmetric", aggregate="standard",
                    smooth=("energy", {"krylov": "cg", "degree": 1,
                                       "maxiter": 4}),
                    presmoother=("block_gauss_seidel",
                                 {"sweep": "symmetric"}),
                    postsmoother=("block_gauss_seidel",
                                  {"sweep": "symmetric"}),
                    improve_candidates=(("block_gauss_seidel",
                                         {"sweep": "symmetric",
                                          "iterations": 4}), None),
                    max_levels=10, max_coarse=500, keep=False,
                    coarse_solver="pinv", op_dtype=None, device="cuda",
                    **kwargs):
    """Create a root-node smoothed-aggregation AMG solver on ``device``.

    The signature and defaults are the JAX package's; ``op_dtype`` builds
    every device operator and smoother in that dtype, and ``device`` is
    where the hierarchy lives ("cuda" by default, no fallback to the CPU).
    ``symmetry="nonsymmetric"`` smooths R on A^H from the left candidates
    ``BH`` (B by default).

    Examples
    --------
    >>> import numpy as np
    >>> from pyamg_tpu_torch.gallery import poisson
    >>> A = poisson((16, 16), format='csr')
    >>> ml = rootnode_solver(A, max_coarse=20, device="cpu")
    >>> b = np.ones(A.shape[0])
    >>> res = []
    >>> x = ml.solve(b, tol=1e-8, residuals=res)
    >>> res[-1] < 1e-8 * res[0]
    True
    """
    if symmetry not in ("hermitian", "symmetric", "nonsymmetric"):
        raise ValueError("invalid symmetry")

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
    if symmetry == "nonsymmetric":
        BH = B.copy() if BH is None else np.asarray(BH, dtype=A.dtype)

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
    levels[0].symmetry = symmetry
    if symmetry == "nonsymmetric":
        levels[0].BH = BH

    while (len(levels) < max_levels
           and levels[-1].A_csr.shape[0] // max(levels[-1].blocksize, 1)
           > max_coarse):
        n_prev = levels[-1].A_csr.shape[0]
        _extend_rootnode(levels, strength, aggregate, smooth,
                         improve_candidates, keep, symmetry)
        if levels[-1].A_csr.shape[0] == n_prev:
            break

    _finalize_device_operators(levels, op_dtype=op_dtype, device=device)
    ml = MultilevelSolver(levels, coarse_solver=coarse_solver, device=device)
    if op_dtype is not None:
        ml._op_dtype = torch_dtype(op_dtype)
    change_smoothers(ml, presmoother, postsmoother)
    return ml


def _root_nodes(AggOp, B):
    """The node of largest ``|B[:, 0]|`` in each aggregate: the roots of an
    aggregation that names none."""
    Acsc = AggOp.tocsc()
    roots = np.empty(AggOp.shape[1], dtype=np.int64)
    for a in range(AggOp.shape[1]):
        members = Acsc.indices[Acsc.indptr[a]:Acsc.indptr[a + 1]]
        roots[a] = members[int(np.argmax(np.abs(B[members, 0])))]
    return roots


def _extend_rootnode(levels, strength, aggregate, smooth, improve_candidates,
                     keep, symmetry):
    """One root-node coarsening step."""
    lvl = levels[-1]
    A = lvl.A_csr
    B = lvl.B
    bs = lvl.blocksize
    i = len(levels) - 1
    A_bsr = getattr(lvl, "A_bsr", None)
    A_for_strength = A_bsr if (bs > 1 and A_bsr is not None) else A

    ic = improve_candidates[i]
    if ic is not None:
        b0 = np.zeros((A.shape[0], 1), dtype=A.dtype)
        op = relaxation_as_linear_operator(ic, A, b0)
        B = np.column_stack([op @ B[:, k] for k in range(B.shape[1])])
        lvl.B = B

    C = _strength(A_for_strength, B, strength[i])
    AggOp, Cnodes = _aggregate(C, A_for_strength, B, aggregate[i])
    if AggOp.shape[1] == 0:
        return
    if Cnodes is None:
        Cnodes = _root_nodes(AggOp, B)

    # T fits only the first `bs` candidates, so that the root block of T is
    # square; all candidates are injected into the coarse B
    T, _ = fit_candidates(AggOp, B[:, :max(bs, 1)])
    Cpt_params = get_Cpt_params(A, Cnodes, AggOp, T)
    T = scale_T(T, Cpt_params["P_I"], Cpt_params["I_F"],
                blocksize=max(bs, 1))
    B_coarse = np.asarray(Cpt_params["P_I"].T @ B)

    fn, kwargs = unpack_arg(smooth[i])
    if fn == "energy":
        P = energy_prolongation_smoother(A, T, C, B_coarse, B,
                                         (True, Cpt_params), **kwargs)
    elif fn is None:
        P = to_csr(T)
    else:
        raise ValueError("rootnode_solver requires the 'energy' prolongation "
                         f"smoother (got {fn!r})")
    if symmetry == "hermitian":
        R = P.conjugate().T.tocsr()
    elif symmetry == "symmetric":
        R = P.T.tocsr()
    else:
        # R^H is the root-node prolongation of A^H from the left candidates,
        # on the same aggregates and roots, with A^H's own strength
        AH = A.conjugate().T.tocsr()
        CH = _strength(AH, lvl.BH, strength[i])
        TH, _ = fit_candidates(AggOp, lvl.BH)
        TH = scale_T(TH, Cpt_params["P_I"], Cpt_params["I_F"],
                     blocksize=max(bs, 1))
        if fn == "energy":
            BH_coarse = np.asarray(Cpt_params["P_I"].T @ lvl.BH)
            RH = energy_prolongation_smoother(AH, TH, CH, BH_coarse, lvl.BH,
                                              (True, Cpt_params), **kwargs)
        else:
            RH = to_csr(TH)
        R = RH.conjugate().T.tocsr()

    if keep:
        lvl.C = C
        lvl.AggOp = AggOp
        lvl.T = T
        lvl.Fpts = Cpt_params["Fpts"]
    lvl.Cpts = Cpt_params["Cpts"]
    lvl.P_csr = to_csr(P)
    lvl.R_csr = to_csr(R)
    # the coarse dofs are fine root dofs (P_I maps coarse column to fine
    # root row): where that map is one to one, it is the embedding of the
    # DIA form of the transfers
    Pi = Cpt_params["P_I"].tocoo()
    root_dofs = np.full(lvl.P_csr.shape[1], -1, dtype=np.int64)
    root_dofs[Pi.col] = Pi.row
    if (root_dofs >= 0).all():
        lvl.root_dofs = root_dofs

    A_coarse, A_coarse_bsr = galerkin_product(lvl, A, bs, B_coarse.shape[1],
                                              symmetry)
    new = Level()
    new.A_csr = A_coarse
    new.B = B_coarse
    # each coarse node carries the fine node's dofs (T fits bs candidates),
    # however many candidates B holds
    new.blocksize = max(bs, 1)
    new.symmetry = symmetry
    if symmetry == "nonsymmetric":
        new.BH = np.asarray(Cpt_params["P_I"].T @ lvl.BH)
    new.A_bsr = coarse_bsr_twin(A_coarse, A_coarse_bsr, new.blocksize)
    levels.append(new)
