"""The black-box solver: a configuration chosen from the matrix, then a
solve.

Port of ``pyamg_tpu/blackbox.py``.  A Hermitian matrix (by
``ishermitian``'s random probes, the JAX package's) gets smoothed
aggregation with evolution strength (k 2, l2 projection, epsilon 3),
energy-minimization P (CG, degree 2, local weighting), symmetric block
Gauss-Seidel and CG as accelerator; a nonsymmetric one gets
energy-minimization P by GMRES (degree 1, 2 iterations) with R smoothed on
A^H, symmetric Gauss-Seidel on the normal equations (``gauss_seidel_nr``,
2 iterations) and GMRES as accelerator.
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp

from .util.linalg import ishermitian
from .util.utils import to_csr

__all__ = ["solve", "solver", "solver_configuration", "make_csr"]


def make_csr(A):
    """A as CSR (a BSR matrix stays BSR); raises ``TypeError`` unless it
    is square."""
    if sp.issparse(A) and A.format == "bsr":
        return A
    if not sp.issparse(A):
        warnings.warn("implicit conversion of A to CSR",
                      sp.SparseEfficiencyWarning)
    A = to_csr(A)
    if A.shape[0] != A.shape[1]:
        raise TypeError("expected square matrix")
    return A


def solver_configuration(A, B=None, verb=True):
    """The keyword arguments of ``smoothed_aggregation_solver`` that suit
    ``A``, as a dict (with ``B`` and ``BH``), the JAX package's choice."""
    A = make_csr(A)
    config = {"symmetry": "hermitian" if ishermitian(A, fast_check=True)
              else "nonsymmetric"}
    if verb:
        print(f"  Detected a {config['symmetry']} matrix")
    if config["symmetry"] == "nonsymmetric":
        config["smooth"] = ("energy", {"krylov": "gmres", "maxiter": 2,
                                       "degree": 1, "weighting": "local"})
        config["presmoother"] = ("gauss_seidel_nr",
                                 {"sweep": "symmetric", "iterations": 2})
        config["postsmoother"] = ("gauss_seidel_nr",
                                  {"sweep": "symmetric", "iterations": 2})
    else:
        config["smooth"] = ("energy", {"krylov": "cg", "maxiter": 3,
                                       "degree": 2, "weighting": "local"})
        config["presmoother"] = ("block_gauss_seidel",
                                 {"sweep": "symmetric", "iterations": 1})
        config["postsmoother"] = ("block_gauss_seidel",
                                  {"sweep": "symmetric", "iterations": 1})

    blocksize = A.blocksize[0] if (sp.issparse(A) and A.format == "bsr") \
        else 1
    if B is None:
        config["B"] = np.kron(
            np.ones((A.shape[0] // blocksize, 1), dtype=A.dtype),
            np.eye(blocksize, dtype=A.dtype))
    else:
        B = np.asarray(B, dtype=A.dtype)
        if B.ndim == 1:
            B = B[:, None]
        if B.shape[0] != A.shape[0]:
            raise TypeError("B is not an appropriately sized array")
        config["B"] = B
    config["BH"] = config["B"].copy() \
        if config["symmetry"] == "nonsymmetric" else None
    config["strength"] = ("evolution", {"k": 2, "proj_type": "l2",
                                        "epsilon": 3.0})
    config["max_levels"] = 15
    config["max_coarse"] = 500
    config["coarse_solver"] = "pinv"
    config["aggregate"] = "standard"
    config["keep"] = False
    return config


def solver(A, config, device="cuda"):
    """``smoothed_aggregation_solver`` on ``device`` with a configuration
    of :func:`solver_configuration`.  A failed build raises ``TypeError``,
    as in the JAX package."""
    from .aggregation import smoothed_aggregation_solver

    A = make_csr(A)
    try:
        return smoothed_aggregation_solver(
            A, B=config["B"], BH=config.get("BH"),
            smooth=config["smooth"], strength=config["strength"],
            max_levels=config["max_levels"],
            max_coarse=config["max_coarse"],
            coarse_solver=config["coarse_solver"],
            symmetry=config["symmetry"], aggregate=config["aggregate"],
            presmoother=config["presmoother"],
            postsmoother=config["postsmoother"], keep=config["keep"],
            device=device)
    except Exception as e:
        raise TypeError(f"failed to generate solver: {e}") from e


def solve(A, b, x0=None, tol=1e-5, maxiter=400, return_solver=False,
          existing_solver=None, verb=True, residuals=None, device="cuda"):
    """Solve ``A x = b`` with an automatically configured SA-preconditioned
    Krylov method (CG for a Hermitian matrix, else GMRES) on ``device``;
    returns x, a tensor on the device (and the solver with
    ``return_solver``).

    Examples
    --------
    >>> import numpy as np
    >>> from pyamg_tpu_torch.gallery import poisson
    >>> A = poisson((40, 40), format='csr')
    >>> b = np.arange(A.shape[0], dtype=float)
    >>> x = solve(A, b, verb=False, device="cpu")
    >>> bool(np.linalg.norm(b - A @ x.numpy()) <= 1e-5 * np.linalg.norm(b))
    True
    """
    A = make_csr(A)
    b = np.asarray(b).ravel()
    if existing_solver is None:
        ml = solver(A, solver_configuration(A, verb=verb), device=device)
    else:
        ml = existing_solver
    if verb:
        print(ml)
    symmetry = getattr(ml.levels[0], "symmetry", "hermitian")
    accel = "cg" if symmetry == "hermitian" else "gmres"
    res = [] if residuals is None else residuals
    x = ml.solve(b, x0=x0, tol=tol, maxiter=maxiter, accel=accel,
                 residuals=res)
    if verb and len(res) > 1 and res[0] > 0:
        factor = (res[-1] / res[0]) ** (1.0 / (len(res) - 1))
        print(f"  Residual reduction factor: {factor:.2f}")
    if return_solver:
        return x, ml
    return x
