"""Multigrid hierarchy runtime: levels, the V-cycle, the coarse solve and the
solve entry points.

Port of ``pyamg_tpu/multilevel.py`` for the structured SA main path and
the padded-ELL hierarchies of the general device setup.  The JAX package
compiles each solve into one XLA program; here the cycle is plain eager
PyTorch on the hierarchy's device, every DIA matvec a launch of the
hand-written kernel, and the Krylov loop reads one scalar per iteration for
its stopping test.  The cycle only needs each level's operators to have a
``matvec``: DIA and grid operators, or padded-ELL operators with a coarse
pseudoinverse padded to the coarsest level's padded size
(``parallel.sharding.ShardedSolver``).  Only the V-cycle, the ``pinv``
coarse solver and CG acceleration are ported; other choices raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .krylov._cg import cg_core
from .krylov._common import finalize, norm
from .relaxation.device import apply_smoother
from .util.utils import not_ported, numpy_dtype, unpack_arg

__all__ = ["Level", "MultilevelSolver"]

_CYCLES_KRYLOV = "the rest of the cycles and Krylov methods"


class Level:
    """One level of the hierarchy: the device operators ``A``, ``P``, ``R``
    and smoothers, the host CSR twins the setup built them from, and setup
    byproducts kept for inspection."""

    def __init__(self, **kw):
        self.presmoother = None
        self.postsmoother = None
        for k, v in kw.items():
            setattr(self, k, v)

    @property
    def nnz(self):
        if hasattr(self, "A_csr"):
            return self.A_csr.nnz
        return self.A.nnz

    def host_A(self):
        """The host CSR matrix of A (rebuilt from the device operator for
        hierarchies that came without one)."""
        if not hasattr(self, "A_csr"):
            self.A_csr = self.A.to_scipy()
        return self.A_csr


class MultilevelSolver:
    """Multigrid hierarchy and its cycle, on one torch device.

    Examples
    --------
    >>> import numpy as np
    >>> from pyamg_tpu_torch.gallery import poisson
    >>> from pyamg_tpu_torch import smoothed_aggregation_solver
    >>> A = poisson((32, 32), format='csr')
    >>> ml = smoothed_aggregation_solver(A, max_coarse=50, device="cpu",
    ...     presmoother="chebyshev", postsmoother="chebyshev",
    ...     improve_candidates=None)
    >>> b = np.ones(A.shape[0])
    >>> res = []
    >>> x = ml.solve(b, tol=1e-8, residuals=res)
    >>> res[-1] < 1e-8 * res[0]
    True
    """

    def __init__(self, levels: List[Level], coarse_solver="pinv",
                 device="cuda"):
        name = unpack_arg(coarse_solver)[0]
        if name not in ("pinv", "pinv2"):
            raise not_ported(f"coarse solver {name!r}", _CYCLES_KRYLOV)
        self.levels = levels
        self.coarse_solver_spec = coarse_solver
        self.device = torch.device(device)
        self._coarse_mat = None
        self._A64 = None
        self.symmetry = getattr(levels[0], "symmetry", "hermitian") \
            if levels else "hermitian"

    # -- introspection ----------------------------------------------------
    def __repr__(self):
        output = f"{type(self).__name__}\n"
        output += f"Number of Levels:     {len(self.levels)}\n"
        output += f"Operator Complexity: {self.operator_complexity():6.3f}\n"
        output += f"Grid Complexity:     {self.grid_complexity():6.3f}\n"
        total_nnz = sum(lvl.nnz for lvl in self.levels)
        output += "level   unknowns     nonzeros\n"
        for n, lvl in enumerate(self.levels):
            output += (f"  {n:2d}   {lvl.A.shape[0]:10d}   {lvl.nnz:10d} "
                       f"[{100.0 * lvl.nnz / max(total_nnz, 1):2.2f}%]\n")
        return output

    def operator_complexity(self):
        """sum(nnz_l) / nnz_0."""
        return sum(lvl.nnz for lvl in self.levels) / self.levels[0].nnz

    def grid_complexity(self):
        """sum(n_l) / n_0."""
        return (sum(lvl.A.shape[0] for lvl in self.levels)
                / self.levels[0].A.shape[0])

    # -- cycle ------------------------------------------------------------
    def _coarse(self):
        """Dense pseudoinverse of the coarsest A, computed once on the host
        (numpy) and held on the device in the operators' dtype."""
        if self._coarse_mat is None:
            pinv = np.linalg.pinv(self.levels[-1].host_A().toarray())
            dt = getattr(self, "_op_dtype", None)
            if dt is not None:
                pinv = pinv.astype(numpy_dtype(dt))
            self._coarse_mat = torch.as_tensor(pinv, device=self.device)
        return self._coarse_mat

    def _solve_coarse(self, b):
        M = self._coarse()
        return (M @ b.to(M.dtype)).to(b.dtype)

    def _vcycle(self, lvl, x, b):
        levels = self.levels
        if lvl == len(levels) - 1:
            return self._solve_coarse(b)
        level = levels[lvl]
        A = level.A
        x = apply_smoother(level.presmoother, A, x, b)
        r = b - A.matvec(x)
        bc = level.R.matvec(r)
        if lvl + 1 == len(levels) - 1:
            xc = self._solve_coarse(bc)
        else:
            xc = self._vcycle(lvl + 1, torch.zeros_like(bc), bc)
        x = x + level.P.matvec(xc)
        return apply_smoother(level.postsmoother, A, x, b)

    def cycle_fn(self, cycle="V"):
        """``f(x, b)``: one cycle from ``x`` for right-hand side ``b``."""
        if str(cycle).upper() != "V":
            raise not_ported(f"cycle {cycle!r}", _CYCLES_KRYLOV)
        return lambda x, b: self._vcycle(0, x, b)

    # -- solves -----------------------------------------------------------
    def _as_tensor(self, v, dtype):
        if isinstance(v, torch.Tensor):
            return v.reshape(-1).to(device=self.device, dtype=dtype)
        return torch.as_tensor(np.ravel(np.asarray(v)), dtype=dtype,
                               device=self.device)

    def _run_cg(self, b, x, tol_t, maxiter, cycle="V"):
        A = self.levels[0].A
        cyc = self.cycle_fn(cycle)
        return cg_core(A.matvec, lambda r: cyc(torch.zeros_like(r), r),
                       x, b, tol_t, maxiter)

    def solve(self, b, x0=None, tol=1e-5, maxiter=100, cycle="V",
              accel=None, residuals=None, return_info=False):
        """Solve A x = b to relative residual ``tol`` in the hierarchy's
        dtype, on its device.

        ``accel``: None for stand-alone cycling, or ``"cg"`` for CG
        preconditioned by one cycle per iteration.  Returns ``x`` as a
        tensor on the hierarchy's device."""
        dtype = self.levels[0].A.dtype
        b_d = self._as_tensor(b, dtype)
        x = torch.zeros_like(b_d) if x0 is None \
            else self._as_tensor(x0, dtype)
        maxiter = 100 if maxiter is None else int(maxiter)

        if accel is not None:
            if accel != "cg":
                raise not_ported(f"accel={accel!r}", _CYCLES_KRYLOV)
            normb = norm(b_d)
            tol_t = float(tol * torch.where(normb == 0, 1, normb))
            xk, it, res_buf = self._run_cg(b_d, x, tol_t, maxiter, cycle)
            xk, info = finalize(xk, res_buf, it + 1, tol_t, residuals)
        else:
            A = self.levels[0].A
            cyc = self.cycle_fn(cycle)
            normb = float(norm(b_d))
            tol_t = numpy_dtype(dtype).type(
                tol * (normb if normb != 0.0 else 1.0))
            res = [float(norm(b_d - A.matvec(x)))]
            it = 0
            while res[-1] > tol_t and it < maxiter:
                x = cyc(x, b_d)
                res.append(float(norm(b_d - A.matvec(x))))
                it += 1
            xk, info = finalize(x, res, it + 1, tol_t, residuals)
        if return_info:
            return xk, info
        return xk

    def solve_mp(self, b, tol=1e-10, accel="cg", cycle="V",
                 inner_maxiter=40, max_rounds=6, inner_tol_factor=1e-6,
                 return_info=False, method="pcg"):
        """Solve A x = b to a float64 relative residual ``tol`` with the
        (float32) hierarchy as preconditioner.

        ``method="pcg"``: float64 CG in which each preconditioner
        application is one float32 cycle (r scaled to unit norm and cast
        down, the correction cast up and scaled back).
        ``method="defect"``: iterative refinement -- per round, one float64
        fine-grid residual and a float32 PCG solve of the correction to
        ``inner_tol_factor`` times that residual.

        Returns ``x`` (float64 tensor), or ``(x, info)`` with ``info =
        {"rounds", "inner_iterations"}`` when ``return_info`` is set;
        ``inner_iterations`` counts one more per round than the CG
        iterations (the round's starting residual), as the JAX package
        does."""
        if accel != "cg":
            raise not_ported(f"accel={accel!r}", _CYCLES_KRYLOV)
        op_dt = self.levels[0].A.dtype

        if self._A64 is None:
            from .sparse.device_op import device_operator

            self._A64 = device_operator(self.levels[0].host_A(),
                                        dtype=np.float64, device=self.device)
        A64 = self._A64
        b64 = self._as_tensor(b, torch.float64)
        normb = float(norm(b64))
        tol_abs = tol * (normb if normb != 0 else 1.0)
        cyc = self.cycle_fn(cycle)

        if method == "pcg":
            def pre(r64):
                # scale to O(1) before the f32 cast: late-stage residuals
                # (~1e-10*||b||) underflow f32 otherwise
                s = norm(r64)
                s = torch.where(s == 0, 1, s)
                r32 = (r64 / s).to(op_dt)
                return cyc(torch.zeros_like(r32), r32).to(torch.float64) * s

            x64, it, _ = cg_core(A64.matvec, pre, torch.zeros_like(b64), b64,
                                 tol_abs, int(inner_maxiter) * int(max_rounds))
            info = {"rounds": 1, "inner_iterations": it}
        elif method == "defect":
            x64 = torch.zeros_like(b64)
            rounds, iters = 0, 0
            while rounds < int(max_rounds):
                r64 = b64 - A64.matvec(x64)
                r32 = r64.to(op_dt)
                tol_t = numpy_dtype(op_dt).type(
                    float(inner_tol_factor) * float(norm(r64)))
                dx32, it, res_buf = self._run_cg(
                    r32, torch.zeros_like(r32), tol_t, int(inner_maxiter),
                    cycle)
                x64 = x64 + dx32.to(torch.float64)
                rounds += 1
                iters += it + 1
                if float(abs(res_buf[it])) <= 0.5 * tol_abs:
                    break
            info = {"rounds": rounds, "inner_iterations": iters}
        else:
            raise ValueError(f"unknown solve_mp method {method!r}")
        if return_info:
            return x64, info
        return x64
