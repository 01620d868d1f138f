"""Multigrid hierarchy runtime: levels, the cycles, the coarse solvers and
the solve entry points.

Port of ``pyamg_tpu/multilevel.py``.  The JAX package compiles each solve
into one XLA program; here the cycle is plain eager PyTorch on the
hierarchy's device, every DIA matvec a launch of the hand-written kernel,
and the Krylov loop reads one scalar per iteration for its stopping test.
The cycle only needs each level's operators to have a ``matvec``: DIA,
dense, grid and embedded operators, or padded-ELL operators with a coarse
pseudoinverse padded to the coarsest level's padded size
(``parallel.sharding.ShardedSolver``).  A level may carry a ``layout``
(``parallel.mesh.Layout``): its vectors are then this rank's rows of a
vector row-sharded over a mesh of ranks, or the whole vector on every
rank, and the level's inner products, coarse solve and public vectors go
through it; the entry points take and return whole vectors on every
rank.  V, W, F and AMLI cycles; dense
(pinv, lu, cholesky, splu), host-iterative and callable coarse solvers;
stand-alone cycling, every Krylov method of ``krylov`` as accelerator, the
mixed-precision ``solve_mp``, and ``MultilevelSolverSet`` (several
hierarchies combined into one preconditioner).
"""

from __future__ import annotations

import functools
import inspect
from typing import List

import numpy as np
import torch

from .krylov._cg import cg_core
from .krylov._cgs_family import (bicgstab_core, cgne_core, cgnr_core,
                                 cr_core, minimal_residual_core,
                                 steepest_descent_core)
from .krylov._common import finalize, norm, real_dtype
from .krylov._gmres import gmres_core, restart_loop, restart_start
from .relaxation.device import apply_smoother
from .util import profiling
from .util.utils import numpy_dtype, torch_dtype, unpack_arg

__all__ = ["Level", "MultilevelSolver", "MultilevelSolverSet",
           "coarse_grid_solver", "multilevel_solver",
           "multilevel_solver_set"]

_DENSE_COARSE_NAMES = ("pinv", "pinv2", "cholesky", "lu", "splu")
_RELAX_COARSE_NAMES = ("jacobi", "gauss_seidel", "block_jacobi")
_KRYLOV_COARSE_NAMES = ("cg", "gmres", "bicgstab")
_CYCLES = ("V", "W", "F", "AMLI")


class Level:
    """One level of the hierarchy: the device operators ``A``, ``P``, ``R``
    and smoothers, the host CSR twins the setup built them from, and setup
    byproducts kept for inspection.  A blocked level also records its dofs
    per node (``blocksize``: the BSR blocksize of the input at level 0, the
    candidate count K below) and ``A_bsr``, the BSR twin of ``A_csr`` (None
    on a scalar level); host-side fields, which ``astype`` and the coarse
    solver leave as they are."""

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
            with profiling.span("host_A", rows=self.A.shape[0]):
                self.A_csr = self.A.to_scipy()
        return self.A_csr


def _build_coarse_state(A_csr, name, kwargs=None, dtype=None, *, device):
    """Factorize the coarsest operator once on the host; returns ``(kind,
    state)``, ``state`` a tuple of small tensors on ``device`` that
    :func:`_apply_coarse` consumes inside the cycle.

    ``pinv``/``pinv2`` are dense pseudoinverses, ``lu`` a dense LU
    factorization, ``cholesky`` a dense Cholesky factorization (raises on a
    coarse operator that is not positive definite), and ``splu`` removes
    exactly-zero columns and rows and solves through the triangular
    factors of the sparse LU."""
    import scipy.linalg as sla
    import scipy.sparse.linalg as spla

    kwargs = kwargs or {}
    npdt = numpy_dtype(dtype)

    def dev(a):
        a = np.asarray(a)
        if npdt is not None and np.issubdtype(a.dtype, np.inexact):
            a = a.astype(npdt)
        return torch.as_tensor(a, device=device)

    if name in ("pinv", "pinv2"):
        return "dense", (dev(np.linalg.pinv(A_csr.toarray())),)
    if name == "lu":
        lu, piv = sla.lu_factor(A_csr.toarray(), **kwargs)
        # LAPACK's pivots, as torch takes them: int32, counted from 1
        return "lu", (dev(lu), dev(piv.astype(np.int32) + 1))
    if name == "cholesky":
        c, _low = sla.cho_factor(A_csr.toarray(), lower=True, **kwargs)
        return "chol", (dev(np.tril(c)),)
    if name == "splu":
        Acsc = A_csr.tocsc().copy()
        Acsc.eliminate_zeros()
        keep = np.flatnonzero(np.diff(Acsc.indptr))   # columns with entries
        if keep.size < Acsc.shape[0]:
            Acsc = Acsc[keep][:, keep].tocsc()
        f = spla.splu(Acsc, **kwargs)
        return "splu", (dev(f.L.toarray()), dev(f.U.toarray()),
                        dev(np.argsort(f.perm_r).astype(np.int64)),
                        dev(f.perm_c.astype(np.int64)),
                        dev(keep.astype(np.int64)))
    raise ValueError(f"not a dense/factorized coarse solver: {name!r}")


def _apply_coarse(kind, state, b):
    """The coarse solve from a factorization state, on the state's
    device, in the state's dtype; returns b's dtype."""
    if kind == "dense":
        return (state[0] @ b.to(state[0].dtype)).to(b.dtype)
    rhs = b.to(state[0].dtype)[:, None]
    if kind == "lu":
        return torch.linalg.lu_solve(state[0], state[1], rhs)[:, 0].to(b.dtype)
    if kind == "chol":
        return torch.cholesky_solve(rhs, state[0], upper=False)[:, 0] \
            .to(b.dtype)
    if kind == "splu":
        L, U, pr_inv, pc, keep = state
        y = torch.linalg.solve_triangular(L, rhs[keep][pr_inv], upper=False,
                                          unitriangular=True)
        w = torch.linalg.solve_triangular(U, y, upper=True)[:, 0]
        out = torch.zeros_like(b)
        out[keep] = w[pc].to(b.dtype)
        return out
    raise ValueError(f"unknown coarse state kind {kind!r}")


def _scipy_krylov(fn, A, b, tol, maxiter):
    """One scipy Krylov solve; the tolerance's keyword is ``rtol`` in
    current scipy and ``tol`` in older ones."""
    key = "rtol" if "rtol" in inspect.signature(fn).parameters else "tol"
    x, _info = fn(A, b, maxiter=maxiter, **{key: tol})
    return x


class _CoarseSolver:
    """A coarse-grid solver by name or callable; see
    :func:`coarse_grid_solver`."""

    def __init__(self, solver):
        self.solver, self.kwargs = unpack_arg(solver)
        self.name = "callable" if callable(self.solver) else self.solver
        if self.name not in ("callable",) + _DENSE_COARSE_NAMES \
                + _RELAX_COARSE_NAMES + _KRYLOV_COARSE_NAMES:
            raise ValueError(f"unknown coarse solver {self.name!r}")

    def prepare(self, A_csr, dtype=None, *, device, dense=None):
        """``f(b) -> x`` solving ``A x = b`` for tensors on ``device``.
        The dense solvers factorize once here, on the host, and hold their
        factors on ``device`` in ``dtype``; the iterative and callable ones
        take b to the host at every call.  ``dense``: an inverse of A built
        already (a tensor on ``device``), applied in place of any of them."""
        kwargs = self.kwargs
        if dense is not None:
            return lambda b: _apply_coarse("dense", (dense,), b)
        if self.name in _DENSE_COARSE_NAMES:
            kind, state = _build_coarse_state(A_csr, self.name, kwargs,
                                              dtype, device=device)
            return lambda b: _apply_coarse(kind, state, b)

        if self.name == "callable":
            def host(b):
                return self.solver(A_csr, b, **kwargs)
        elif self.name in _RELAX_COARSE_NAMES:
            from .relaxation import relaxation as rel

            def host(b):
                x = np.zeros_like(b)
                getattr(rel, self.name)(
                    A_csr, x, b, iterations=kwargs.get("iterations", 10))
                return x
        else:
            import scipy.sparse.linalg as spla

            def host(b):
                return _scipy_krylov(getattr(spla, self.name), A_csr, b,
                                     kwargs.get("tol", 1e-12),
                                     kwargs.get("maxiter", None))

        def fn(b):
            x = host(profiling.read_back(b, "coarse.host"))
            return torch.as_tensor(np.asarray(x), device=b.device) \
                .to(b.dtype)
        return fn

    def __call__(self, A_csr, b):
        """Solve ``A x = b`` for a tensor b, on b's device."""
        return self.prepare(A_csr, device=b.device)(b)


def coarse_grid_solver(solver):
    """A coarse-grid solver: ``solver(A_csr, b)`` solves for a tensor b, and
    ``solver.prepare(A_csr, dtype, device=...)`` returns the ``f(b)`` that
    the cycle calls.

    ``solver``: ``pinv``/``pinv2``, ``lu``, ``cholesky``, ``splu`` (dense
    factors held on the device), ``jacobi``, ``gauss_seidel``,
    ``block_jacobi``, ``cg``, ``gmres``, ``bicgstab`` (run on the host), a
    ``(name, kwargs)`` pair, or a callable ``f(A_csr, b_numpy, **kwargs)``.

    Examples
    --------
    >>> import torch
    >>> from pyamg_tpu_torch.gallery import poisson
    >>> A = poisson((5, 5), format='csr')
    >>> b = torch.ones(25, dtype=torch.float64)
    >>> x = coarse_grid_solver("lu")(A, b)
    >>> bool(abs(A @ x.numpy() - 1).max() < 1e-12)
    True
    """
    return _CoarseSolver(solver)


class MultilevelSolver:
    """Multigrid hierarchy and its cycle, on one torch device.

    Examples
    --------
    >>> import numpy as np
    >>> from pyamg_tpu_torch.gallery import poisson
    >>> from pyamg_tpu_torch import smoothed_aggregation_solver
    >>> A = poisson((32, 32), format='csr')
    >>> ml = smoothed_aggregation_solver(A, max_coarse=50, device="cpu")
    >>> b = np.ones(A.shape[0])
    >>> res = []
    >>> x = ml.solve(b, tol=1e-8, residuals=res)
    >>> res[-1] < 1e-8 * res[0]
    True
    """

    def __init__(self, levels: List[Level], coarse_solver="pinv",
                 device="cuda"):
        self.levels = levels
        self.coarse_solver_spec = coarse_solver
        self._coarse_solver = coarse_grid_solver(coarse_solver)
        self.device = torch.device(device)
        self._coarse_mat = None     # a dense coarse inverse, set or built
        self._coarse_fn = None
        self._A64 = None
        self.symmetry = getattr(levels[0], "symmetry", "hermitian") \
            if levels else "hermitian"
        # the records of the constructor's spans and of the solves'
        # (util.profiling); a constructor that times itself puts its own
        self.span_log = profiling.SpanLog()

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

    def cycle_complexity(self, cycle="V"):
        """Approximate work of one cycle in units of the fine level's
        nnz."""
        cycle = str(cycle).upper()
        nnz = [lvl.nnz for lvl in self.levels]
        last = len(self.levels) - 2

        def work(level, kind):
            if len(self.levels) == 1:
                return nnz[0]
            if level == last:
                return 2 * nnz[level] + nnz[level + 1]
            if kind == "V":
                below = work(level + 1, "V")
            elif kind == "W":
                below = 2 * work(level + 1, "W")
            else:
                below = work(level + 1, "F") + work(level + 1, "V")
            return 2 * nnz[level] + below

        if cycle not in _CYCLES:
            raise TypeError(f"unrecognized cycle type {cycle!r}")
        return float(work(0, "W" if cycle == "AMLI" else cycle)) \
            / float(nnz[0])

    # -- cycle ------------------------------------------------------------
    def _coarse(self):
        """The dense inverse of the coarsest A that the ``pinv`` solver
        applies (or the one a loader set), on the device in the operators'
        dtype."""
        if self._coarse_mat is None:
            _kind, state = _build_coarse_state(
                self.levels[-1].host_A(), "pinv",
                dtype=getattr(self, "_op_dtype", None), device=self.device)
            self._coarse_mat = state[0]
        return self._coarse_mat

    def _layout(self, i):
        """Level i's layout over a mesh of ranks, or None."""
        return getattr(self.levels[i], "layout", None)

    def _dot(self, i):
        """The inner product of level i's vectors."""
        lay = self._layout(i)
        return torch.vdot if lay is None else lay.dot

    def _local(self, v):
        """This rank's part of a whole fine-level vector."""
        lay = self._layout(0)
        return v if lay is None else lay.local(v)

    def _full(self, v):
        """The whole fine-level vector from this rank's part."""
        lay = self._layout(0)
        return v if lay is None else lay.full(v)

    def _smooth(self, level, sm, x, b):
        """``sm``'s sweeps on ``level``: a ``SmootherData``, or an object
        with its own ``apply(A, x, b)`` (a sharded level's smoother that
        reads whole vectors)."""
        if sm is not None and hasattr(sm, "apply"):
            return sm.apply(level.A, x, b)
        return apply_smoother(sm, level.A, x, b)

    def _solve_coarse(self, b):
        """The coarse solve; on a sharded coarsest level the right-hand
        side is gathered, solved on every rank, and each keeps its rows."""
        with profiling.fine("coarse_solve"):
            lay = self._layout(-1)
            if lay is not None and lay.sharded:
                return lay.local(self._coarse_solve(lay.full(b)))
            return self._coarse_solve(b)

    def _coarse_solve(self, b):
        if self._coarse_fn is None:
            with profiling.span("coarse.prepare", into=self.span_log.setup):
                pinv = self._coarse_solver.name in ("pinv", "pinv2")
                self._coarse_fn = self._coarse_solver.prepare(
                    self.levels[-1].host_A(),
                    getattr(self, "_op_dtype", None), device=self.device,
                    dense=self._coarse() if pinv else self._coarse_mat)
        return self._coarse_fn(b)

    def _cycle(self, lvl, x, b, kind):
        """One cycle of ``kind`` from level ``lvl`` down, from ``x``."""
        with profiling.fine("cycle", level=lvl):
            levels = self.levels
            if lvl == len(levels) - 1:
                return self._solve_coarse(b)
            level = levels[lvl]
            A = level.A
            with profiling.fine("smooth", level=lvl, side="pre"):
                x = self._smooth(level, level.presmoother, x, b)
            bc = level.R.matvec(b - A.matvec(x))
            below = lvl + 1

            def descend(xc, rhs, kind):
                return self._cycle(below, xc, rhs, kind)

            if below == len(levels) - 1:
                xc = self._solve_coarse(bc)
            elif kind == "V":
                xc = descend(torch.zeros_like(bc), bc, "V")
            elif kind == "W":
                xc = descend(descend(torch.zeros_like(bc), bc, "W"), bc, "W")
            elif kind == "F":
                xc = descend(descend(torch.zeros_like(bc), bc, "F"), bc, "V")
            else:
                # AMLI: two coarse iterations along A-conjugate directions
                Ac = levels[below].A
                vdot = self._dot(below)

                def guard(d):
                    return torch.where(d == 0, 1, d)

                p0 = descend(torch.zeros_like(bc), bc, "AMLI")
                Ap0 = Ac.matvec(p0)
                p0Ap0 = guard(vdot(p0, Ap0))
                alpha0 = vdot(p0, bc) / p0Ap0
                xc = alpha0 * p0
                rc = bc - alpha0 * Ap0
                p1 = descend(torch.zeros_like(bc), rc, "AMLI")
                beta = vdot(p0, Ac.matvec(p1)) / p0Ap0
                p1 = p1 - beta * p0
                Ap1 = Ac.matvec(p1)
                alpha1 = vdot(p1, rc) / guard(vdot(p1, Ap1))
                xc = xc + alpha1 * p1
            x = x + level.P.matvec(xc)
            with profiling.fine("smooth", level=lvl, side="post"):
                return self._smooth(level, level.postsmoother, x, b)

    def cycle_fn(self, cycle="V"):
        """``f(x, b)``: one V, W, F or AMLI cycle from ``x`` for right-hand
        side ``b``."""
        kind = str(cycle).upper()
        if kind not in _CYCLES:
            raise TypeError(f"unrecognized cycle type {cycle!r}")
        return lambda x, b: self._cycle(0, x, b, kind)

    def aspreconditioner(self, cycle="V"):
        """One cycle from x = 0 as a scipy ``LinearOperator``: a numpy
        vector in gives a numpy vector out (each call copies it to the
        hierarchy's device and back), so scipy's solvers can take it as
        ``M``; a tensor in is a plain call that returns a tensor."""
        from scipy.sparse.linalg import LinearOperator

        cyc = self.cycle_fn(cycle)
        op_dtype = self.levels[0].A.dtype
        as_tensor, local, full = self._as_tensor, self._local, self._full

        def fn(b):
            b_d = local(as_tensor(b, op_dtype))
            return full(cyc(torch.zeros_like(b_d), b_d))

        class _CyclePreconditioner(LinearOperator):
            def _matvec(self, b):
                return profiling.read_back(fn(b), "aspreconditioner")

            def matvec(self, b):
                if isinstance(b, torch.Tensor):
                    return fn(b)
                return super().matvec(b)

        return _CyclePreconditioner(dtype=numpy_dtype(op_dtype),
                                    shape=self.levels[0].A.shape)

    def psolve(self, b):
        """One V-cycle from x = 0 on ``b``."""
        return self.aspreconditioner().matvec(b)

    # -- solves -----------------------------------------------------------
    def _as_tensor(self, v, dtype):
        if isinstance(v, torch.Tensor):
            return v.reshape(-1).to(device=self.device, dtype=dtype)
        return torch.as_tensor(np.ravel(np.asarray(v)), dtype=dtype,
                               device=self.device)

    def astype(self, dtype):
        """Cast every device operator and smoother to ``dtype`` in place
        (a float32 preconditioner from a float64 setup, say).  The host
        CSR matrices keep their dtype; the coarse solver is rebuilt from
        them in ``dtype`` at the next cycle."""
        dtype = torch_dtype(dtype)
        for lvl in self.levels:
            lvl.A = lvl.A.astype(dtype)
            if getattr(lvl, "P", None) is not None:
                lvl.P = lvl.P.astype(dtype)
                lvl.R = lvl.R.astype(dtype)
            if lvl.presmoother is not None:
                lvl.presmoother = lvl.presmoother.astype(dtype)
            if lvl.postsmoother is not None:
                lvl.postsmoother = lvl.postsmoother.astype(dtype)
        if self._coarse_mat is not None:
            # an inverse padded past the host matrix came from outside and
            # cannot be rebuilt here: cast it; else rebuild from the host
            n_host = self.levels[-1].host_A().shape[0]
            self._coarse_mat = self._coarse_mat.to(dtype) \
                if self._coarse_mat.shape[0] != n_host else None
        self._coarse_fn = None
        self._A64 = None
        self._op_dtype = dtype
        return self

    def _accel_core(self, accel, maxiter):
        """The Krylov core ``f(mv, pre, x, b, tol_t, maxiter, dot=)`` of a
        built-in accelerator name; GMRES restarts every 30 iterations, and
        ``cgnr``/``cgne`` apply A^H by :meth:`_with_rmatvec`."""
        if accel in _NE_ACCELS:
            rmv = self._with_rmatvec(self.levels[0].A).rmatvec
            core = cgnr_core if accel == "cgnr" else cgne_core
            return lambda mv, *args, **kw: core(mv, rmv, *args, **kw)
        n = self.levels[0].A.shape[0]
        cores = {
            "cg": cg_core,
            "bicgstab": bicgstab_core,
            "cr": cr_core,
            "steepest_descent": steepest_descent_core,
            "minimal_residual": minimal_residual_core,
            "gmres": functools.partial(gmres_core,
                                       restrt=min(30, maxiter), n=n),
            "fgmres": functools.partial(gmres_core, restrt=min(30, maxiter),
                                        flexible=True, n=n),
        }
        return cores[accel]

    def _run_accel(self, accel, b, x, tol_t, maxiter, cycle="V"):
        """One accelerated solve on the hierarchy's operator with one
        cycle per preconditioner application: ``(x, n_iters, res_buf)``."""
        A = self.levels[0].A
        cyc = self.cycle_fn(cycle)
        return self._accel_core(accel, maxiter)(
            A.matvec, lambda r: cyc(torch.zeros_like(r), r), x, b, tol_t,
            maxiter, dot=self._dot(0))

    def _with_rmatvec(self, A):
        """A with ``rmatvec`` for the normal-equation methods: the
        hierarchy's own matvec when it is Hermitian (or real symmetric),
        else a device operator of A^H built from the host CSR matrix."""
        if hasattr(A, "rmatvec"):
            return A
        if self.symmetry == "hermitian" or (self.symmetry == "symmetric"
                                            and not A.dtype.is_complex):
            rmv = A.matvec
        else:
            from .sparse.device_op import device_operator

            AH = self.levels[0].host_A().conjugate().T.tocsr()
            rmv = device_operator(AH, dtype=A.dtype,
                                  device=self.device).matvec
        return _WithRmatvec(A, rmv)

    def solve(self, b, x0=None, tol=1e-5, maxiter=100, cycle="V",
              accel=None, callback=None, residuals=None,
              return_residuals=False, return_info=False):
        """Solve A x = b to relative residual ``tol`` in the hierarchy's
        dtype, on its device.

        ``accel``: None for stand-alone cycling, the name of a method of
        :mod:`pyamg_tpu_torch.krylov` (``"cg"``, ``"gmres"``,
        ``"bicgstab"``, ``"fgmres"``, ``"cr"``, ``"cgnr"``, ...) or a
        callable with their signature, preconditioned by one cycle per
        iteration.  ``callback(x)`` is called with the iterate (a tensor on
        the device) after every cycle of a stand-alone solve, and as the
        Krylov function calls it in an accelerated one (once, with the
        result).  Returns ``x`` as a tensor on the hierarchy's device, with
        the residual history (a numpy array) when ``return_residuals``,
        else with ``info`` when ``return_info``.

        On a hierarchy sharded over ranks every rank calls it with the
        whole b and gets the whole x; ``callback`` gets the whole iterate,
        and ``accel`` is a name of a core above or ``"cgnr"``/``"cgne"``."""
        A = self.levels[0].A
        dtype = A.dtype
        dot = self._dot(0)
        b_d = self._local(self._as_tensor(b, dtype))
        x = torch.zeros_like(b_d) if x0 is None \
            else self._local(self._as_tensor(x0, dtype))
        maxiter = 100 if maxiter is None else int(maxiter)
        if return_residuals and residuals is None:
            residuals = []
        first = 0 if residuals is None else len(residuals)

        sharded = self._layout(0) is not None
        names = _CORE_ACCELS + _NE_ACCELS if sharded else _CORE_ACCELS
        if isinstance(accel, str) and accel in names \
                and (callback is None or sharded):
            normb = norm(b_d, dot)
            tol_t = profiling.read_back(
                tol * torch.where(normb == 0, 1, normb), "solve.tol")
            xk, it, res_buf = self._run_accel(accel, b_d, x, tol_t, maxiter,
                                              cycle)
            xk, info = finalize(self._full(xk), res_buf, it + 1, tol_t,
                                callback, residuals)
        elif sharded and accel is not None:
            raise ValueError(f"over several ranks, accel takes a name in "
                             f"{names}; got {accel!r}")
        elif accel is not None:
            from . import krylov

            kfn = accel if callable(accel) else getattr(krylov, accel)
            if accel in ("cgnr", "cgne"):
                A = self._with_rmatvec(A)
            cyc = self.cycle_fn(cycle)
            res_list = []
            xk, info = kfn(A, b_d, x0=x, tol=tol, maxiter=maxiter,
                           M=lambda r: cyc(torch.zeros_like(r), r),
                           callback=callback, residuals=res_list)
            if residuals is not None:
                residuals.extend(res_list)
            if not isinstance(xk, torch.Tensor):
                xk = self._as_tensor(xk, dtype)
        else:
            cyc = self.cycle_fn(cycle)
            normb = profiling.read_back(norm(b_d, dot), "solve.normb")
            tol_t = real_dtype(dtype).type(
                tol * (normb if normb != 0.0 else 1.0))
            res = [profiling.read_back(norm(b_d - A.matvec(x), dot),
                                       "solve.res")]
            it = 0
            while res[-1] > tol_t and it < maxiter:
                x = cyc(x, b_d)
                res.append(profiling.read_back(norm(b_d - A.matvec(x), dot),
                                               "solve.res"))
                it += 1
                if callback is not None:
                    callback(self._full(x))
            xk, info = finalize(self._full(x), res, it + 1, tol_t, None,
                                residuals)
        if return_residuals:
            return xk, np.asarray(residuals[first:])
        if return_info:
            return xk, info
        return xk

    def solve_mp(self, b, tol=1e-10, accel="cg", cycle="V",
                 inner_maxiter=40, max_rounds=6, inner_tol_factor=1e-6,
                 return_info=False, method="pcg"):
        """Solve A x = b to a float64 relative residual ``tol`` with the
        (float32) hierarchy as preconditioner.

        ``method="pcg"``: a float64 Krylov method -- ``accel`` one of
        ``"cg"``, ``"bicgstab"``, ``"gmres"``, ``"fgmres"`` -- in which
        each preconditioner application is one float32 cycle (r scaled to
        unit norm and cast down, the correction cast up and scaled back).
        Left-preconditioned GMRES tracks ``||M r||``: its true residual is
        checked at the end and the tracked tolerance tightened until it
        holds.  ``method="defect"``: iterative refinement -- per round, one
        float64 fine-grid residual and a float32 accelerated solve of the
        correction to ``inner_tol_factor`` times that residual (``accel``
        also ``"cr"``, ``"steepest_descent"`` or ``"minimal_residual"``).  A float64
        (or complex128) hierarchy forwards to :meth:`solve`.

        Returns ``x`` (float64 tensor; complex128 for a complex
        hierarchy), or ``(x, info)`` with ``info = {"rounds",
        "inner_iterations", "host_syncs"}`` when ``return_info`` is set;
        in the defect method ``inner_iterations`` counts one more per
        round than the Krylov iterations (the round's starting residual),
        as the JAX package does, and ``host_syncs``, the device reads of
        the call (``util.profiling.read_back``), is 1 + ``rounds`` +
        ``inner_iterations`` with ``accel="cg"``.  Each call is a span
        ``solve_mp`` of ``span_log``; the first builds the float64
        operator (``solve_mp.operator64``) and the coarse solver
        (``coarse.prepare``), spans of its set-up part."""
        with profiling.span("solve_mp", into=self.span_log.solves) as sp:
            syncs = profiling.counters["host_syncs"]
            x, info = self._solve_mp(b, tol, accel, cycle, inner_maxiter,
                                     max_rounds, inner_tol_factor, method)
            info["host_syncs"] = profiling.counters["host_syncs"] - syncs
            sp.attrs.update(info)
        if return_info:
            return x, info
        return x

    def _solve_mp(self, b, tol, accel, cycle, inner_maxiter, max_rounds,
                  inner_tol_factor, method):
        """:meth:`solve_mp`'s ``(x, info)``."""
        op_dt = self.levels[0].A.dtype
        if op_dt in (torch.float64, torch.complex128):
            res = []
            x = self.solve(b, tol=tol, accel=accel, cycle=cycle,
                           maxiter=inner_maxiter * max_rounds, residuals=res)
            return x, {"rounds": 1, "inner_iterations": max(len(res) - 1, 0)}
        # the defect method runs any accelerator whose core takes the
        # hierarchy directly; the float64 Krylov loop has these four
        known = _CORE_ACCELS if method == "defect" else _MP_ACCELS
        if accel not in known:
            raise ValueError(f"solve_mp(method={method!r}) takes accel in "
                             f"{known}; got {accel!r}")
        dt64 = torch.complex128 if op_dt.is_complex else torch.float64

        dot = self._dot(0)
        if self._A64 is None:
            with profiling.span("solve_mp.operator64",
                                into=self.span_log.setup):
                if self._layout(0) is not None:
                    # a sharded fine operator: its own values, in float64
                    self._A64 = self.levels[0].A.astype(dt64)
                else:
                    from .sparse.device_op import device_operator

                    self._A64 = device_operator(self.levels[0].host_A(),
                                                dtype=dt64,
                                                device=self.device)
        A64 = self._A64
        b64 = self._local(self._as_tensor(b, dt64))
        normb = profiling.read_back(norm(b64, dot), "solve_mp.normb")
        tol_abs = tol * (normb if normb != 0 else 1.0)
        cyc = self.cycle_fn(cycle)

        if method == "pcg":
            def pre(r64):
                # scale to O(1) before the f32 cast: late-stage residuals
                # (~1e-10*||b||) underflow f32 otherwise
                s = norm(r64, dot)
                s = torch.where(s == 0, 1, s)
                r32 = (r64 / s).to(op_dt)
                return cyc(torch.zeros_like(r32), r32).to(dt64) * s

            maxiter = int(inner_maxiter) * int(max_rounds)
            x0 = torch.zeros_like(b64)
            rounds = 1
            if accel in ("gmres", "fgmres"):
                restrt = min(30, maxiter, A64.shape[0])
                loop = functools.partial(
                    restart_loop, A64.matvec, pre, b64, maxiter=maxiter,
                    restrt=restrt, max_outer=max(1, -(-maxiter // restrt)),
                    flexible=accel == "fgmres", dot=dot)
                carry = loop(restart_start(A64.matvec, x0, b64, maxiter, dot),
                             tol_abs)
                for _ in range(4 if accel == "gmres" else 0):
                    if carry[1] >= maxiter:
                        break
                    r_true = profiling.read_back(
                        norm(b64 - A64.matvec(carry[0]), dot),
                        "solve_mp.true_res")
                    if r_true <= tol_abs or r_true == 0:
                        break
                    ratio = max(carry[-1] / r_true, 1e-12)
                    carry = loop(carry, tol_abs * ratio * 0.3)
                    rounds += 1
                x64, it = carry[0], carry[1]
            else:
                core = cg_core if accel == "cg" else bicgstab_core
                x64, it, _ = core(A64.matvec, pre, x0, b64, tol_abs, maxiter,
                                  dot=dot)
            info = {"rounds": rounds, "inner_iterations": it}
        elif method == "defect":
            x64 = torch.zeros_like(b64)
            rounds, iters = 0, 0
            while rounds < int(max_rounds):
                r64 = b64 - A64.matvec(x64)
                r32 = r64.to(op_dt)
                tol_t = float(inner_tol_factor) * profiling.read_back(
                    norm(r64, dot), "solve_mp.round_res")
                dx32, it, res_buf = self._run_accel(
                    accel, r32, torch.zeros_like(r32), tol_t,
                    int(inner_maxiter), cycle)
                x64 = x64 + dx32.to(dt64)
                rounds += 1
                iters += it + 1
                if float(abs(res_buf[min(it, len(res_buf) - 1)])) \
                        <= 0.5 * tol_abs:
                    break
            info = {"rounds": rounds, "inner_iterations": iters}
        else:
            raise ValueError(f"unknown solve_mp method {method!r}")
        return self._full(x64), info


# accelerators that run their core on the hierarchy directly; the others go
# through the public Krylov function
_NE_ACCELS = ("cgnr", "cgne")
_CORE_ACCELS = ("cg", "bicgstab", "gmres", "fgmres", "cr",
                "steepest_descent", "minimal_residual")
_MP_ACCELS = ("cg", "bicgstab", "gmres", "fgmres")


class _WithRmatvec:
    """An operator with ``rmatvec`` (v -> A^H v) beside its ``matvec``."""

    def __init__(self, op, rmatvec):
        self.matvec = op.matvec
        self.rmatvec = rmatvec
        self.shape = op.shape
        self.dtype = op.dtype


# reference-compatible lowercase alias
multilevel_solver = MultilevelSolver


class MultilevelSolverSet:
    """Several hierarchies of one operator combined into one
    preconditioner: ``mode="additive"`` sums their cycles,
    ``"multiplicative"`` applies them one after another on the running
    residual."""

    def __init__(self, solvers: List[MultilevelSolver],
                 mode="multiplicative"):
        if not solvers:
            raise ValueError("need at least one solver")
        self.solvers = list(solvers)
        self.mode = mode

    def add_hierarchy(self, solver):
        self.solvers.append(solver)

    def remove_hierarchy(self, index):
        del self.solvers[index]

    def replace_hierarchy(self, solver, index):
        self.solvers[index] = solver

    def _combined(self, cycle):
        """``r -> M r`` on tensors: the solvers' cycles from x = 0, combined
        by ``self.mode``."""
        fns = [s.cycle_fn(cycle) for s in self.solvers]
        A = self.solvers[0].levels[0].A

        def M(r):
            if self.mode == "additive":
                return sum(fn(torch.zeros_like(r), r) for fn in fns)
            y = torch.zeros_like(r)
            for fn in fns:
                rr = r - A.matvec(y)
                y = y + fn(torch.zeros_like(rr), rr)
            return y
        return M

    def aspreconditioner(self, cycle="V"):
        """The combined cycle as a scipy ``LinearOperator`` (numpy in,
        numpy out)."""
        from scipy.sparse.linalg import LinearOperator

        first = self.solvers[0]
        A = first.levels[0].A
        M = self._combined(cycle)

        def matvec(b):
            return profiling.read_back(M(first._as_tensor(b, A.dtype)),
                                       "aspreconditioner")

        return LinearOperator(A.shape, matvec, dtype=numpy_dtype(A.dtype))

    def solve(self, b, x0=None, tol=1e-5, maxiter=100, cycle="V",
              accel="cg", residuals=None):
        """Solve A x = b with the Krylov method ``accel`` (a name of
        :mod:`pyamg_tpu_torch.krylov` or a callable) preconditioned by the
        combined cycle; returns x as a tensor on the first solver's
        device."""
        from . import krylov

        first = self.solvers[0]
        A = first.levels[0].A
        b_d = first._as_tensor(b, A.dtype)
        x = torch.zeros_like(b_d) if x0 is None \
            else first._as_tensor(x0, A.dtype)
        kfn = getattr(krylov, accel) if isinstance(accel, str) else accel
        res_list = []
        xk, _info = kfn(A, b_d, x0=x, tol=tol, maxiter=maxiter,
                        M=self._combined(cycle), residuals=res_list)
        if residuals is not None:
            residuals.extend(res_list)
        return xk


multilevel_solver_set = MultilevelSolverSet
