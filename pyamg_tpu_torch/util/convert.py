"""Build a solver from plain numpy arrays: the AMG analogue of loading
weights.

A hierarchy built elsewhere (for instance by the JAX package, exported with
``np.asarray``) comes in as one dict per level, so that its cycle and solve
can run, and be compared, with the setup factored out:

``{"A": {"diags": (k, n) array, "offsets": ints, "shape": (n, m)},``
`` "transfer": {"wmap": (n_fine,) array, "fine_grid": ints, "block": ints,``
``              "S": DIA dict or None, "SH": DIA dict or None,``
``              "degree": int},                 # every level but the last``
`` "presmoother": smoother dict, "postsmoother": smoother dict}``

where a smoother dict holds ``kind`` ("none", "jacobi", "polynomial" or
"chebyshev"), ``iterations``, ``omega``, ``dinv`` (array or None) and
``coefficients``.  ``coarse`` is the coarsest level's dense pseudoinverse.

:func:`ell_hierarchy_from_numpy` does the same for the padded-ELL
hierarchies of the general device setup (``parallel.setup``):

``{"A": ELL dict, "P": ELL dict, "R": ELL dict,   # P, R: all but the last``
`` "presmoother": smoother dict, "postsmoother": smoother dict}``

where an ELL dict holds ``data``, ``cols``, ``row_nnz`` and ``shape``, and a
smoother dict may also hold ``sweep`` and ``color_masks`` (the multicolor
Gauss-Seidel smoother); with the padded ``sizes``, the unpadded size
``n_orig`` of level 0 and the padded ``coarse`` pseudoinverse.
"""

from __future__ import annotations

import numpy as np
import torch

from ..multilevel import Level, MultilevelSolver
from ..parallel.sharding import ShardedSolver
from ..relaxation.device import SmootherData
from ..sparse import (ComposedOp, GridPoolOp, GridRepeatOp, SparseDIA,
                      SparseELL)
from .utils import numpy_dtype, torch_dtype

__all__ = ["hierarchy_from_numpy", "ell_hierarchy_from_numpy"]


def _smoother(s, tensor):
    """SmootherData from a smoother dict (layout in the module
    docstring)."""
    def opt(key):
        return None if s.get(key) is None else tensor(s[key])

    return SmootherData(kind=s["kind"], iterations=int(s.get("iterations", 1)),
                        sweep=s.get("sweep", "forward"),
                        omega=float(s.get("omega", 1.0)), dinv=opt("dinv"),
                        color_masks=opt("color_masks"),
                        coefficients=tuple(
                            float(c) for c in s.get("coefficients", ())))


def hierarchy_from_numpy(levels, coarse, device, dtype):
    """A :class:`MultilevelSolver` on ``device`` whose operators, smoother
    state and coarse pseudoinverse are ``dtype`` tensors made from the
    numpy arrays in ``levels`` and ``coarse`` (layout in the module
    docstring)."""
    npdt = numpy_dtype(dtype)

    def tensor(a):
        return torch.as_tensor(np.array(a, dtype=npdt), device=device)

    def dia(d):
        return SparseDIA(tensor(d["diags"]), d["offsets"], d["shape"])

    out = []
    for spec in levels:
        lvl = Level(A=dia(spec["A"]))
        if "transfer" in spec:
            t = spec["transfer"]
            n_f, n_c = spec["A"]["shape"][0], int(np.prod(
                [-(-g // b) for g, b in zip(t["fine_grid"], t["block"])]))
            wmap = tensor(t["wmap"])
            T = GridRepeatOp(wmap, t["fine_grid"], t["block"], (n_f, n_c))
            Tt = GridPoolOp(wmap, t["fine_grid"], t["block"], (n_c, n_f),
                            conj=False)
            degree = int(t.get("degree", 0))
            if degree == 0 or t.get("S") is None:
                lvl.P, lvl.R = T, Tt
            else:
                S, SH = dia(t["S"]), dia(t["SH"])
                lvl.P = ComposedOp([S] * degree + [T], (n_f, n_c))
                lvl.R = ComposedOp([Tt] + [SH] * degree, (n_c, n_f))
            lvl.presmoother = _smoother(spec["presmoother"], tensor)
            lvl.postsmoother = _smoother(spec["postsmoother"], tensor)
        out.append(lvl)
    ml = MultilevelSolver(out, device=device)
    ml._op_dtype = torch_dtype(dtype)
    ml._coarse_mat = tensor(coarse)
    return ml


def ell_hierarchy_from_numpy(levels, sizes, n_orig, coarse, device, dtype):
    """A :class:`~pyamg_tpu_torch.parallel.ShardedSolver` on ``device``
    whose padded-ELL operators, smoother state and padded coarse
    pseudoinverse are ``dtype`` tensors made from numpy arrays (layout in
    the module docstring)."""
    npdt = numpy_dtype(dtype)

    def tensor(a):
        return torch.as_tensor(np.array(a, dtype=npdt), device=device)

    def ell(d):
        return SparseELL(
            tensor(d["data"]),
            torch.as_tensor(np.array(d["cols"], dtype=np.int32),
                            device=device),
            torch.as_tensor(np.array(d["row_nnz"], dtype=np.int32),
                            device=device), d["shape"])

    out = []
    for spec in levels:
        lvl = Level(A=ell(spec["A"]))
        if "P" in spec:
            lvl.P, lvl.R = ell(spec["P"]), ell(spec["R"])
        lvl.presmoother = _smoother(spec["presmoother"], tensor)
        lvl.postsmoother = _smoother(spec["postsmoother"], tensor)
        out.append(lvl)
    return ShardedSolver.from_sharded_levels(out, sizes, n_orig, device,
                                             coarse=tensor(coarse))
