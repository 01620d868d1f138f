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
"""

from __future__ import annotations

import numpy as np
import torch

from ..multilevel import Level, MultilevelSolver
from ..relaxation.device import SmootherData
from ..sparse import ComposedOp, GridPoolOp, GridRepeatOp, SparseDIA
from .utils import numpy_dtype, torch_dtype

__all__ = ["hierarchy_from_numpy"]


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

    def smoother(s):
        dinv = s.get("dinv")
        return SmootherData(kind=s["kind"],
                            iterations=int(s.get("iterations", 1)),
                            omega=float(s.get("omega", 1.0)),
                            dinv=None if dinv is None else tensor(dinv),
                            coefficients=tuple(
                                float(c) for c in s.get("coefficients", ())))

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
            lvl.presmoother = smoother(spec["presmoother"])
            lvl.postsmoother = smoother(spec["postsmoother"])
        out.append(lvl)
    ml = MultilevelSolver(out, device=device)
    ml._op_dtype = torch_dtype(dtype)
    ml._coarse_mat = tensor(coarse)
    return ml
