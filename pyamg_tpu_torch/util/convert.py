"""Build a solver from plain numpy arrays: the AMG analogue of loading
weights.

A hierarchy built elsewhere (for instance by the JAX package, exported with
``np.asarray``) comes in as one dict per level, so that its cycle and solve
can run, and be compared, with the setup factored out:

``{"A": operator dict,``
`` "transfer": {"wmap": (n_fine,) array, "fine_grid": ints, "block": ints,``
``              "S": DIA dict or None, "SH": DIA dict or None,``
``              "degree": int},            # a structured level's P and R, or``
`` "P": operator dict, "R": operator dict, # any other level's, or``
`` "splitting": (n_fine,) 0/1 array,       # a classical level's host``
`` "P_csr": scipy matrix, "R_csr": scipy matrix,   # transfers``
`` "presmoother": smoother dict, "postsmoother": smoother dict}``

(the last level has A alone).  An operator dict is told by its keys:

* DIA: ``diags`` (k, n), ``offsets``, ``shape``;
* padded ELL: ``data``, ``cols``, ``row_nnz``, ``shape``;
* dense: ``mat``, ``shape``;
* fine-embedded DIA transfer: ``dia`` (a DIA dict), ``cpts`` (the fine
  position of each coarse dof), ``shape``, and ``restrict`` true for the
  restriction;
* grid transfer: ``wmap``, ``fine_grid``, ``block``, ``shape``, and
  ``pool`` true for the restriction (``GridPoolOp``, else
  ``GridRepeatOp``);
* composition: ``ops`` (operator dicts, applied right to left) and
  ``shape`` -- the P and R of a device-built structured level
  (``structured_sa_setup``) are DIA and grid dicts composed.

A classical level's transfers are built from its host matrices as
``ruge_stuben_solver`` builds them: the C-point embedding in DIA where it
is banded, else ``device_operator``'s form.

A smoother dict holds ``kind`` and whichever of ``iterations``, ``sweep``,
``omega``, ``coefficients``, ``blocksize``, ``grid``, ``line_axis`` and the
arrays ``dinv``, ``color_masks``, ``block_dinv``, ``color_rows``,
``color_cols``, ``color_data``, ``line_tri`` (3-D, or 5-D for the
block-tridiagonal lines of a level of q dofs a node), ``subdomain_idx``
and ``subdomain_inv`` (Schwarz: each dof's correction slots are derived
from the subdomain table) that kind uses.  ``coarse`` is the coarsest
level's dense pseudoinverse.

:func:`ell_hierarchy_from_numpy` does the same for the padded-ELL
hierarchies of the general device setup (``parallel.setup``): every
operator an ELL dict, with the padded ``sizes``, the unpadded size
``n_orig`` of level 0 and the padded ``coarse`` pseudoinverse.
"""

from __future__ import annotations

import numpy as np
import torch

from ..classical.classical import _device_transfers
from ..multilevel import Level, MultilevelSolver
from ..parallel.mesh import one_rank_mesh
from ..parallel.sharding import ShardedSolver
from ..relaxation.device import SmootherData
from ..relaxation.smoothing import schwarz_dof_slots
from ..sparse import (ComposedOp, CptProlongOp, CptRestrictOp, DenseOp,
                      GridPoolOp, GridRepeatOp, SparseDIA, SparseELL)
from .utils import numpy_dtype, torch_dtype

__all__ = ["hierarchy_from_numpy", "ell_hierarchy_from_numpy"]


def _loaders(device, dtype):
    """``(tensor, index)``: numpy array to a ``dtype`` tensor, and to an
    int64 index tensor, on ``device``."""
    npdt = numpy_dtype(dtype)

    def tensor(a):
        return torch.as_tensor(np.array(a, dtype=npdt), device=device)

    def index(a, dt=np.int64):
        return torch.as_tensor(np.array(a, dtype=dt), device=device)

    return tensor, index


def _smoother(s, n, tensor, index):
    """SmootherData of a level of n dofs from a smoother dict (layout in
    the module docstring)."""
    def opt(key, load=tensor):
        return None if s.get(key) is None else load(s[key])

    slots = weight = None
    if s.get("subdomain_idx") is not None:
        slots, weight = schwarz_dof_slots(np.asarray(s["subdomain_idx"]), n)
    return SmootherData(kind=s["kind"], iterations=int(s.get("iterations", 1)),
                        sweep=s.get("sweep", "forward"),
                        omega=float(s.get("omega", 1.0)), dinv=opt("dinv"),
                        color_masks=opt("color_masks"),
                        coefficients=tuple(
                            float(c) for c in s.get("coefficients", ())),
                        block_dinv=opt("block_dinv"),
                        blocksize=int(s.get("blocksize", 1)),
                        color_rows=opt("color_rows", index),
                        color_cols=opt("color_cols", index),
                        color_data=opt("color_data"),
                        line_tri=opt("line_tri"),
                        grid=None if s.get("grid") is None
                        else tuple(int(g) for g in s["grid"]),
                        line_axis=int(s.get("line_axis", 0)),
                        subdomain_idx=opt("subdomain_idx", index),
                        subdomain_inv=opt("subdomain_inv"),
                        dof_slots=None if slots is None else index(slots),
                        dof_weight=None if weight is None
                        else tensor(weight))


def _operator(d, tensor, index):
    """The operator of an operator dict (layout in the module
    docstring)."""
    if "diags" in d:
        return SparseDIA(tensor(d["diags"]), d["offsets"], d["shape"])
    if "row_nnz" in d:
        return SparseELL(tensor(d["data"]), index(d["cols"], np.int32),
                         index(d["row_nnz"], np.int32), d["shape"])
    if "mat" in d:
        return DenseOp(tensor(d["mat"]), d["shape"])
    if "cpts" in d:
        cls = CptRestrictOp if d.get("restrict") else CptProlongOp
        return cls(_operator(d["dia"], tensor, index), index(d["cpts"]),
                   d["shape"])
    if "wmap" in d:
        if d.get("pool"):
            return GridPoolOp(tensor(d["wmap"]), d["fine_grid"], d["block"],
                              d["shape"], conj=False)
        return GridRepeatOp(tensor(d["wmap"]), d["fine_grid"], d["block"],
                            d["shape"])
    if "ops" in d:
        return ComposedOp([_operator(o, tensor, index) for o in d["ops"]],
                          d["shape"])
    raise ValueError(f"not an operator dict: keys {sorted(d)}")


def hierarchy_from_numpy(levels, coarse, device, dtype):
    """A :class:`MultilevelSolver` on ``device`` whose operators, smoother
    state and coarse pseudoinverse are ``dtype`` tensors made from the
    numpy arrays in ``levels`` and ``coarse`` (layout in the module
    docstring)."""
    tensor, index = _loaders(device, dtype)

    out = []
    for spec in levels:
        lvl = Level(A=_operator(spec["A"], tensor, index))
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
                S = _operator(t["S"], tensor, index)
                SH = _operator(t["SH"], tensor, index)
                lvl.P = ComposedOp([S] * degree + [T], (n_f, n_c))
                lvl.R = ComposedOp([Tt] + [SH] * degree, (n_c, n_f))
        elif "P" in spec:
            lvl.P = _operator(spec["P"], tensor, index)
            lvl.R = _operator(spec["R"], tensor, index)
        elif "splitting" in spec:
            lvl.P, lvl.R = _device_transfers(
                spec["P_csr"], spec["R_csr"], spec["splitting"], dtype,
                device)
        if "presmoother" in spec:
            n = lvl.A.shape[0]
            lvl.presmoother = _smoother(spec["presmoother"], n, tensor, index)
            lvl.postsmoother = _smoother(spec["postsmoother"], n, tensor,
                                         index)
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
    tensor, index = _loaders(device, dtype)

    out = []
    for spec in levels:
        lvl = Level(A=_operator(spec["A"], tensor, index))
        if "P" in spec:
            lvl.P = _operator(spec["P"], tensor, index)
            lvl.R = _operator(spec["R"], tensor, index)
        n = lvl.A.shape[0]
        lvl.presmoother = _smoother(spec["presmoother"], n, tensor, index)
        lvl.postsmoother = _smoother(spec["postsmoother"], n, tensor, index)
        out.append(lvl)
    return ShardedSolver.from_sharded_levels(out, sizes,
                                             one_rank_mesh(device), None,
                                             n_orig, coarse=tensor(coarse))
