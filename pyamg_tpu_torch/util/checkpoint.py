"""Hierarchy checkpoint and resume.

A hierarchy is its levels' host CSR matrices plus its configuration, so it
serializes to one ``.npz`` file and reloads into a working solver: the
device operators and smoothers are rebuilt on load.  The file layout and
its JSON metadata are the JAX package's (``pyamg_tpu/util/checkpoint.py``),
so a file written by either package loads in the other.
"""

from __future__ import annotations

import json

import numpy as np
import scipy.sparse as sp
import torch

__all__ = ["save_hierarchy", "load_hierarchy"]


def _pack_csr(prefix, M, store):
    store[f"{prefix}_data"] = M.data
    store[f"{prefix}_indices"] = M.indices
    store[f"{prefix}_indptr"] = M.indptr
    store[f"{prefix}_shape"] = np.asarray(M.shape)


def _unpack_csr(prefix, store):
    return sp.csr_matrix(
        (store[f"{prefix}_data"], store[f"{prefix}_indices"],
         store[f"{prefix}_indptr"]),
        shape=tuple(store[f"{prefix}_shape"]))


def save_hierarchy(ml, path):
    """Serialize a MultilevelSolver to ``path`` (.npz).  The host matrices
    of a device-built level (``structured_sa_setup``'s, which has none) are
    made from its device operators first, and kept on the level."""
    spec = ml.coarse_solver_spec
    store = {}
    meta = {
        "n_levels": len(ml.levels),
        "coarse_solver": spec if isinstance(spec, (str, list))
        else list(spec) if isinstance(spec, tuple) else "pinv",
        "smoothers": getattr(ml, "_smoother_config",
                             ("gauss_seidel", "gauss_seidel")),
        "grids": [list(getattr(lvl, "grid", None) or [])
                  for lvl in ml.levels],
        "blocksizes": [int(getattr(lvl, "blocksize", 1))
                       for lvl in ml.levels],
    }
    store["meta"] = np.frombuffer(
        json.dumps(meta, default=str).encode(), dtype=np.uint8)
    for i, lvl in enumerate(ml.levels):
        lvl.host_A()
        if not hasattr(lvl, "P_csr") and getattr(lvl, "P", None) is not None:
            lvl.P_csr = lvl.P.to_scipy()
            lvl.R_csr = lvl.R.to_scipy()
        _pack_csr(f"L{i}_A", lvl.A_csr, store)
        if hasattr(lvl, "P_csr"):
            _pack_csr(f"L{i}_P", lvl.P_csr, store)
            _pack_csr(f"L{i}_R", lvl.R_csr, store)
        if getattr(lvl, "B", None) is not None:
            B = lvl.B
            store[f"L{i}_B"] = B.cpu().numpy() if isinstance(
                B, torch.Tensor) else np.asarray(B)
    np.savez_compressed(path, **store)


def _norm(s):
    """A smoother option from its JSON form: ``[name, kwargs]`` pairs back
    to tuples, per-level lists kept."""
    if isinstance(s, list):
        if len(s) == 2 and isinstance(s[0], str):
            return (s[0], s[1])
        return [_norm(v) for v in s]
    return s


def load_hierarchy(path, device="cuda"):
    """Load a hierarchy saved by :func:`save_hierarchy` (by either
    package) into a working MultilevelSolver on ``device``: its operators
    are ``device_operator``'s forms of the saved matrices, in their dtype,
    and its smoothers the saved options (``change_smoothers``)."""
    from ..multilevel import Level, MultilevelSolver
    from ..relaxation.smoothing import change_smoothers
    from ..sparse import device_operator

    store = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(store["meta"]).decode())

    levels = []
    for i in range(meta["n_levels"]):
        lvl = Level(A_csr=_unpack_csr(f"L{i}_A", store),
                    blocksize=meta["blocksizes"][i])
        grid = meta["grids"][i]
        lvl.grid = tuple(grid) if grid else None
        if f"L{i}_P_data" in store:
            lvl.P_csr = _unpack_csr(f"L{i}_P", store)
            lvl.R_csr = _unpack_csr(f"L{i}_R", store)
        if f"L{i}_B" in store:
            lvl.B = store[f"L{i}_B"]
        lvl.A = device_operator(lvl.A_csr, device=device)
        if hasattr(lvl, "P_csr"):
            lvl.P = device_operator(lvl.P_csr, device=device)
            lvl.R = device_operator(lvl.R_csr, device=device)
        levels.append(lvl)

    cs = meta["coarse_solver"]
    if isinstance(cs, list):
        cs = (cs[0], cs[1]) if len(cs) == 2 else cs[0]
    ml = MultilevelSolver(levels, coarse_solver=cs, device=device)
    pre, post = meta["smoothers"]
    change_smoothers(ml, _norm(pre), _norm(post))
    return ml
