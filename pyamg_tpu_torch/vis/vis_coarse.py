"""Visualization of aggregates and C/F splittings as .vtu files.

Port of ``pyamg_tpu/vis/vis_coarse.py``: the same files, byte for byte.

Examples
--------
>>> import os, tempfile
>>> import numpy as np
>>> from pyamg_tpu_torch.vis import vis_splitting
>>> V = np.array([[0., 0.], [1., 0.], [0., 1.], [1., 1.]])
>>> fname = os.path.join(tempfile.mkdtemp(), 'split.vtu')
>>> vis_splitting(V, np.array([1, 0, 0, 1]), fname=fname)
>>> bool(os.path.getsize(fname) > 0)
True
"""

from __future__ import annotations

import numpy as np

from .vtk_writer import write_basic_mesh

__all__ = ["vis_aggregate_groups", "vis_splitting"]


def vis_aggregate_groups(V, E2V, AggOp, mesh_type="tri",
                         fname="output.vtu"):
    """Color mesh elements by the aggregate of their first vertex and write
    a .vtu for inspection."""
    import scipy.sparse as sp

    V = np.asarray(V)
    E2V = np.asarray(E2V, dtype=np.int64)
    AggOp = sp.csr_matrix(AggOp)
    labels = np.full(AggOp.shape[0], -1, dtype=np.int64)
    coo = AggOp.tocoo()
    labels[coo.row] = coo.col
    cell_color = labels[E2V[:, 0]].astype(float)
    write_basic_mesh(V, E2V, mesh_type=mesh_type, cdata=cell_color[None, :],
                     fname=fname)


def vis_splitting(V, splitting, fname="output.vtu"):
    """Write the C/F splitting as point data (1 = C, 0 = F)."""
    V = np.asarray(V)
    splitting = np.asarray(splitting, dtype=float).ravel()
    if splitting.size % V.shape[0]:
        raise ValueError("splitting length must be a multiple of n_points")
    k = splitting.size // V.shape[0]
    pdata = splitting.reshape(k, V.shape[0]).T
    write_basic_mesh(V, mesh_type="vertex", pdata=pdata, fname=fname)
