"""Simple structured meshes.  Port of ``pyamg_tpu/gallery/mesh.py`` (numpy,
unchanged)."""

from __future__ import annotations

import numpy as np

__all__ = ["regular_triangle_mesh"]


def regular_triangle_mesh(nx: int, ny: int):
    """Triangle mesh of the unit square with nx*ny vertices.

    Returns (vertices[(nx*ny, 2)], elements[(2*(nx-1)*(ny-1), 3)]).
    """
    nx, ny = int(nx), int(ny)
    if nx < 2 or ny < 2:
        raise ValueError("minimum mesh dimension is 2: %s" % ((nx, ny),))

    xs = np.linspace(0.0, 1.0, nx)
    ys = np.linspace(0.0, 1.0, ny)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    vertices = np.stack([X.reshape(-1), Y.reshape(-1)], axis=1)

    idx = np.arange(nx * ny).reshape(ny, nx)
    ll = idx[:-1, :-1].reshape(-1)      # lower-left corner of each quad
    lr = ll + 1
    ul = ll + nx
    ur = ul + 1
    lower = np.stack([ll, lr, ul], axis=1)
    upper = np.stack([lr, ur, ul], axis=1)
    elements = np.concatenate([lower, upper], axis=0).astype(np.int64)
    return vertices, elements
