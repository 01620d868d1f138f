"""Minimal VTK XML (.vtu) unstructured-grid writer (host numpy, ASCII XML).

Port of ``pyamg_tpu/vis/vtk_writer.py``: the same files, byte for byte.

Examples
--------
>>> import os, tempfile
>>> import numpy as np
>>> from pyamg_tpu_torch.vis.vtk_writer import write_basic_mesh
>>> V = np.array([[0., 0.], [1., 0.], [0., 1.]])
>>> E2V = np.array([[0, 1, 2]])
>>> fname = os.path.join(tempfile.mkdtemp(), 'tri.vtu')
>>> write_basic_mesh(V, E2V, mesh_type='tri', fname=fname)
>>> bool(os.path.getsize(fname) > 0)
True
"""

from __future__ import annotations

import numpy as np

__all__ = ["write_vtu", "write_basic_mesh"]

# VTK cell type ids -> points per cell
_VTK_CELL_SIZES = {
    1: 1,    # vertex
    3: 2,    # line
    5: 3,    # triangle
    9: 4,    # quad
    10: 4,   # tetrahedron
    12: 8,   # hexahedron
}


def _ascii(arr, fmt="%g"):
    arr = np.asarray(arr)
    return "\n".join(" ".join(fmt % v for v in row)
                     for row in np.atleast_2d(arr))


def write_vtu(V, cells, pdata=None, pvdata=None, cdata=None, cvdata=None,
              fname="output.vtu"):
    """Write an unstructured mesh + optional point/cell data to a .vtu file.

    Parameters
    ----------
    V : (n_points, dim) vertex coordinates (dim in {2, 3}).
    cells : dict {vtk_cell_type: (n_cells, pts_per_cell) index array}.
    pdata / cdata : optional scalar data arrays, one column per field,
        shape (n_points, k) / per-celltype list for cdata.
    pvdata / cvdata : optional vector data (n_points, 3*k).
    fname : output path or file-like object.
    """
    V = np.asarray(V, dtype=float)
    if V.ndim != 2:
        raise ValueError("V must be 2-D (n_points, dim)")
    n_pts, dim = V.shape
    if dim == 2:
        V = np.hstack([V, np.zeros((n_pts, 1))])
    elif dim != 3:
        raise ValueError("only 2D/3D coordinates supported")

    conn, offsets, types = [], [], []
    off = 0
    n_cells = 0
    for ctype, idx in cells.items():
        if ctype not in _VTK_CELL_SIZES:
            raise ValueError(f"unsupported VTK cell type {ctype}")
        idx = np.asarray(idx, dtype=np.int64)
        idx = idx.reshape(-1, _VTK_CELL_SIZES[ctype])
        for row in idx:
            conn.append(row)
            off += row.size
            offsets.append(off)
            types.append(ctype)
        n_cells += idx.shape[0]

    out = []
    out.append('<?xml version="1.0"?>')
    out.append('<VTKFile type="UnstructuredGrid" version="0.1" '
               'byte_order="LittleEndian">')
    out.append("  <UnstructuredGrid>")
    out.append(f'    <Piece NumberOfPoints="{n_pts}" '
               f'NumberOfCells="{n_cells}">')
    out.append("      <Points>")
    out.append('        <DataArray type="Float64" NumberOfComponents="3" '
               'format="ascii">')
    out.append(_ascii(V))
    out.append("        </DataArray>")
    out.append("      </Points>")
    out.append("      <Cells>")
    out.append('        <DataArray type="Int64" Name="connectivity" '
               'format="ascii">')
    out.append(_ascii(np.concatenate(conn)[None, :], "%d") if conn else "")
    out.append("        </DataArray>")
    out.append('        <DataArray type="Int64" Name="offsets" '
               'format="ascii">')
    out.append(_ascii(np.asarray(offsets)[None, :], "%d") if offsets else "")
    out.append("        </DataArray>")
    out.append('        <DataArray type="UInt8" Name="types" format="ascii">')
    out.append(_ascii(np.asarray(types)[None, :], "%d") if types else "")
    out.append("        </DataArray>")
    out.append("      </Cells>")

    if pdata is not None or pvdata is not None:
        out.append("      <PointData>")
        if pdata is not None:
            pdata = np.atleast_2d(np.asarray(pdata))
            if pdata.shape[0] == n_pts:
                pdata = pdata.T
            for k, col in enumerate(pdata):
                out.append(f'        <DataArray type="Float64" '
                           f'Name="pdata{k}" format="ascii">')
                out.append(_ascii(col[None, :]))
                out.append("        </DataArray>")
        if pvdata is not None:
            pvdata = np.asarray(pvdata).reshape(n_pts, -1)
            for k in range(pvdata.shape[1] // 3):
                out.append(f'        <DataArray type="Float64" '
                           f'Name="pvdata{k}" NumberOfComponents="3" '
                           f'format="ascii">')
                out.append(_ascii(pvdata[:, 3 * k:3 * k + 3]))
                out.append("        </DataArray>")
        out.append("      </PointData>")

    if cdata is not None or cvdata is not None:
        out.append("      <CellData>")
        if cdata is not None:
            cdata = np.atleast_2d(np.asarray(cdata))
            for k, col in enumerate(cdata):
                out.append(f'        <DataArray type="Float64" '
                           f'Name="cdata{k}" format="ascii">')
                out.append(_ascii(np.asarray(col).reshape(1, -1)))
                out.append("        </DataArray>")
        out.append("      </CellData>")

    out.append("    </Piece>")
    out.append("  </UnstructuredGrid>")
    out.append("</VTKFile>")

    text = "\n".join(out)
    if hasattr(fname, "write"):
        fname.write(text)
    else:
        with open(fname, "w") as fh:
            fh.write(text)


def write_basic_mesh(V, E2V=None, mesh_type="tri", pdata=None, pvdata=None,
                     cdata=None, cvdata=None, fname="output.vtu"):
    """Write a mesh of one element type (``"vertex"``, ``"line"``,
    ``"tri"``, ``"quad"``, ``"tet"``, ``"hex"``); without ``E2V``, every
    point as a vertex cell."""
    type_map = {"vertex": 1, "line": 3, "tri": 5, "quad": 9, "tet": 10,
                "hex": 12}
    if mesh_type not in type_map:
        raise ValueError(f"unknown mesh_type {mesh_type!r}")
    if E2V is None:
        E2V = np.arange(np.asarray(V).shape[0]).reshape(-1, 1)
        mesh_type = "vertex"
    cells = {type_map[mesh_type]: np.asarray(E2V)}
    write_vtu(V, cells, pdata=pdata, pvdata=pvdata, cdata=cdata,
              cvdata=cvdata, fname=fname)
