"""Curated example problems.

Port of ``pyamg_tpu/gallery/example.py`` (numpy, unchanged), itself after
pyamg/gallery/example.py (``load_example``).  The reference
ships nine MATLAB ``.mat`` datasets (airfoil, bar, knot, unit_square,
unit_cube, recirc_flow, helmholtz_2D, local_disc_galerkin_diffusion).  Those
binary assets are not vendored here; ``load_example`` loads them from a data
directory if present (``PYAMG_TPU_EXAMPLE_DATA`` or ``data_dir=``), and a set
of *generated* equivalents covers the structurally similar cases so tests and
demos run self-contained.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["load_example", "EXAMPLE_NAMES"]

EXAMPLE_NAMES = [
    "airfoil", "bar", "knot", "unit_square", "unit_cube",
    "recirc_flow", "helmholtz_2D", "local_disc_galerkin_diffusion",
]

_GENERATED = {}


def _register(name):
    def deco(fn):
        _GENERATED[name] = fn
        return fn
    return deco


@_register("unit_square")
def _unit_square():
    from .mesh import regular_triangle_mesh
    from .elasticity import _p1_local  # noqa: F401  (mesh helpers nearby)
    import scipy.sparse as sp

    vertices, elements = regular_triangle_mesh(30, 30)
    # P1 Laplacian on the triangle mesh
    n = vertices.shape[0]
    rows, cols, vals = [], [], []
    for tri in elements:
        V = vertices[tri]
        T = (V[1:] - V[0]).T
        area = abs(np.linalg.det(T)) / 2.0
        Tinv = np.linalg.inv(T)
        g = np.zeros((3, 2))
        g[1:] = Tinv          # ∇φ_k = row k-1 of T^{-1}
        g[0] = -g[1:].sum(axis=0)
        Ke = area * (g @ g.T)
        rows.append(np.repeat(tri, 3))
        cols.append(np.tile(tri, 3))
        vals.append(Ke.ravel())
    A = sp.coo_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n)).tocsr()
    return {"A": A, "vertices": vertices, "elements": elements,
            "B": np.ones((n, 1))}


@_register("unit_cube")
def _unit_cube():
    from .laplacian import poisson

    A = poisson((12, 12, 12), format="csr")
    return {"A": A, "B": np.ones((A.shape[0], 1))}


@_register("helmholtz_2D")
def _helmholtz_2d():
    from .laplacian import poisson

    n = 40
    A = poisson((n, n), format="csr").astype(complex)
    h = 1.0 / (n + 1)
    # indefinite shift: -Laplacian/h^2 - k^2 I with ~8 points per wavelength
    k = 2 * np.pi / (8 * h)
    import scipy.sparse as sp

    A = A / h**2 - (k**2) * sp.eye(A.shape[0], dtype=complex, format="csr")
    return {"A": A.tocsr(), "B": np.ones((A.shape[0], 1), dtype=complex)}


@_register("knot")
def _knot():
    """Surface FEM Laplacian on a trefoil-knot tube mesh (reference
    gallery/example_data/knot.mat: 240 vertices, 480 triangles, A grounded
    to 239 unknowns).  The tube is a 40x6 quad grid on torus topology
    around the (2,3) trefoil curve, split into triangles; the P1 stiffness
    matrix is assembled from each triangle's 3D embedding and the last
    vertex is grounded so A is nonsingular."""
    import scipy.sparse as sp

    nu, nv = 40, 6                   # 240 vertices, 480 triangles
    t = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    # (2,3) trefoil centerline
    cx = np.stack([np.sin(t) + 2 * np.sin(2 * t),
                   np.cos(t) - 2 * np.cos(2 * t),
                   -np.sin(3 * t)], axis=1)
    # local frame along the curve (finite-difference tangent + normalized
    # normal/binormal via Gram-Schmidt against a fixed helper vector)
    tang = np.roll(cx, -1, axis=0) - np.roll(cx, 1, axis=0)
    tang /= np.linalg.norm(tang, axis=1, keepdims=True)
    helper = np.array([0.0, 0.0, 1.0])
    nrm = helper - (tang @ helper)[:, None] * tang
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    binrm = np.cross(tang, nrm)
    r = 0.5
    phi = np.linspace(0, 2 * np.pi, nv, endpoint=False)
    ring = (np.cos(phi)[:, None, None] * nrm[None] +
            np.sin(phi)[:, None, None] * binrm[None])   # (nv, nu, 3)
    vertices = (cx[None] + r * ring).transpose(1, 0, 2).reshape(-1, 3)

    def vid(i, j):
        return (i % nu) * nv + (j % nv)

    tris = []
    for i in range(nu):
        for j in range(nv):
            tris.append([vid(i, j), vid(i + 1, j), vid(i + 1, j + 1)])
            tris.append([vid(i, j), vid(i + 1, j + 1), vid(i, j + 1)])
    elements = np.asarray(tris, dtype=np.int32)

    # P1 stiffness on the embedded surface: per-triangle gradients from the
    # 3D edge geometry (standard flat-triangle FEM)
    rows, cols, vals = [], [], []
    for tri in elements:
        V = vertices[tri]
        e1, e2 = V[1] - V[0], V[2] - V[0]
        nvec = np.cross(e1, e2)
        area = 0.5 * np.linalg.norm(nvec)
        # gradients of the barycentric shape functions within the plane
        G = np.stack([np.cross(nvec, V[2] - V[1]),
                      np.cross(nvec, V[0] - V[2]),
                      np.cross(nvec, V[1] - V[0])]) / (2 * area *
                                                       np.linalg.norm(nvec))
        Ke = area * (G @ G.T)
        rows.append(np.repeat(tri, 3))
        cols.append(np.tile(tri, 3))
        vals.append(Ke.ravel())
    n = vertices.shape[0]
    A = sp.coo_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n)).tocsr()
    A = A[:-1, :][:, :-1].tocsr()    # ground one vertex (ref: 239 unknowns)
    return {"A": A, "vertices": vertices, "elements": elements,
            "B": np.ones((A.shape[0], 1))}


@_register("local_disc_galerkin_diffusion")
def _local_disc_galerkin_diffusion():
    """Symmetric interior-penalty DG (SIPG) Poisson on a small triangle
    mesh with degree-5 elements: 21 DoFs per triangle, block structure the
    reference dataset exposes (example_data/local_disc_galerkin_diffusion
    .mat: 46 elements x 21 nodes = 966 unknowns, elmt_blocksize 21)."""
    import scipy.sparse as sp
    from .mesh import regular_triangle_mesh

    deg = 5
    nloc = (deg + 1) * (deg + 2) // 2          # 21
    verts, tris = regular_triangle_mesh(7, 5)  # 48 triangles, 1008 DoFs
                                               # (ref: 46 x 21 = 966)

    # degree-5 Lagrange nodes on the reference triangle (barycentric lattice)
    ij = [(i, j) for i in range(deg + 1) for j in range(deg + 1 - i)]
    ref_nodes = np.array([(i / deg, j / deg) for i, j in ij])
    # monomial basis x^a y^b, |a+b| <= deg; coefficients via Vandermonde
    pows = [(a, b) for a in range(deg + 1) for b in range(deg + 1 - a)]

    def vand(pts):
        return np.stack([pts[:, 0] ** a * pts[:, 1] ** b
                         for a, b in pows], axis=1)

    Vinv = np.linalg.inv(vand(ref_nodes))      # (nmono, nloc) coeffs

    def basis_and_grad(pts):
        Vb = vand(pts)
        dx = np.stack([a * pts[:, 0] ** max(a - 1, 0) * pts[:, 1] ** b
                       for a, b in pows], axis=1)
        dy = np.stack([b * pts[:, 0] ** a * pts[:, 1] ** max(b - 1, 0)
                       for a, b in pows], axis=1)
        return Vb @ Vinv, dx @ Vinv, dy @ Vinv   # (npts, nloc) each

    # triangle quadrature of degree ~2*deg via a Duffy-mapped Gauss rule
    gl, gw = np.polynomial.legendre.leggauss(deg + 2)
    gl = 0.5 * (gl + 1.0)
    gw = 0.5 * gw
    qx = np.array([[u, v * (1 - u)] for u in gl for v in gl])
    qw = np.array([wu * wv * (1 - u)
                   for u, wu in zip(gl, gw) for v, wv in zip(gl, gw)])
    phi_q, dxi_q, deta_q = basis_and_grad(qx)

    # 1D Gauss rule on edges
    el, ew = np.polynomial.legendre.leggauss(deg + 2)
    el = 0.5 * (el + 1.0)
    ew = 0.5 * ew
    ref_edges = {  # edge -> parametrized points in reference coords
        0: lambda s: np.stack([s, np.zeros_like(s)], axis=1),
        1: lambda s: np.stack([1 - s, s], axis=1),
        2: lambda s: np.stack([np.zeros_like(s), 1 - s], axis=1),
    }

    ne = tris.shape[0]
    n = ne * nloc
    blocks = {}

    def add(ei, ej, M):
        key = (ei, ej)
        blocks[key] = blocks.get(key, 0) + M

    # geometry per element
    T_aff, Tinv_aff, detJ, v0s = [], [], [], []
    for tri in tris:
        V = verts[tri]
        T = (V[1:] - V[0]).T                 # 2x2 Jacobian
        T_aff.append(T)
        Tinv_aff.append(np.linalg.inv(T))
        detJ.append(abs(np.linalg.det(T)))
        v0s.append(V[0])

    # volume terms
    for e in range(ne):
        Ti = Tinv_aff[e]
        gx = dxi_q * Ti[0, 0] + deta_q * Ti[1, 0]
        gy = dxi_q * Ti[0, 1] + deta_q * Ti[1, 1]
        Ke = detJ[e] * ((gx * qw[:, None]).T @ gx + (gy * qw[:, None]).T @ gy)
        add(e, e, Ke)

    # face terms: build edge -> (elements, local edge ids) map
    edge_map = {}
    for e, tri in enumerate(tris):
        for le, (a, b) in enumerate(((tri[0], tri[1]), (tri[1], tri[2]),
                                     (tri[2], tri[0]))):
            edge_map.setdefault((min(a, b), max(a, b)), []).append((e, le))

    sigma = 10.0 * deg * deg

    def edge_eval(e, le, s):
        """basis values/normal-gradients at physical points of edge le of
        element e, parametrized by s in [0,1] along the global edge
        direction (ascending vertex id, so both sides align)."""
        tri = tris[e]
        pairs = ((tri[0], tri[1]), (tri[1], tri[2]), (tri[2], tri[0]))
        a, b = pairs[le]
        sp_ = s if a < b else 1 - s
        ref_pts = ref_edges[le](sp_)
        phi, dxi, deta = basis_and_grad(ref_pts)
        Ti = Tinv_aff[e]
        gx = dxi * Ti[0, 0] + deta * Ti[1, 0]
        gy = dxi * Ti[0, 1] + deta * Ti[1, 1]
        va, vb = verts[min(a, b)], verts[max(a, b)]
        tangent = vb - va
        length = np.linalg.norm(tangent)
        nvec = np.array([tangent[1], -tangent[0]]) / length
        # orient outward from element e: against the centroid
        cen = verts[tri].mean(axis=0)
        mid = 0.5 * (va + vb)
        if np.dot(nvec, mid - cen) < 0:
            nvec = -nvec
        gn = gx * nvec[0] + gy * nvec[1]
        return phi, gn, length

    for edge, owners in edge_map.items():
        if len(owners) == 2:
            (e1, le1), (e2, le2) = owners
            p1, g1, L = edge_eval(e1, le1, el)
            p2, g2, _ = edge_eval(e2, le2, el)
            w = ew * L
            pen = sigma / L
            # SIPG: -{dn u}[v] - {dn v}[u] + pen [u][v].  With each side's
            # gn taken w.r.t. its own outward normal, [u] = sum_s s_s u_s
            # and {dn u} = 0.5 sum_s s_s gn_s (signs s = +1/-1 per side).
            sides = ((e1, p1, g1, 1.0), (e2, p2, g2, -1.0))
            for (er, pr, gr, sr) in sides:          # test (rows)
                for (ec, pc, gc, sc) in sides:      # trial (cols)
                    M = sr * sc * (
                        -0.5 * ((pr * w[:, None]).T @ gc
                                + (gr * w[:, None]).T @ pc)
                        + pen * (pr * w[:, None]).T @ pc)
                    add(er, ec, M)
        else:
            (e1, le1), = owners
            p1, g1, L = edge_eval(e1, le1, el)
            w = ew * L
            pen = sigma / L
            M = (-(p1 * w[:, None]).T @ g1 - (g1 * w[:, None]).T @ p1
                 + pen * (p1 * w[:, None]).T @ p1)
            add(e1, e1, M)

    rows, cols, vals = [], [], []
    for (ei, ej), M in blocks.items():
        r = ei * nloc + np.arange(nloc)
        c = ej * nloc + np.arange(nloc)
        rows.append(np.repeat(r, nloc))
        cols.append(np.tile(c, nloc))
        vals.append(np.asarray(M).ravel())
    A = sp.coo_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n)).tocsr()

    # per-DoF coordinates (the reference ships 'vertices' per DG dof)
    coords = np.concatenate([(v0s[e][None] + ref_nodes @ T_aff[e].T)
                             for e in range(ne)])
    return {"A": A, "B": np.ones((n, 1)), "vertices": coords,
            "elements": np.arange(n).reshape(ne, nloc),
            "elmt_blocksize": nloc, "p": deg}


@_register("recirc_flow")
def _recirc_flow():
    """Nonsymmetric convection-diffusion with recirculating wind field."""
    import scipy.sparse as sp

    n = 40
    h = 1.0 / (n + 1)
    xs = (np.arange(n) + 1) * h
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    # wind (b1, b2) = (y - 1/2, 1/2 - x): rotation about the center
    b1 = (Y - 0.5).reshape(-1)
    b2 = (0.5 - X).reshape(-1)
    eps = 1e-2

    N = n * n
    idx = np.arange(N)
    ix, iy = idx // n, idx % n
    rows, cols, vals = [idx], [idx], [np.full(N, 4.0 * eps / h**2)]

    def add(mask, shift, v):
        r = idx[mask]
        rows.append(r)
        cols.append(r + shift)
        vals.append(v[mask] if np.ndim(v) else np.full(r.size, v))

    # diffusion -eps Δ + upwinded convection b·∇
    add(ix + 1 < n, n, -eps / h**2 + np.minimum(b1, 0) / h)
    add(ix - 1 >= 0, -n, -eps / h**2 - np.maximum(b1, 0) / h)
    add(iy + 1 < n, 1, -eps / h**2 + np.minimum(b2, 0) / h)
    add(iy - 1 >= 0, -1, -eps / h**2 - np.maximum(b2, 0) / h)
    # upwind scheme adds |b|/h to the diagonal
    diag_extra = (np.abs(b1) + np.abs(b2)) / h
    rows.append(idx)
    cols.append(idx)
    vals.append(diag_extra)

    A = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(N, N)).tocsr()
    return {"A": A, "B": np.ones((N, 1))}


@_register("bar")
def _bar():
    from .elasticity import linear_elasticity

    A, B = linear_elasticity((40, 10))
    return {"A": A.tocsr(), "B": B}


@_register("airfoil")
def _airfoil():
    """Unstructured-mesh stand-in: P1 Laplacian on a Delaunay triangulation
    of an annulus (a hole in the domain, like a wing section)."""
    import scipy.sparse as sp
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(7)
    # annulus point cloud: inner boundary ring + outer ring + interior
    t = np.linspace(0, 2 * np.pi, 48, endpoint=False)
    inner = 0.3 * np.stack([np.cos(t), 0.4 * np.sin(t)], axis=1)
    outer = 1.5 * np.stack([np.cos(t), np.sin(t)], axis=1)
    pts = rng.uniform(-1.5, 1.5, size=(900, 2))
    r = np.sqrt(pts[:, 0] ** 2 + (pts[:, 1] / 0.4) ** 2)
    keep = (r > 0.34) & (np.linalg.norm(pts, axis=1) < 1.45)
    vertices = np.concatenate([inner, outer, pts[keep]], axis=0)
    tri = Delaunay(vertices)
    # drop triangles inside the hole (centroid test)
    cent = vertices[tri.simplices].mean(axis=1)
    rc = np.sqrt(cent[:, 0] ** 2 + (cent[:, 1] / 0.4) ** 2)
    elements = tri.simplices[rc > 0.3]

    n = vertices.shape[0]
    rows, cols, vals = [], [], []
    for trie in elements:
        V = vertices[trie]
        T = (V[1:] - V[0]).T
        det = np.linalg.det(T)
        if abs(det) < 1e-12:
            continue
        area = abs(det) / 2.0
        g = np.zeros((3, 2))
        g[1:] = np.linalg.inv(T)
        g[0] = -g[1:].sum(axis=0)
        Ke = area * (g @ g.T)
        rows.append(np.repeat(trie, 3))
        cols.append(np.tile(trie, 3))
        vals.append(Ke.ravel())
    A = sp.coo_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n)).tocsr()
    A = A + 1e-8 * sp.eye(n, format="csr")   # remove the constant nullspace
    return {"A": A, "vertices": vertices, "elements": elements,
            "B": np.ones((n, 1))}


def load_example(name, data_dir=None):
    """Load one of the curated example problems as a dict with key 'A' (and
    typically 'B', 'vertices', 'elements' where applicable).

    Looks for ``<name>.mat`` in ``data_dir`` (or $PYAMG_TPU_EXAMPLE_DATA),
    else falls back to the generated equivalent if one exists.
    """
    if name not in EXAMPLE_NAMES and name not in _GENERATED:
        raise ValueError(
            f"unknown example {name!r}; known: {sorted(set(EXAMPLE_NAMES) | set(_GENERATED))}")

    search = []
    if data_dir:
        search.append(data_dir)
    env = os.environ.get("PYAMG_TPU_EXAMPLE_DATA")
    if env:
        search.append(env)
    search.append(os.path.join(os.path.dirname(__file__), "example_data"))

    for d in search:
        path = os.path.join(d, name + ".mat")
        if os.path.isfile(path):
            from scipy.io import loadmat

            data = loadmat(path, struct_as_record=True)
            return {k: v for k, v in data.items() if not k.startswith("__")}

    if name in _GENERATED:
        return _GENERATED[name]()

    raise FileNotFoundError(
        f"no .mat data found for example {name!r} (searched {search}) and no "
        f"generated equivalent is available")
