"""Small Q1 finite-element assembly helpers (host-side, numpy).

Port of ``pyamg_tpu/gallery/_fem.py`` (unchanged).

Used by the gallery to generate FE stencils by actual element assembly with
Gauss quadrature rather than transcribed closed forms.  This reproduces the
reference's sympy-derived FE stencils (pyamg/gallery/diffusion.py) to machine
precision while staying dimension-generic.
"""

from __future__ import annotations

import itertools

import numpy as np

_GAUSS_2 = (np.array([0.5 - 0.5 / np.sqrt(3.0), 0.5 + 0.5 / np.sqrt(3.0)]),
            np.array([0.5, 0.5]))


def q1_vertices(d: int) -> np.ndarray:
    """2**d unit-cube vertices, binary order with axis 0 most significant."""
    return np.array(list(itertools.product((0, 1), repeat=d)), dtype=float)


def q1_shape_grads(xi: np.ndarray, d: int) -> tuple[np.ndarray, np.ndarray]:
    """Values and gradients of the 2**d Q1 shape functions at point ``xi``.

    Returns (phi[(2**d,)], grad[(2**d, d)]) on the reference cube [0,1]^d.
    """
    verts = q1_vertices(d)
    nv = verts.shape[0]
    phi = np.ones(nv)
    grad = np.zeros((nv, d))
    for v in range(nv):
        factors = np.where(verts[v] == 1.0, xi, 1.0 - xi)
        phi[v] = np.prod(factors)
        for k in range(d):
            dfk = 1.0 if verts[v, k] == 1.0 else -1.0
            others = np.prod(np.delete(factors, k))
            grad[v, k] = dfk * others
    return phi, grad


def q1_diffusion_element(D: np.ndarray, spacing=None) -> np.ndarray:
    """Local Q1 stiffness for -div(D grad u) on a d-cube element.

    K[i, j] = ∫ (∇φ_i)ᵀ D ∇φ_j dx, with 2-point Gauss quadrature per axis.
    """
    D = np.asarray(D, dtype=float)
    d = D.shape[0]
    h = np.ones(d) if spacing is None else np.asarray(spacing, dtype=float)
    nv = 2**d
    K = np.zeros((nv, nv))
    pts, wts = _GAUSS_2
    detJ = float(np.prod(h))
    for q in itertools.product(range(2), repeat=d):
        xi = np.array([pts[qi] for qi in q])
        w = float(np.prod([wts[qi] for qi in q]))
        _, g = q1_shape_grads(xi, d)
        g = g / h[None, :]          # physical gradients
        K += w * detJ * (g @ D @ g.T)
    return K


def element_to_stencil(K: np.ndarray, d: int) -> np.ndarray:
    """Accumulate a Q1 local stiffness into the (3,)*d nodal stencil.

    On a uniform grid, the row of the assembled operator at an interior node
    sums contributions from the 2**d adjacent elements.
    """
    verts = q1_vertices(d).astype(int)
    S = np.zeros((3,) * d)
    for corner in itertools.product((-1, 0), repeat=d):
        c = np.array(corner)
        vi = int(np.sum((-c) * (2 ** np.arange(d - 1, -1, -1))))
        for j, vj in enumerate(verts):
            off = c + vj                    # in {-1,0,1}^d
            S[tuple(off + 1)] += K[vi, j]
    return S


def fd_diffusion_stencil(D: np.ndarray) -> np.ndarray:
    """Second-order FD stencil for -div(D grad u), constant coefficient.

    Axis-aligned second derivatives use the (-1, 2, -1) stencil; mixed
    derivatives use the 4-corner centered cross stencil.
    """
    D = np.asarray(D, dtype=float)
    d = D.shape[0]
    S = np.zeros((3,) * d)
    center = (1,) * d
    S[center] = 2.0 * np.trace(D)
    for k in range(d):
        for s in (-1, 1):
            idx = list(center)
            idx[k] += s
            S[tuple(idx)] += -D[k, k]
    for k in range(d):
        for l in range(k + 1, d):
            for sk in (-1, 1):
                for sl in (-1, 1):
                    idx = list(center)
                    idx[k] += sk
                    idx[l] += sl
                    S[tuple(idx)] += -2.0 * D[k, l] * sk * sl / 4.0
    return S
