"""Rotated anisotropic diffusion stencils in 2D and 3D.

Port of ``pyamg_tpu/gallery/diffusion.py`` (numpy, unchanged), itself after
pyamg/gallery/diffusion.py (``diffusion_stencil_2d``,
``diffusion_stencil_3d``).  Rather than transcribing the reference's
sympy-derived closed forms, the stencils here are produced by actual FD /
Q1-FE discretization of ``-div(D grad u)`` with the diffusion tensor D built
to the same rotation conventions — verified against the reference's published
example values in the tests.
"""

from __future__ import annotations

import numpy as np

from ._fem import element_to_stencil, fd_diffusion_stencil, q1_diffusion_element

__all__ = ["diffusion_stencil_2d", "diffusion_stencil_3d"]


def _tensor_2d(epsilon: float, theta: float) -> np.ndarray:
    """2x2 diffusion tensor in (axis0, axis1) = (y-like, x-like) grid order.

    Matches the reference convention where the operator is
    ``-(eps c² + s²) u_xx - 2(eps-1) c s u_xy - (c² + eps s²) u_yy`` with
    x along stencil axis 1 (diffusion.py:100-137).
    """
    C, S = np.cos(theta), np.sin(theta)
    Dxx = epsilon * C * C + S * S
    Dyy = epsilon * S * S + C * C
    Dxy = (epsilon - 1.0) * C * S
    # grid axis order (axis0, axis1) = (y, x); the reference's cross-term sign
    # corresponds to -Dxy in this ordering.
    return np.array([[Dyy, -Dxy], [-Dxy, Dxx]])


def diffusion_stencil_2d(epsilon=1.0, theta=0.0, type="FE"):
    """3x3 stencil for rotated anisotropic diffusion -div Q A Qᵀ grad u.

    Q is rotation by ``theta``; A = diag(1, epsilon).

    Examples
    --------
    >>> sten = diffusion_stencil_2d(epsilon=0.0001, theta=np.pi/6, type='FD')
    >>> np.round(sten, 4)
    array([[-0.2165, -0.75  ,  0.2165],
           [-0.2501,  2.0002, -0.2501],
           [ 0.2165, -0.75  , -0.2165]])
    """
    D = _tensor_2d(float(epsilon), float(theta))
    if type == "FD":
        return fd_diffusion_stencil(D)
    if type == "FE":
        K = q1_diffusion_element(D)
        return element_to_stencil(K, 2)
    raise ValueError(f"unknown discretization type {type!r}")


def _euler_q(theta: float, phi: float, psi: float) -> np.ndarray:
    """Euler-angle rotation Q = Rpsi · Rtheta · Rphi (reference convention,
    diffusion.py:188-227)."""
    cps, sps = np.cos(psi), np.sin(psi)
    cth, sth = np.cos(theta), np.sin(theta)
    cph, sph = np.cos(phi), np.sin(phi)
    Rpsi = np.array([[cps, sps, 0], [-sps, cps, 0], [0, 0, 1]])
    Rth = np.array([[1, 0, 0], [0, cth, sth], [0, -sth, cth]])
    Rphi = np.array([[cph, sph, 0], [-sph, cph, 0], [0, 0, 1]])
    return Rpsi @ Rth @ Rphi


def diffusion_stencil_3d(epsilony=1.0, epsilonz=1.0, theta=0.0, phi=0.0,
                         psi=0.0, type="FD"):
    """3x3x3 stencil for 3D rotated anisotropic diffusion.

    D = Q A Qᵀ with A = diag(1, epsilony, epsilonz) and Q from Euler angles.
    """
    Q = _euler_q(float(theta), float(phi), float(psi))
    A = np.diag([1.0, float(epsilony), float(epsilonz)])
    D = Q @ A @ Q.T
    if type == "FD":
        return fd_diffusion_stencil(D)
    if type == "FE":
        K = q1_diffusion_element(D)
        return element_to_stencil(K, 3)
    raise ValueError(f"unknown discretization type {type!r}")
