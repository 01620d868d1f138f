"""Polynomial smoother coefficients.

Port of ``chebyshev_polynomial_coefficients`` and
``mls_polynomial_coefficients`` from ``pyamg_tpu/relaxation/chebyshev.py``
(numpy, unchanged).
"""

from __future__ import annotations

import numpy as np

__all__ = ["chebyshev_polynomial_coefficients",
           "mls_polynomial_coefficients"]


def chebyshev_polynomial_coefficients(a, b, degree):
    """Coefficients (descending) of the degree-``degree`` Chebyshev
    polynomial on [a, b] normalized so C(0) = 1.

    Examples
    --------
    >>> np.round(chebyshev_polynomial_coefficients(1.0, 2.0, 3), 8)
    array([-0.32323232,  1.45454545, -2.12121212,  1.        ])
    """
    if a >= b or a <= 0:
        raise ValueError(f"invalid interval [{a},{b}]")
    # roots of T_degree mapped from [-1,1] to [a,b]
    std_roots = np.cos(np.pi * (np.arange(degree) + 0.5) / degree)
    roots = 0.5 * (b - a) * (1 + std_roots) + a
    poly = np.poly(roots)
    poly /= np.polyval(poly, 0)
    return poly


def mls_polynomial_coefficients(rho, degree):
    """MLS (multilevel smoother) polynomial coefficients after Adams,
    Brezina, Hu and Tuminaro (J. Comp. Phys. 188, 2003).

    Returns (coefficients, descending, of the smoother; roots of the
    prolongation smoother polynomial).

    Examples
    --------
    >>> coeffs, roots = mls_polynomial_coefficients(2.0, 2)
    >>> coeffs.shape, roots.shape
    ((7,), (2,))
    """
    roots = rho / 2.0 * (
        1.0 - np.cos(2 * np.pi * (np.arange(degree, dtype=float) + 1)
                     / (2.0 * degree + 1.0)))
    roots = 1.0 / roots
    S = np.poly(roots)[::-1]                   # error propagator S
    SSA_max = rho / ((2.0 * degree + 1.0) ** 2)
    S_hat = np.polymul(S, S)
    S_hat = np.hstack(((-1.0 / SSA_max) * S_hat, [1]))
    coeffs = np.polymul(S_hat, S)
    coeffs = -coeffs[:-1]
    return coeffs, roots
