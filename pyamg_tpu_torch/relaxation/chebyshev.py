"""Polynomial smoother coefficients.

Port of ``chebyshev_polynomial_coefficients`` from
``pyamg_tpu/relaxation/chebyshev.py`` (numpy, unchanged).
"""

from __future__ import annotations

import numpy as np

__all__ = ["chebyshev_polynomial_coefficients"]


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
