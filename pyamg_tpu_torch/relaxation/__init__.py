"""Smoothers: host setup of their state, their steps on the device, and
the host relaxation methods of the setup phase (``relaxation``)."""

from . import chebyshev, device, relaxation, smoothing
from .chebyshev import chebyshev_polynomial_coefficients
from .device import SmootherData, apply_smoother
from .relaxation import (block_gauss_seidel, block_jacobi, gauss_seidel,
                         gauss_seidel_indexed, gauss_seidel_ne,
                         gauss_seidel_nr, jacobi, jacobi_ne, make_system,
                         polynomial, sor)
from .smoothing import (change_smoothers, make_smoother_data, rho_D_inv_A,
                        rho_block_D_inv_A)

__all__ = ["relaxation", "device", "smoothing", "chebyshev",
           "gauss_seidel", "jacobi", "sor", "polynomial", "block_jacobi",
           "block_gauss_seidel", "gauss_seidel_indexed", "make_system",
           "jacobi_ne", "gauss_seidel_ne", "gauss_seidel_nr",
           "change_smoothers", "chebyshev_polynomial_coefficients",
           "make_smoother_data", "rho_D_inv_A", "rho_block_D_inv_A",
           "SmootherData", "apply_smoother"]
