"""Smoothers: host setup of their state, their steps on the device, and
the host relaxation methods of the setup phase (``relaxation``)."""

from . import relaxation
from .smoothing import (change_smoothers, make_smoother_data, rho_D_inv_A,
                        rho_block_D_inv_A)
from .device import SmootherData, apply_smoother

__all__ = ["change_smoothers", "make_smoother_data", "rho_D_inv_A",
           "rho_block_D_inv_A", "SmootherData", "apply_smoother",
           "relaxation"]
