"""Smoothers: host setup of their state and their steps on the device."""

from .smoothing import change_smoothers, make_smoother_data, rho_D_inv_A
from .device import SmootherData, apply_smoother

__all__ = ["change_smoothers", "make_smoother_data", "rho_D_inv_A",
           "SmootherData", "apply_smoother"]
