"""Classical (Ruge-Stuben) AMG: C/F splittings, interpolation, compatible
relaxation and the solver constructor."""

from . import cr, split
from .classical import ruge_stuben_solver
from .cr import CR, binormalize
from .interpolate import direct_interpolation, standard_interpolation

__all__ = ["split", "cr", "ruge_stuben_solver", "direct_interpolation",
           "standard_interpolation", "CR", "binormalize"]
