"""Smoothed aggregation setup on structured grids."""

from .aggregation import smoothed_aggregation_solver
from .aggregate import grid_aggregation, fit_aggop
from .tentative import fit_candidates

__all__ = ["smoothed_aggregation_solver", "grid_aggregation", "fit_aggop",
           "fit_candidates"]
