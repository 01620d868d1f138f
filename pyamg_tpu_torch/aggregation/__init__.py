"""Smoothed aggregation setup, on structured grids and on general
sparse matrices."""

from .aggregation import smoothed_aggregation_solver
from .aggregate import (grid_aggregation, fit_aggop, standard_aggregation,
                        naive_aggregation, parallel_aggregation)
from .smooth import (energy_prolongation_smoother,
                     jacobi_prolongation_smoother,
                     richardson_prolongation_smoother)
from .tentative import fit_candidates

__all__ = ["smoothed_aggregation_solver", "grid_aggregation", "fit_aggop",
           "standard_aggregation", "naive_aggregation",
           "parallel_aggregation", "jacobi_prolongation_smoother",
           "richardson_prolongation_smoother",
           "energy_prolongation_smoother", "fit_candidates"]
