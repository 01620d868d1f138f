"""Smoothed aggregation setups: SA on structured grids and on general
sparse matrices, root-node SA and adaptive SA."""

from .adaptive import adaptive_sa_solver
from .aggregation import smoothed_aggregation_solver
from .aggregate import (grid_aggregation, fit_aggop, standard_aggregation,
                        naive_aggregation, parallel_aggregation)
from .rootnode import rootnode_solver
from .smooth import (energy_prolongation_smoother,
                     jacobi_prolongation_smoother,
                     richardson_prolongation_smoother)
from .tentative import fit_candidates

__all__ = ["smoothed_aggregation_solver", "rootnode_solver",
           "adaptive_sa_solver", "grid_aggregation", "fit_aggop",
           "standard_aggregation", "naive_aggregation",
           "parallel_aggregation", "jacobi_prolongation_smoother",
           "richardson_prolongation_smoother",
           "energy_prolongation_smoother", "fit_candidates"]
