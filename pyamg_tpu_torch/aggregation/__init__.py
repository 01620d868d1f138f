"""Smoothed aggregation setups: SA on structured grids (with the setup on
the host, or every numeric step on the device) and on general sparse
matrices, root-node SA, adaptive SA and its recursive form with
Ritz-filtered targets (``asa_solver``), and the 'new ideal' interpolation
solver, with the standard, Lloyd and pairwise aggregations."""

from . import matching
from .adaptive import adaptive_sa_solver
from .aggregation import smoothed_aggregation_solver
from .new_adaptive import asa_solver, tl_sa_solver
from .rootnode_nii import ben_ideal_interpolation, newideal_solver
from .device_setup import structured_sa_setup
from .aggregate import (grid_aggregation, fit_aggop, standard_aggregation,
                        naive_aggregation, parallel_aggregation,
                        lloyd_aggregation, pairwise_aggregation)
from .rootnode import rootnode_solver
from .smooth import (energy_prolongation_smoother,
                     jacobi_prolongation_smoother,
                     richardson_prolongation_smoother)
from .tentative import fit_candidates

__all__ = ["smoothed_aggregation_solver", "rootnode_solver",
           "adaptive_sa_solver", "grid_aggregation", "fit_aggop",
           "standard_aggregation", "naive_aggregation",
           "parallel_aggregation", "lloyd_aggregation",
           "pairwise_aggregation", "matching", "jacobi_prolongation_smoother",
           "richardson_prolongation_smoother",
           "energy_prolongation_smoother", "fit_candidates",
           "structured_sa_setup", "asa_solver", "tl_sa_solver",
           "newideal_solver", "ben_ideal_interpolation"]
