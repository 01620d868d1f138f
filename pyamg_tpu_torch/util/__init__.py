"""Host setup utilities, linear algebra, hierarchy conversion, checkpoints
and profiling."""

from . import bsr_utils, checkpoint, linalg, profiling, utils
from .checkpoint import load_hierarchy, save_hierarchy
from .linalg import (approximate_spectral_radius, cond, condest,
                     infinity_norm, ishermitian, norm, pinv_array,
                     residual_norm)
from .profiling import hierarchy_spectrum, profile_cycles
from .utils import (coord2rbm, diag_sparse, get_block_diag, get_diagonal,
                    profile_solver, unpack_arg)

__all__ = ["linalg", "utils", "bsr_utils", "checkpoint", "profiling",
           "save_hierarchy", "load_hierarchy", "profile_cycles",
           "hierarchy_spectrum", "approximate_spectral_radius",
           "condest", "cond", "ishermitian", "infinity_norm", "norm",
           "pinv_array", "residual_norm", "unpack_arg", "diag_sparse",
           "get_diagonal", "get_block_diag", "coord2rbm", "profile_solver"]
