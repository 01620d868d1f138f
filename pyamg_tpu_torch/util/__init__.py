"""Host setup utilities, linear algebra, hierarchy conversion and
checkpoints."""

from . import bsr_utils, checkpoint, linalg, utils
from .checkpoint import load_hierarchy, save_hierarchy
from .linalg import (approximate_spectral_radius, cond, condest,
                     infinity_norm, ishermitian, norm, pinv_array,
                     residual_norm)
from .utils import coord2rbm, get_block_diag, get_diagonal, unpack_arg

__all__ = ["linalg", "utils", "bsr_utils", "checkpoint", "save_hierarchy",
           "load_hierarchy", "approximate_spectral_radius",
           "condest", "cond", "ishermitian", "infinity_norm", "norm",
           "pinv_array", "residual_norm", "unpack_arg", "get_diagonal",
           "get_block_diag", "coord2rbm"]
