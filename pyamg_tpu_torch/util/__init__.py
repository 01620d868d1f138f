"""Host setup utilities, linear algebra and hierarchy conversion."""

from . import bsr_utils, linalg, utils
from .linalg import (approximate_spectral_radius, cond, condest,
                     infinity_norm, ishermitian, norm, pinv_array,
                     residual_norm)
from .utils import coord2rbm, get_block_diag, get_diagonal, unpack_arg

__all__ = ["linalg", "utils", "bsr_utils", "approximate_spectral_radius",
           "condest", "cond", "ishermitian", "infinity_norm", "norm",
           "pinv_array", "residual_norm", "unpack_arg", "get_diagonal",
           "get_block_diag", "coord2rbm"]
